"""Training step: causal-LM loss, gradients, AdamW update.

The counterpart of ``repro._unused.train.train_step`` on one device. The
step takes the :class:`~repro_torch._unused.models.lm.LM` module, whose
parameters the trainer has switched to ``requires_grad=True`` once
(:class:`~repro_torch.launch.train.TrainLoop` does so where it builds them),
the optimizer state and a batch of ``tokens`` and ``labels`` (and
``frames`` or ``patch_embeds`` as the card needs). It casts the float32
masters of rank ≥ 2 to the compute dtype as the reference does (a view of
the module whose leaves are the casts, so the gradient flows back to the
masters), takes the loss's gradient with ``torch.autograd.grad`` (the model
recomputes each layer in the backward, and the flash kernel's backward is
the plain streaming softmax's), optionally round-trips it through int8
compression, and updates the parameters and moments in place.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch._unused.models import lm
from .optimizer import AdamWConfig, OptState, adamw_update

__all__ = ["loss_fn", "cast_params_for_compute", "make_train_step"]


def loss_fn(params, batch: dict, cfg: ModelConfig) -> torch.Tensor:
    """Next-token cross-entropy over the (padded) vocab, mean over tokens
    (over ``loss_mask`` where the batch has one)."""
    logits = lm.apply_train(params, batch, cfg)  # (B,S,Vp) f32
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, batch["labels"][..., None].long())[..., 0]
    nll = lse - ll
    mask = batch.get("loss_mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(mask.sum(), min=1.0)
    else:
        denom = float(nll.numel())
    return nll.sum() / denom


def _cast_view(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    view = copy.copy(module)
    view._parameters = {
        k: (p.to(dtype) if p is not None and p.dtype == torch.float32 and p.dim() >= 2 else p)
        for k, p in module._parameters.items()}
    view._modules = {k: None if m is None else _cast_view(m, dtype)
                     for k, m in module._modules.items()}
    return view


def cast_params_for_compute(params: nn.Module, cfg: ModelConfig) -> nn.Module:
    """Mixed precision: a view of ``params`` whose float32 leaves of rank
    ≥ 2 are cast to the compute dtype (differentiable casts: gradients flow
    back to the float32 masters); ``params`` itself when the compute dtype is
    float32."""
    cd = getattr(torch, cfg.compute_dtype)
    return params if cd == torch.float32 else _cast_view(params, cd)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, *, compress_grads: bool = False):
    """The train step (params, opt_state, batch) → (params, opt_state,
    metrics); params and moments are updated in place. ``metrics``: ``loss``,
    ``grad_norm`` and ``lr``, as tensors."""

    def step(params: nn.Module, opt_state: OptState, batch: dict):
        leaves = dict(params.named_parameters())
        with torch.enable_grad():
            pc = cast_params_for_compute(params, cfg)
            loss = loss_fn(pc, batch, cfg)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        del pc  # the compute-dtype casts, before the update's temporaries
        if compress_grads:
            from .compression import compress_decompress_tree

            grads = compress_decompress_tree(grads)
        _, new_opt, metrics = adamw_update(leaves, grads, opt_state, opt_cfg)
        return params, new_opt, dict(metrics, loss=loss.detach())

    return step
