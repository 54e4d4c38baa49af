"""Mixture-of-Experts FFN with sort-based dispatch (the dense path).

The counterpart of ``repro._unused.models.moe`` (``moe_capacity``,
``moe_init``, and ``moe_apply`` as ``_moe_apply_dense`` with
``_add_shared``). Routing groups are the batch rows, computed in float32:

  1. softmax over the experts, top-k per token (ties: the lower expert id
     first, as ``jax.lax.top_k``), renormalized when ``renorm_topk``;
  2. the S·k (expert, token, gate) entries of a row sorted by expert, stably;
  3. rank within the expert = position − the expert's first position;
     entries at rank ≥ capacity C go to the overflow slot E·C and are
     dropped, so they contribute 0;
  4. tokens scattered into a (B, E, C, d) buffer → the batched expert
     SwiGLU → gathered back, weighted by their gate and added to their
     token's row.

The expert products are ``torch.einsum`` over the expert axis (batched
GEMMs); the reference computes them outside any Pallas kernel too. The
expert-parallel path (``_moe_apply_ep``) needs the LM's mesh and waits for
it (ROADMAP A.6.7): ``moe_apply`` needs no mesh. ``dropped`` counts the
entries that ``moe_apply`` drops by capacity on the same input.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from .layers import FFN, Dense, cdtype, dense_init, pdtype

__all__ = ["MoE", "moe_init", "moe_apply", "moe_capacity", "dropped"]


def moe_capacity(cfg: ModelConfig, seq_len: int) -> int:
    """Static per-expert capacity for one routing group (= one sequence):
    ``min(max(ceil(cf·S·k/E), k), S)``, 1 at S = 1."""
    c = int(math.ceil(cfg.capacity_factor * seq_len * cfg.top_k / cfg.n_experts))
    return min(max(c, cfg.top_k), seq_len)


class MoE(nn.Module):
    """``router.w`` (d, E) float32, ``wi``/``wg`` (E, d, f) and ``wo``
    (E, f, d) in ``param_dtype``, and ``shared`` (an FFN with ``wi``, ``wg``
    and ``wo`` of width ``n_shared_experts · f``) when there are shared
    experts."""

    def __init__(self, router: Dense, wi: nn.Parameter, wg: nn.Parameter, wo: nn.Parameter,
                 shared: FFN | None = None):
        super().__init__()
        self.router, self.wi, self.wg, self.wo, self.shared = router, wi, wg, wo, shared


def moe_init(cfg: ModelConfig, *, gen=None, device=None) -> MoE:
    """Random experts: N(0, 1/d) for the router, ``wi`` and ``wg``, N(0, 1/f)
    for ``wo``, drawn from ``gen`` on ``device`` (shapes only on ``meta``)."""
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def normal(shape, dtype, std):
        t = torch.empty(shape, dtype=dtype, device=device)
        if t.device.type != "meta":
            t.normal_(generator=gen).mul_(std)
        return nn.Parameter(t, requires_grad=False)

    scale = 1.0 / math.sqrt(d)
    router = Dense(normal((d, E), torch.float32, scale))
    wi = normal((E, d, f), pdtype(cfg), scale)
    wg = normal((E, d, f), pdtype(cfg), scale)
    wo = normal((E, f, d), pdtype(cfg), 1.0 / math.sqrt(f))
    shared = None
    if cfg.n_shared_experts:
        fs = cfg.n_shared_experts * f
        kw = dict(gen=gen, device=device)
        shared = FFN(dense_init(d, (fs,), cfg, **kw), dense_init(fs, (d,), cfg, **kw),
                     dense_init(d, (fs,), cfg, **kw))
    return MoE(router, wi, wg, wo, shared)


def _route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """(gate (B,S,k) f32, ids (B,S,k) int64): softmax in float32, then the k
    largest with the lower expert id first on ties, renormalized."""
    logits = x.float() @ p.router.w.float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in expert order
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[..., : cfg.top_k], ids[..., : cfg.top_k]
    if cfg.renorm_topk:
        gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    return gate, ids


def _slots(ids: torch.Tensor, C: int, E: int):
    """The S·k entries of each row sorted by expert, stably: (order, slot,
    keep). ``slot`` is expert·C + rank within the expert (rank = position −
    the expert's first position); entries at rank ≥ C get the overflow slot
    E·C and ``keep`` False."""
    B, n = ids.shape
    dev = ids.device
    order = torch.argsort(ids, dim=-1, stable=True)
    ids_s = ids.gather(1, order)
    starts = torch.searchsorted(ids_s, torch.arange(E, device=dev).expand(B, E).contiguous())
    rank = torch.arange(n, device=dev) - starts.gather(1, ids_s)
    keep = rank < C
    return order, torch.where(keep, ids_s * C + rank, E * C), keep


def dropped(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The entries that ``moe_apply(p, x, cfg)`` drops by capacity, summed
    over the rows (an int64 scalar on x's device)."""
    B, S, _ = x.shape
    _, ids = _route(p, x, cfg)
    _, _, keep = _slots(ids.reshape(B, S * cfg.top_k), moe_capacity(cfg, S), cfg.n_experts)
    return (~keep).sum()


def moe_apply(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x (B, S, d) → (B, S, d) in x's dtype."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, S)
    dtype = cdtype(cfg)
    dev = x.device

    gate, ids = _route(p, x, cfg)
    # ---- sort the S·k entries of each row by expert; dropped → the overflow slot ----
    order, dest, _ = _slots(ids.reshape(B, S * k), C, E)
    tok_s = torch.arange(S, device=dev).repeat_interleave(k).expand(B, S * k).gather(1, order)
    gate_s = gate.reshape(B, S * k).gather(1, order)

    # ---- dispatch: scatter tokens into (B, E·C + 1, d) ------------------------------
    rows = torch.arange(B, device=dev)[:, None]
    xt = x[rows, tok_s]  # (B, S·k, d)
    buf = torch.zeros((B, E * C + 1, d), dtype=dtype, device=dev)
    buf[rows, dest] = xt.to(dtype)
    buf = buf[:, : E * C].reshape(B, E, C, d)

    # ---- the experts (SwiGLU), batched over the expert axis -------------------------
    wi, wg, wo = (w.to(dtype) for w in (p.wi, p.wg, p.wo))
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) * torch.einsum("becd,edf->becf", buf, wi)
    y = torch.einsum("becf,efd->becd", h, wo)

    # ---- combine: gather back, weight by gate, add to the token rows ---------------
    y_flat = torch.cat([y.reshape(B, E * C, d), y.new_zeros((B, 1, d))], dim=1)
    out_e = y_flat[rows, dest] * gate_s[..., None].to(dtype)  # dropped → 0
    out = torch.zeros((B, S, d), dtype=dtype, device=dev)
    out.index_put_((rows.expand(B, S * k), tok_s), out_e, accumulate=True)
    return _add_shared(p, x, out, cfg).to(x.dtype)


def _add_shared(p: MoE, x: torch.Tensor, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Shared experts as a dense SwiGLU on every token, in the promoted dtype
    of x and the compute dtype (the reference's einsum promotion)."""
    if p.shared is None:
        return out
    dtype = torch.promote_types(x.dtype, cdtype(cfg))
    sh = p.shared
    xs = x.to(dtype)
    h = F.silu(xs @ sh.wg.w.to(dtype)) * (xs @ sh.wi.w.to(dtype))
    return out + h @ sh.wo.w.to(dtype)
