"""Serving: batched greedy single-token decode steps and the prefill.

The counterpart of ``repro._unused.serve.serve_step``. The decode step
runs one new token against the cache: a KV cache (ring-buffered to the
window for sliding-window models), MLA's latent cache, or the O(1) state
of Mamba and RWKV; an enc-dec card's cache also holds the cross K/V that
``lm.prefill_cross`` filled. From ``s_max >= CTX_PARALLEL_THRESHOLD`` the
step decodes context-parallel, as the reference's does: under a rule
context (``sharding.rules.axis_rules`` over a mesh of device lists, one
process) a cache made by ``lm.init_cache(..., ctx_parallel=True)`` lives
as sequence tiles on the ``model`` devices and each step combines the
tiles' softmax partials; without rules the step is the same arithmetic on
one cache. The prefill is the full-sequence forward under
``torch.no_grad``, where the flash kernel runs on the card in GQA layers
(and in an enc-dec card's encoder and cross-attention); MLA runs the
streaming softmax and Mamba and RWKV their chunked scans. Its batch holds
``tokens`` and, as the card needs, ``frames`` (enc-dec) or
``patch_embeds`` (the VLM stub).

Under a rule context whose ``model`` axis has more than one position, both
steps take the serving layout (``lm.place_params``) and the logits stay
split over the vocab: :func:`vocab_argmax` takes each position's (max,
first index) and keeps the largest max, the lowest index on a tie, which is
``torch.argmax``'s answer on the joined logits.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch._unused.models import lm

__all__ = ["CTX_PARALLEL_THRESHOLD", "make_decode_step", "make_prefill_step",
           "greedy_generate", "vocab_argmax"]

#: shard the cache's sequence axis over the ``model`` mesh axis from this
#: length up (context-parallel decode), as the reference does
CTX_PARALLEL_THRESHOLD = 1 << 15  # 32768


def vocab_argmax(shards: list[torch.Tensor]) -> torch.Tensor:
    """``argmax`` over the last axis of logits split into column blocks (in
    vocab order, each on its own device) → int32 on the first block's
    device: each block's (max, first index), then the largest max, the
    earliest block on a tie."""
    if len(shards) == 1:
        return torch.argmax(shards[0], dim=-1).to(torch.int32)
    dev = shards[0].device
    best = idx = None
    offset = 0
    for s in shards:
        v, i = torch.max(s, dim=-1)
        v, i = v.to(dev), i.to(dev) + offset
        if best is None:
            best, idx = v, i
        else:
            take = v > best
            best, idx = torch.where(take, v, best), torch.where(take, i, idx)
        offset += s.shape[-1]
    return idx.to(torch.int32)


def make_decode_step(cfg: ModelConfig, s_max: int):
    """The greedy decode step (params, tokens (B, 1), cache, cache_len) →
    (next tokens (B,) int32, cache); ``step.ctx_parallel`` says whether it
    decodes context-parallel (``s_max >= CTX_PARALLEL_THRESHOLD``)."""
    ctx_parallel = s_max >= CTX_PARALLEL_THRESHOLD

    def step(params, tokens: torch.Tensor, cache, cache_len: int):
        shards, new_cache = lm.apply_decode(params, tokens, cache, cache_len, cfg,
                                            ctx_parallel=ctx_parallel, vocab_shards=True)
        return vocab_argmax([s[:, -1] for s in shards]), new_cache

    step.ctx_parallel = ctx_parallel
    return step


def make_prefill_step(cfg: ModelConfig):
    """Full-sequence forward producing the last position's greedy token."""

    @torch.no_grad()
    def step(params, batch: dict):
        shards = lm.apply_train(params, batch, cfg, vocab_shards=True)
        return vocab_argmax([s[:, -1] for s in shards])

    return step


def greedy_generate(params, cfg: ModelConfig, prompt: torch.Tensor, n_new: int, s_max: int = 0):
    """Simple greedy loop. prompt: (B, S0) int → (B, n_new) int32 on its device.

    The prompt is fed token by token through the decode step, as the
    reference does (the prefill path covers the fast case).
    """
    B, S0 = prompt.shape
    s_max = s_max or (S0 + n_new)
    step = make_decode_step(cfg, s_max)
    cache = lm.init_cache(cfg, B, s_max, device=prompt.device, ctx_parallel=step.ctx_parallel)
    for t in range(S0):
        nxt, cache = step(params, prompt[:, t : t + 1], cache, t)
    tok = nxt[:, None]
    out = []
    for t in range(n_new):
        out.append(tok)
        nxt, cache = step(params, tok, cache, S0 + t)
        tok = nxt[:, None]
    return torch.cat(out, dim=1)
