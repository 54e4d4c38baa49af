"""Block assembly: norm → mixer → residual → norm → FFN → residual, and the
per-block decode cache.

The counterpart of ``repro._unused.models.blocks`` for the GQA mixer and
the dense FFN, sequential or parallel (Command-R style: one shared norm,
attention and FFN side by side). The other mixers (MLA, Mamba, RWKV), the
MoE FFN and cross-attention raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import LayerDesc, ModelConfig
from .attention import GQA, KVCache, gqa_apply, gqa_init
from .layers import FFN, Norm, ffn_apply, ffn_init, norm_apply, norm_init

__all__ = ["Block", "block_init", "block_apply", "block_cache_init"]

_WAITS = "waits for its slice of the LM port (ROADMAP A10)"


def _check(desc: LayerDesc, cross: bool = False) -> None:
    if desc.mixer != "gqa":
        raise NotImplementedError(f"mixer {desc.mixer!r} {_WAITS}")
    if desc.ffn != "dense":
        raise NotImplementedError(f"ffn {desc.ffn!r} {_WAITS}")
    if cross:
        raise NotImplementedError(f"cross-attention (enc-dec) {_WAITS}")


class Block(nn.Module):
    """``norm1``, ``mixer``, ``norm2`` (absent in a parallel block) and ``ffn``."""

    def __init__(self, norm1: Norm, mixer: GQA, ffn: FFN, norm2: Norm | None = None):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn


def block_init(cfg: ModelConfig, desc: LayerDesc, *, gen=None, device=None,
               cross: bool = False) -> Block:
    _check(desc, cross)
    d = cfg.d_model
    return Block(
        norm_init(d, cfg, device=device),
        gqa_init(cfg, gen=gen, device=device),
        ffn_init(cfg, cfg.d_ff_dense or cfg.d_ff, gen=gen, device=device),
        None if cfg.parallel_block else norm_init(d, cfg, device=device),
    )


def block_cache_init(cfg: ModelConfig, desc: LayerDesc, batch: int, s_max: int, dtype,
                     *, device=None) -> dict:
    """The block's cache: ``{"mixer": KVCache}``, ``window`` slots when
    ``s_max >= window`` (a ring buffer), else ``s_max``."""
    _check(desc)
    s = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
    kv = (batch, s, cfg.n_kv_heads, cfg.head_dim)
    return {"mixer": KVCache(torch.zeros(kv, dtype=dtype, device=device),
                             torch.zeros(kv, dtype=dtype, device=device))}


def block_apply(
    p: Block,
    x: torch.Tensor,
    cfg: ModelConfig,
    desc: LayerDesc,
    *,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    cache_len=None,
    causal: bool = True,
):
    """Returns (x', new_cache)."""
    _check(desc)
    mixer_cache = (cache or {}).get("mixer")
    xn = norm_apply(p.norm1, x, cfg)
    out, mc = gqa_apply(p.mixer, xn, cfg, positions=positions, causal=causal,
                        cache=mixer_cache, cache_len=cache_len)
    new_cache = None if mc is None else {"mixer": mc}
    if cfg.parallel_block:
        return x + out + ffn_apply(p.ffn, xn, cfg), new_cache
    h = x + out
    return h + ffn_apply(p.ffn, norm_apply(p.norm2, h, cfg), cfg), new_cache
