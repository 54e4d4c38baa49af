"""Block assembly: norm → mixer → residual → norm → FFN → residual, and the
per-block decode cache.

The counterpart of ``repro._unused.models.blocks`` for the GQA mixer and
the dense or MoE FFN, sequential or parallel (Command-R style: one shared
norm, attention and FFN side by side). The other mixers (MLA, Mamba, RWKV)
and cross-attention raise ``NotImplementedError`` naming the ROADMAP item
that ports them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.configs.base import WAITING_SLICES, LayerDesc, ModelConfig
from .attention import GQA, KVCache, gqa_apply, gqa_init
from .layers import FFN, Norm, ffn_apply, ffn_init, norm_apply, norm_init
from .moe import MoE, moe_apply, moe_init

__all__ = ["Block", "block_init", "block_apply", "block_cache_init"]

def _waits(what: str, key: str) -> NotImplementedError:
    slice_ = WAITING_SLICES.get(key, "ROADMAP A.6")
    return NotImplementedError(f"{what} waits for its slice of the LM port ({slice_})")


def _check(desc: LayerDesc, cross: bool = False) -> None:
    if desc.mixer != "gqa":
        raise _waits(f"mixer {desc.mixer!r}", desc.mixer)
    if desc.ffn not in ("dense", "moe"):
        raise _waits(f"ffn {desc.ffn!r}", desc.ffn)
    if cross:
        raise _waits("cross-attention (enc-dec)", "encdec")


class Block(nn.Module):
    """``norm1``, ``mixer``, ``norm2`` (absent in a parallel block) and ``ffn``
    (an :class:`FFN`, or a :class:`MoE` in a ``ffn="moe"`` layer)."""

    def __init__(self, norm1: Norm, mixer: GQA, ffn: FFN | MoE, norm2: Norm | None = None):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn


def block_init(cfg: ModelConfig, desc: LayerDesc, *, gen=None, device=None,
               cross: bool = False) -> Block:
    _check(desc, cross)
    d = cfg.d_model
    return Block(
        norm_init(d, cfg, device=device),
        gqa_init(cfg, gen=gen, device=device),
        (moe_init(cfg, gen=gen, device=device) if desc.ffn == "moe"
         else ffn_init(cfg, cfg.d_ff_dense or cfg.d_ff, gen=gen, device=device)),
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
    ffn = moe_apply if desc.ffn == "moe" else ffn_apply
    if cfg.parallel_block:
        return x + out + ffn(p.ffn, xn, cfg), new_cache
    h = x + out
    return h + ffn(p.ffn, norm_apply(p.norm2, h, cfg), cfg), new_cache
