"""Block assembly: norm → mixer → residual → norm → FFN → residual, and the
per-block decode cache.

The counterpart of ``repro._unused.models.blocks`` for every mixer of the
architecture pool (GQA, MLA, Mamba, RWKV-6) and the dense, MoE or RWKV
channel-mix FFN, sequential or parallel (Command-R style: one shared norm,
attention and FFN side by side). An enc-dec decoder block
(``cross=True``) adds ``norm_x`` and a cross-attention :class:`GQA`
between the mixer and the FFN: against the encoder's output ``xa`` in a
full forward, against the encoder K/V that ``lm.prefill_cross`` put in the
block's cache (``"cross"``, every key valid) in decode.

RWKV's token shifts: in prefill the channel mix's ``x_prev`` is the padded
shift of its normed input; in decode it is the cache's ``x_cm``, which then
becomes this step's normed input (the time mix writes ``x_tm`` itself).

Under a ``model`` axis of more than one position (``sharding.rules``),
every mixer, cross-attention, the dense FFN, the RWKV channel mix and the
MoE compute on each position's slice of their split dimensions and end in
one sum (``gqa_apply`` and ``mla_apply`` over the heads, ``mamba_apply``
over ``d_inner`` with one more sum inside, ``rwkv_apply`` over the heads,
``ffn_apply``, ``moe_apply``); the norms and the residual adds run once per
data shard, on the reduced output, on its first position. A mixer whose
split dimension the axis does not divide computes the whole layer there
(:func:`split_mixers` names the mixers that split).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import LayerDesc, ModelConfig
from .attention import (GQA, MLA, KVCache, gqa_apply, gqa_axes, gqa_heads_split, gqa_init,
                        mla_apply, mla_axes, mla_heads_split, mla_init)
from .layers import (FFN, ChannelMix, Norm, ffn_apply, ffn_axes, ffn_init, norm_apply,
                     norm_axes, norm_init)
from .moe import MoE, moe_apply, moe_axes, moe_init
from .ssm import (RWKV, Mamba, MambaCache, RwkvCache, mamba_apply, mamba_axes, mamba_init,
                  mamba_split, rwkv_apply, rwkv_axes, rwkv_heads_split, rwkv_init)

__all__ = ["Block", "block_init", "block_axes", "block_apply", "block_cache_init",
           "block_cache_axes", "split_mixers"]

_MIXER_INIT = {"gqa": gqa_init, "mla": mla_init, "mamba": mamba_init, "rwkv6": rwkv_init}
_MIXER_AXES = {"gqa": gqa_axes, "mla": mla_axes, "mamba": mamba_axes, "rwkv6": rwkv_axes}
_MIXER_SPLITS = {"gqa": lambda cfg: 2 if gqa_heads_split(cfg) else 1, "mla": mla_heads_split,
                 "mamba": mamba_split, "rwkv6": rwkv_heads_split}


def split_mixers(cfg: ModelConfig) -> set[str]:
    """The mixers of ``cfg``'s decoder layers (``"gqa"``, ``"mla"``,
    ``"mamba"``, ``"rwkv6"``) that the active rules split over ``model``:
    the GQA and MLA heads, Mamba's ``d_inner``, RWKV-6's heads. Empty
    without a ``model`` axis of more than one position."""
    kinds = {d.mixer for pattern, _ in cfg.layer_list for d in pattern}
    return {k for k in kinds if _MIXER_SPLITS[k](cfg) > 1}


class Block(nn.Module):
    """``norm1``, ``mixer`` (a :class:`GQA`, :class:`MLA`, :class:`Mamba` or
    :class:`RWKV`), ``norm2`` (absent in a parallel block), ``ffn`` (an
    :class:`FFN`, a :class:`ChannelMix`, or a :class:`MoE` in a
    ``ffn="moe"`` layer) and, in an enc-dec decoder block, ``norm_x`` and
    ``cross`` (a :class:`GQA`)."""

    def __init__(self, norm1: Norm, mixer: GQA | MLA | Mamba | RWKV,
                 ffn: FFN | ChannelMix | MoE, norm2: Norm | None = None,
                 norm_x: Norm | None = None, cross: GQA | None = None):
        super().__init__()
        self.norm1, self.mixer, self.norm2, self.ffn = norm1, mixer, norm2, ffn
        self.norm_x, self.cross = norm_x, cross


def block_init(cfg: ModelConfig, desc: LayerDesc, *, gen=None, device=None,
               cross: bool = False) -> Block:
    if "none" in (desc.mixer, desc.ffn):
        raise ValueError(f"{desc}: no card has a layer without a mixer or an FFN")
    d = cfg.d_model
    return Block(
        norm_init(d, cfg, device=device),
        _MIXER_INIT[desc.mixer](cfg, gen=gen, device=device),
        (moe_init(cfg, gen=gen, device=device) if desc.ffn == "moe"
         else ffn_init(cfg, cfg.d_ff_dense or cfg.d_ff, gen=gen, device=device)),
        None if cfg.parallel_block else norm_init(d, cfg, device=device),
        norm_init(d, cfg, device=device) if cross else None,
        gqa_init(cfg, gen=gen, device=device) if cross else None,
    )


def block_axes(cfg: ModelConfig, desc: LayerDesc, *, cross: bool = False) -> dict:
    """The logical axes of a :class:`Block`'s leaves, keyed as its parameters."""
    a: dict = {"norm1": norm_axes(cfg), "mixer": _MIXER_AXES[desc.mixer](cfg)}
    if cross:
        a["norm_x"] = norm_axes(cfg)
        a["cross"] = gqa_axes(cfg)
    if not cfg.parallel_block:
        a["norm2"] = norm_axes(cfg)
    a["ffn"] = moe_axes(cfg) if desc.ffn == "moe" else ffn_axes(cfg)
    return a


def block_cache_init(cfg: ModelConfig, desc: LayerDesc, batch: int, s_max: int, dtype,
                     *, cross_len: int = 0, device=None) -> dict:
    """The block's cache ``{"mixer": ...}``: GQA a :class:`KVCache` of
    ``window`` slots when ``s_max >= window`` (a ring buffer), else
    ``s_max``; MLA the latent and rope-key :class:`KVCache`; Mamba and RWKV
    their states, float32 where the reference keeps float32. With
    ``cross_len`` also ``"cross"``, a :class:`KVCache` of ``cross_len``
    encoder positions."""
    d = cfg.d_model

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if desc.mixer == "gqa":
        s = min(s_max, cfg.sliding_window) if cfg.sliding_window else s_max
        kv = (batch, s, cfg.n_kv_heads, cfg.head_dim)
        caches = {"mixer": KVCache(zeros(*kv), zeros(*kv))}
    elif desc.mixer == "mla":
        caches = {"mixer": KVCache(zeros(batch, s_max, cfg.kv_lora_rank),
                                   zeros(batch, s_max, cfg.qk_rope_head_dim))}
    elif desc.mixer == "mamba":
        caches = {"mixer": MambaCache(
            zeros(batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner),
            zeros(batch, cfg.mamba_d_inner, cfg.mamba_d_state, dt=torch.float32))}
    else:
        H, dh = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        caches = {"mixer": RwkvCache(zeros(batch, 1, d), zeros(batch, 1, d),
                                     zeros(batch, H, dh, dh, dt=torch.float32))}
    if cross_len:
        kv = (batch, cross_len, cfg.n_kv_heads, cfg.head_dim)
        caches["cross"] = KVCache(zeros(*kv), zeros(*kv))
    return caches


def block_cache_axes(cfg: ModelConfig, desc: LayerDesc, *, ctx_parallel: bool = False,
                     cross: bool = False) -> dict:
    """The logical axes of :func:`block_cache_init`'s leaves; with
    ``ctx_parallel`` the GQA and MLA caches' sequence axis is ``seq_ctx``."""
    seq_ax = "seq_ctx" if ctx_parallel else None
    if desc.mixer == "gqa":
        kv = ("batch", seq_ax, "kv_heads", None)
        axes = {"mixer": KVCache(kv, kv)}
    elif desc.mixer == "mla":
        axes = {"mixer": KVCache(("batch", seq_ax, None), ("batch", seq_ax, None))}
    elif desc.mixer == "mamba":
        axes = {"mixer": MambaCache(("batch", None, "mlp"), ("batch", "mlp", None))}
    else:
        axes = {"mixer": RwkvCache(("batch", None, None), ("batch", None, None),
                                   ("batch", "heads", None, None))}
    if cross:
        kv = ("batch", None, "kv_heads", None)
        axes["cross"] = KVCache(kv, kv)
    return axes


def _apply_mixer(p, x, cfg, desc, *, positions, cache, cache_len, causal, ctx_parallel):
    if desc.mixer == "gqa":
        return gqa_apply(p, x, cfg, positions=positions, causal=causal, cache=cache,
                         cache_len=cache_len, ctx_parallel=ctx_parallel)
    if desc.mixer == "mla":
        return mla_apply(p, x, cfg, positions=positions, causal=causal, cache=cache,
                         cache_len=cache_len, ctx_parallel=ctx_parallel)
    if desc.mixer == "mamba":
        return mamba_apply(p, x, cfg, cache=cache)
    return rwkv_apply(p, x, cfg, cache=cache)


def block_apply(
    p: Block,
    x: torch.Tensor,
    cfg: ModelConfig,
    desc: LayerDesc,
    *,
    positions: torch.Tensor,
    cache: Optional[dict] = None,
    cache_len=None,
    xa: Optional[torch.Tensor] = None,  # encoder context (cross-attention blocks)
    causal: bool = True,
    ctx_parallel: bool = False,
):
    """Returns (x', new_cache)."""
    mixer_cache = (cache or {}).get("mixer")
    xn = norm_apply(p.norm1, x, cfg)
    out, mc = _apply_mixer(p.mixer, xn, cfg, desc, positions=positions, cache=mixer_cache,
                           cache_len=cache_len, causal=causal, ctx_parallel=ctx_parallel)
    if cfg.parallel_block:
        ffn = moe_apply if desc.ffn == "moe" else ffn_apply
        return x + out + ffn(p.ffn, xn, cfg), (None if mc is None else {"mixer": mc})
    h = x + out
    new_cache = {}
    if p.cross is not None:
        xn = norm_apply(p.norm_x, h, cfg)
        cross_cache = (cache or {}).get("cross")
        if cross_cache is not None and xa is None:  # decode: the prefilled encoder K/V
            out, _ = gqa_apply(p.cross, xn, cfg, positions=positions, causal=False,
                               cache=cross_cache, kv_cached=True)
            new_cache["cross"] = cross_cache
        else:
            out, _ = gqa_apply(p.cross, xn, cfg, positions=positions, causal=False, xa=xa)
        h = h + out
    xn = norm_apply(p.norm2, h, cfg)
    if desc.ffn == "moe":
        f = moe_apply(p.ffn, xn, cfg)
    elif cfg.ffn_act == "rwkv_cm":
        if mixer_cache is not None:  # decode: the previous step's normed input
            x_prev = mixer_cache.x_cm.to(xn.dtype)
            mc = mc._replace(x_cm=xn.to(mc.x_cm.dtype))
        else:
            x_prev = F.pad(xn, (0, 0, 1, 0))[:, : xn.shape[1]]
        f = ffn_apply(p.ffn, xn, cfg, x_prev=x_prev)
    else:
        f = ffn_apply(p.ffn, xn, cfg)
    if mc is not None:
        new_cache["mixer"] = mc
    return h + f, (new_cache or None)
