"""Attention mixers: GQA (self- or cross-attention) and MLA (DeepSeek-V2
multi-head latent attention), the chunked streaming softmax, single-token
decode against a KV cache (ring-buffered for sliding-window models), and
the flash switch.

The counterpart of ``repro._unused.models.attention``.
Full-sequence attention runs the flash kernel when :func:`_use_flash` says
so (``"auto"``: the tensors are on a CUDA device, as ``"auto"`` means a TPU
in the reference) and the streaming softmax :func:`_attend_chunked`
otherwise. The flash call goes through :func:`_flash_with_plain_bwd`, the
counterpart of the reference's ``_flash_with_xla_bwd``: the kernel forward
and, under a gradient, a backward that recomputes :func:`_attend_chunked`
under autograd. Cross-attention (``gqa_apply(..., xa=...)``) takes K and V
from the encoder's output, with no rotary positions, no causal mask and no
window. The cache write is in place (the reference returns a new buffer);
the returned cache holds the same tensors.
Context-parallel decode (``ctx_parallel=True``, the serve step's long
caches): under a rule context, ``lm.init_cache`` lays a GQA or MLA cache
whose ``seq_ctx`` axis maps to ``model`` as sequence tiles on the model
devices (a :class:`~repro_torch.sharding.place.Placed` leaf). The write is
the reference's masked write: each tile writes the slot only where it falls
in its slice. :func:`_attend_decode_tiles` computes each tile's softmax
partials ``(max, sum, acc)`` on its device and joins them with the
flash-decode combine on the data shard's first device, the three
reductions that GSPMD makes collectives in the reference. A plain cache
(no rules) takes the same write in place.
MLA caches the latent and the shared rope key and rebuilds each head's keys
and values from the latent at every step; its prefill runs the streaming
softmax, never the flash kernel, as in the reference (its key width
dn + dr = 192 differs from its value width dv = 128).
"""

from __future__ import annotations

import contextlib
import math
import os
from typing import NamedTuple, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import dispatch_type
from repro_torch.launch import cost
from repro_torch.sharding.place import Placed, model_parts
from repro_torch.sharding.rules import (batch_shards, model_positions, model_size, model_split,
                                        on_position, shard)
from repro_torch._unused.flash_attention import flash_attention
from .layers import (Dense, DenseTile, Norm, apply_rope, cdtype, dense_apply, dense_axes,
                     dense_init, dense_tile, dense_tp, norm_apply, norm_axes, norm_init,
                     rope_sin_cos)

__all__ = ["GQA", "gqa_init", "gqa_axes", "gqa_apply", "gqa_heads_split", "MLA", "mla_init",
           "mla_axes", "mla_apply", "mla_heads_split", "KVCache", "flash_enabled"]

NEG_INF = -1e30

_FLASH = {"on": os.environ.get("REPRO_FLASH", "auto")}


@contextlib.contextmanager
def flash_enabled(mode: str = "on"):
    prev = _FLASH["on"]
    _FLASH["on"] = mode
    try:
        yield
    finally:
        _FLASH["on"] = prev


def _use_flash(x: torch.Tensor) -> bool:
    mode = _FLASH["on"]
    if mode == "off" or mode == "0":
        return False
    if mode in ("on", "1", "force"):
        return True
    return dispatch_type(x) == "cuda"  # auto (a counted meta tensor: the counter's target)


class _FlashPlainBwd(torch.autograd.Function):
    """Flash forward; the backward is the vjp of :func:`_attend_chunked`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        ctx.save_for_backward(q, k, v)
        ctx.opts = (causal, window, scale)
        return flash_attention(q, k, v, causal=causal, window=window, scale=scale)

    @staticmethod
    def backward(ctx, g):
        causal, window, scale = ctx.opts
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            out = _attend_chunked(*qkv, causal=causal, window=window, scale=scale)
        return (*torch.autograd.grad(out, qkv, g.float()), None, None, None)


def _flash_with_plain_bwd(q, k, v, *, causal: bool, window: Optional[int], scale: float):
    """The flash kernel (:func:`flash_attention`: the CUDA kernel on CUDA
    tensors, its plain version on CPU tensors) with the reference's
    backward: recompute :func:`_attend_chunked` (its default bf16
    probabilities, whatever the compute dtype) and return its vjp of the
    incoming gradient cast to float32. No kernel runs in the backward."""
    return _FlashPlainBwd.apply(q, k, v, causal, window, scale)


class KVCache(NamedTuple):
    """Decode-time cache. For GQA: k/v (B, S_max, Hkv, dh); S_max = window
    (a ring buffer) for sliding-window models decoding past the window. For
    MLA: k = latent c_kv (B, S_max, kv_lora), v = shared rope key
    (B, S_max, rope_dim)."""

    k: torch.Tensor
    v: torch.Tensor


def _cache_write(buf, new: torch.Tensor, slot: int, ctx_parallel: bool = False):
    """Write ``new`` (B, 1, ...) at position ``slot`` of ``buf``'s seq axis,
    in place. With ``ctx_parallel`` the buffer may be laid as sequence
    tiles (:class:`Placed`, made so by ``lm.init_cache`` under the rules):
    the masked write, each tile writing only where the slot falls in its
    slice, no tile leaving its device."""
    if not (ctx_parallel and isinstance(buf, Placed)):
        buf[:, slot : slot + 1] = new.to(buf.dtype)
        return buf
    for pos in buf.positions():
        sl = buf.sharding.indices(buf.shape, pos)
        seq = sl[1]
        if seq.start <= slot < seq.stop:
            tile = buf.tiles[pos]
            part = new[(sl[0], slice(0, 1), *sl[2:])]
            tile[:, slot - seq.start : slot - seq.start + 1] = part.to(tile.device, tile.dtype)
    return buf


# =====================================================================================
# chunked streaming attention core
# =====================================================================================
def _attend_chunked(
    q: torch.Tensor,  # (B, S, Hkv, G, dh) — grouped query
    k: torch.Tensor,  # (B, T, Hkv, dh)
    v: torch.Tensor,  # (B, T, Hkv, dhv)
    *,
    causal: bool,
    window: Optional[int],
    scale: float,
    kv_chunk: int = 1024,
    softcap: Optional[float] = None,
    p_dtype=torch.bfloat16,  # probability-tensor storage before the PV product
):
    """Streaming-softmax attention over KV chunks. Returns (B,S,Hkv,G,dhv) f32.

    The probabilities are rounded to ``p_dtype`` and multiplied with V
    rounded to ``p_dtype``, with a float32 product and sum, as the
    reference's ``preferred_element_type=float32`` einsum does.
    """
    B, S, Hkv, G, dh = q.shape
    T = k.shape[1]
    dhv = v.shape[-1]
    n_chunks = -(-T // kv_chunk)
    dev = q.device
    q32 = q.float() * scale
    qpos = torch.arange(S, device=dev)
    m = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, G, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, G, S, dhv), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        k_i = k[:, ci * kv_chunk : (ci + 1) * kv_chunk]
        v_i = v[:, ci * kv_chunk : (ci + 1) * kv_chunk]
        kpos = ci * kv_chunk + torch.arange(k_i.shape[1], device=dev)
        s_ij = torch.einsum("bshgd,bthd->bhgst", q32, k_i.float())
        if softcap is not None:
            s_ij = softcap * torch.tanh(s_ij / softcap)
        mask = kpos[None, :] <= (qpos[:, None] if causal else T)
        if window is not None:
            mask &= kpos[None, :] > qpos[:, None] - window
        s_ij = s_ij.masked_fill(~mask, NEG_INF)
        m_new = torch.maximum(m, s_ij.amax(-1))
        p = torch.exp(s_ij - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgst,bthd->bhgsd", p.to(p_dtype).float(), v_i.to(p_dtype).float()
        )
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)  # (B,S,Hkv,G,dhv)


def _attend_decode(
    q: torch.Tensor,  # (B, 1, Hkv, G, dh)
    k: torch.Tensor,  # (B, T, Hkv, dh)
    v: torch.Tensor,  # (B, T, Hkv, dhv)
    *,
    scale: float,
    valid: torch.Tensor,  # (B, T) bool — which cache slots participate
    softcap: Optional[float] = None,
):
    """Single-token attention against the cache → (B,1,Hkv,G,dhv) f32."""
    q32 = q.float() * scale
    s = torch.einsum("bxhgd,bthd->bhgxt", q32, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    s = s.masked_fill(~valid[:, None, None, None, :], NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = torch.einsum("bhgxt,bthd->bhgxd", p / torch.clamp_min(l, 1e-30), v.float())
    return out.permute(0, 3, 1, 2, 4)  # (B,1,Hkv,G,dhv)


def _on(p: Dense, device: torch.device) -> Dense | DenseTile:
    """``p``'s weights whole on ``device`` (the module itself where they
    are): a leaf laid over the mesh (the serving layout's split leaves) is
    gathered there (``Placed.full``, an ``"all-gather"`` to a work
    counter)."""
    if isinstance(p.w, Placed):
        return DenseTile(p.w.full(device), None if p.b is None else p.b.full(device))
    if p.w.device == device:
        return p
    return Dense(p.w.to(device), None if p.b is None else p.b.to(device))


def _attend_decode_tiles(q: torch.Tensor, k: Placed, v: Placed, *, scale: float,
                         valid: torch.Tensor, softcap: Optional[float] = None, kv=None):
    """:func:`_attend_decode` over a cache laid as tiles (batch over data
    shards, sequence over model shards). Each tile's partials — the row
    max ``m``, the sum ``l`` of ``exp(s − m)`` and ``acc`` = that times V —
    are computed on the tile's device; the flash-decode combine
    (``M = max m``, ``l = Σ l·e^(m−M)``, ``acc = Σ acc·e^(m−M)``, out =
    acc / l) runs on the first tile's device of each batch slice, and the
    batch slices are joined on q's device. ``kv(k_tile, v_tile)`` maps the
    cached tiles to the keys and values (MLA rebuilds them from its latent
    cache); ``None`` takes them as they are."""
    q32 = q.float() * scale
    v_blocks = v.blocks()
    parts: dict[tuple[int, int], list] = {}
    where = k.block_positions()
    for coords, k_t in k.blocks().items():
        sl = k.block_slices(coords)
        dev = k_t.device
        with on_position(where[coords]):
            k_f, v_f = (k_t, v_blocks[coords]) if kv is None else kv(k_t, v_blocks[coords])
            s = torch.einsum("bxhgd,bthd->bhgxt", q32[sl[0]].to(dev), k_f.float())
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            s = s.masked_fill(~valid[sl[0], sl[1]].to(dev)[:, None, None, None, :], NEG_INF)
            m = s.amax(-1, keepdim=True)
            p = torch.exp(s - m)
            acc = torch.einsum("bhgxt,bthd->bhgxd", p, v_f.float())
            l_t = p.sum(-1, keepdim=True)
        parts.setdefault((sl[0].start, sl[0].stop), []).append((m, l_t, acc, where[coords]))
    counter = cost.active()
    if counter is not None:  # each tile's partials go to its batch slice's first tile
        for group in parts.values():
            for part in group[1:]:
                counter.collective("gather", sum(t.numel() * t.element_size()
                                                 for t in part[:3]), group[0][3])
    outs = []
    for _, group in sorted(parts.items()):
        group = [part[:3] for part in group]
        dev = group[0][0].device
        ms = [m.to(dev) for m, _, _ in group]
        M = ms[0]
        for m in ms[1:]:
            M = torch.maximum(M, m)
        l = acc = 0.0
        for m, (_, l_t, acc_t) in zip(ms, group):
            w = torch.exp(m - M)
            l = l + l_t.to(dev) * w
            acc = acc + acc_t.to(dev) * w
        outs.append((acc / torch.clamp_min(l, 1e-30)).permute(0, 3, 1, 2, 4).to(q.device))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)  # (B,1,Hkv,G,dhv)


# =====================================================================================
# GQA
# =====================================================================================
class GQA(nn.Module):
    """``wq`` (d, H, dh), ``wk``/``wv`` (d, Hkv, dh), each with ``b`` when
    ``qkv_bias``, and ``wo`` (H·dh, d)."""

    def __init__(self, wq: Dense, wk: Dense, wv: Dense, wo: Dense):
        super().__init__()
        self.wq, self.wk, self.wv, self.wo = wq, wk, wv, wo


def gqa_init(cfg: ModelConfig, *, gen=None, device=None) -> GQA:
    d, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    kw = dict(gen=gen, device=device)
    return GQA(
        dense_init(d, (H, dh), cfg, bias=cfg.qkv_bias, **kw),
        dense_init(d, (Hkv, dh), cfg, bias=cfg.qkv_bias, **kw),
        dense_init(d, (Hkv, dh), cfg, bias=cfg.qkv_bias, **kw),
        dense_init(H * dh, (d,), cfg, **kw),
    )


def gqa_axes(cfg: ModelConfig) -> dict:
    b = cfg.qkv_bias
    return {
        "wq": dense_axes("fsdp", ("heads", "head_dim"), bias=b),
        "wk": dense_axes("fsdp", ("kv_heads", "head_dim"), bias=b),
        "wv": dense_axes("fsdp", ("kv_heads", "head_dim"), bias=b),
        "wo": dense_axes("mlp", ("fsdp",)),
    }


def gqa_heads_split(cfg: ModelConfig) -> bool:
    """Whether the active rules split the heads over ``model`` (``wq``'s
    ``heads`` axis divides the model axis): then :func:`gqa_apply` computes
    each model position's heads on it (:func:`_gqa_heads`) and
    ``lm.init_cache`` lays the decode cache as ``kv_heads`` tiles."""
    return model_split(("fsdp", "heads", "head_dim"),
                       (cfg.d_model, cfg.n_heads, cfg.head_dim))[1] > 1


def _kv_heads_of(cfg: ModelConfig, m: int, n: int) -> tuple[slice, int, bool]:
    """(the kv heads model position ``m`` of ``n`` attends with, G_loc,
    whether the rules split ``kv_heads`` as they split the heads). Split:
    the position's own kv tile, G_loc = G. Else, the fallback that keeps
    ``kv_heads`` whole: the kv heads its q heads [m·H/n, (m+1)·H/n) belong
    to, whole groups (G_loc = G) or one kv head (G_loc = H/n)."""
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G, h_loc = H // Hkv, H // n
    lo = m * h_loc
    if model_split(("fsdp", "kv_heads", "head_dim"), (cfg.d_model, Hkv, dh))[1] == n:
        return slice(lo // G, (lo + h_loc) // G), G, True
    if h_loc % G == 0:
        return slice(lo // G, (lo + h_loc) // G), G, False
    if G % h_loc == 0:
        return slice(lo // G, lo // G + 1), h_loc, False
    raise ValueError(f"{n} model positions of {h_loc} heads each do not align with kv "
                     f"groups of {G}: no kv head layout for position {m}")


def gqa_apply(
    p: GQA,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,  # (S,) absolute positions of x
    causal: bool = True,
    cache: Optional[KVCache] = None,
    cache_len: Optional[int] = None,  # tokens already in cache
    xa: Optional[torch.Tensor] = None,  # cross-attention context (B, Sx, d)
    ctx_parallel: bool = False,
    kv_cached: bool = False,  # decode against a prefilled cross cache (read only)
):
    """Returns (out (B,S,d), new_cache). With ``kv_cached`` the cache holds
    the encoder's K/V (``lm.prefill_cross``): every key attends, nothing is
    written. Under a ``model`` axis that splits the heads, each position
    computes its own (:func:`_gqa_heads`), the context-parallel decode
    excepted; otherwise the projections run through ``dense_tp``
    (column-parallel, joined on the first position), the attention there,
    and ``wo`` row-parallel."""
    B, S, d = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    G = H // Hkv
    scale = 1.0 / math.sqrt(dh)
    seq_tiles = cache is not None and isinstance(cache.k, Placed) and ctx_parallel
    if gqa_heads_split(cfg) and not seq_tiles:
        return _gqa_heads(p, x, cfg, positions=positions, causal=causal, cache=cache,
                          cache_len=cache_len, xa=xa, kv_cached=kv_cached)

    q = dense_tp(p.wq, x, cfg, "fsdp", ("heads", "head_dim"))  # (B,S,H,dh)
    if kv_cached:
        valid = torch.ones((B, cache.k.shape[1]), dtype=torch.bool, device=x.device)
        out = _attend_decode(q.reshape(B, S, Hkv, G, dh), cache.k, cache.v, scale=scale,
                             valid=valid)
        out = out.reshape(B, S, H * dh).to(cdtype(cfg))
        return dense_tp(p.wo, out, cfg, "mlp", ("fsdp",)), cache
    kv_src = x if xa is None else xa
    k = dense_tp(p.wk, kv_src, cfg, "fsdp", ("kv_heads", "head_dim"))
    v = dense_tp(p.wv, kv_src, cfg, "fsdp", ("kv_heads", "head_dim"))
    q = shard(q, ("batch", "seq", "heads", "head_dim"))
    k = shard(k, ("batch", "seq", "kv_heads", "head_dim"))
    v = shard(v, ("batch", "seq", "kv_heads", "head_dim"))
    if xa is None:  # self-attention: rotary positions, the same for q and k
        sin, cos = rope_sin_cos(positions, dh, cfg.rope_theta)
        q = apply_rope(q, sin[None], cos[None])
        k = apply_rope(k, sin[None], cos[None])
    qg = q.reshape(B, S, Hkv, G, dh)
    new_cache = None

    if cache is not None:
        # decode: write k,v at the cache cursor, attend to the whole cache
        slot, valid = _decode_slot(cfg, cache, cache_len, x.device)
        ck = _cache_write(cache.k, k, slot, ctx_parallel)
        cv = _cache_write(cache.v, v, slot, ctx_parallel)
        new_cache = KVCache(ck, cv)
        axes = ("batch", "seq_ctx" if ctx_parallel else None, "kv_heads", "head_dim")
        ck, cv = shard(ck, axes), shard(cv, axes)
        attend = _attend_decode_tiles if isinstance(ck, Placed) else _attend_decode
        out = attend(qg, ck, cv, scale=scale, valid=valid.expand(B, -1),
                     softcap=cfg.attn_logit_softcap)
    else:
        out = _attend_full(qg, k, v, cfg, causal=causal and xa is None, cross=xa is not None,
                           scale=scale)

    out = shard(out.reshape(B, S, H * dh).to(cdtype(cfg)), ("batch", "seq", "mlp"))
    return dense_tp(p.wo, out, cfg, "mlp", ("fsdp",)), new_cache


def _decode_slot(cfg: ModelConfig, cache: KVCache, cache_len, device):
    """(the cache slot this step writes, the valid slots (S_max,) bool)."""
    cache_len = int(cache_len)
    S_max = cache.k.shape[1]
    ring = bool(cfg.sliding_window) and S_max == cfg.sliding_window
    slot = cache_len % cfg.sliding_window if ring else cache_len
    t_idx = torch.arange(S_max, device=device)
    if ring:
        valid = t_idx <= min(cache_len, S_max - 1)
    else:
        valid = t_idx <= cache_len
        if cfg.sliding_window:
            valid &= t_idx > cache_len - cfg.sliding_window
    return slot, valid


def _attend_full(qg, k, v, cfg: ModelConfig, *, causal: bool, cross: bool, scale: float):
    """Full-sequence attention: the flash kernel where :func:`_use_flash`
    says so (and no softcap), else the streaming softmax; cross-attention
    has no window."""
    win = None if cross else cfg.sliding_window
    if _use_flash(qg) and cfg.attn_logit_softcap is None:
        return _flash_with_plain_bwd(qg, k, v, causal=causal, window=win, scale=scale)
    return _attend_chunked(qg, k, v, causal=causal, window=win, scale=scale,
                           softcap=cfg.attn_logit_softcap, p_dtype=cdtype(cfg))


def _gqa_heads(p: GQA, x: torch.Tensor, cfg: ModelConfig, *, positions, causal, cache,
               cache_len, xa, kv_cached):
    """:func:`gqa_apply` with the heads over ``model``: model position m
    projects x onto its heads (column-parallel ``wq``, and ``wk``/``wv`` on
    its kv tile, or on the kv heads its q heads belong to where the rules
    keep ``kv_heads`` whole), applies RoPE, attends with (B, S, Hkv_loc,
    G_loc, dh) queries (the flash kernel, launched on its heads, or the
    streaming softmax; in decode against its tile of the cache) and
    multiplies its rows of ``wo``; the partials are summed once."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim
    n = model_size()
    h_loc = H // n
    scale = 1.0 / math.sqrt(dh)
    q_axes, kv_axes = ("heads", "head_dim"), ("kv_heads", "head_dim")
    if cache is not None and not kv_cached:
        slot, valid = _decode_slot(cfg, cache, cache_len, x.device)
    sin_cos = None if xa is not None else rope_sin_cos(positions, dh, cfg.rope_theta)

    rows_of = {tuple(c.items()): r for c, r in batch_shards(x.shape)}

    def kv_dense(d: Dense, m, coords, ks, split) -> DenseTile:
        t = dense_tile(d, "fsdp", kv_axes, m, coords)
        return t if split else DenseTile(t.w[:, ks], None if t.b is None else t.b[ks])

    def cache_tile(buf, m, coords, ks, split, dev):
        """This position's view of a cache leaf: its ``kv_heads`` tile (in a
        replica the rules keep whole, the kv heads it reads); of a whole
        cache (the cross cache), its rows and kv heads."""
        if isinstance(buf, Placed):
            t = buf.tiles[model_positions(coords)[m]]
            return t if split else t[:, :, ks]
        t = buf[rows_of[tuple(coords.items())]][:, :, ks]
        if t.device != dev and not kv_cached:
            raise ValueError("a decode cache under a model axis must be laid by "
                             "lm.init_cache under the same rules (kv_heads tiles)")
        return t.to(dev)

    def one(m, xm, coords):
        dev = xm.device
        ks, g_loc, split = _kv_heads_of(cfg, m, n)
        q = dense_apply(dense_tile(p.wq, "fsdp", q_axes, m, coords), xm, cfg)  # (B,S,H_loc,dh)
        if kv_cached:
            ck, cv = (cache_tile(c, m, coords, ks, split, dev) for c in (cache.k, cache.v))
            valid_all = torch.ones((xm.shape[0], ck.shape[1]), dtype=torch.bool, device=dev)
            out = _attend_decode(q.reshape(*xm.shape[:2], -1, g_loc, dh), ck, cv, scale=scale,
                                 valid=valid_all)
        else:
            src = xm if xa is None else xa[rows_of[tuple(coords.items())]].to(dev)
            k = dense_apply(kv_dense(p.wk, m, coords, ks, split), src, cfg)
            v = dense_apply(kv_dense(p.wv, m, coords, ks, split), src, cfg)
            if sin_cos is not None:
                sin, cos = (t.to(dev)[None] for t in sin_cos)
                q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
            qg = q.reshape(*q.shape[:2], k.shape[2], g_loc, dh)
            if cache is not None:
                ck, cv = (cache_tile(c, m, coords, ks, split, dev) for c in (cache.k, cache.v))
                _cache_write(ck, k, slot)
                _cache_write(cv, v, slot)
                out = _attend_decode(qg, ck, cv, scale=scale,
                                     valid=valid.to(dev).expand(qg.shape[0], -1),
                                     softcap=cfg.attn_logit_softcap)
            else:
                out = _attend_full(qg, k, v, cfg, causal=causal and xa is None,
                                   cross=xa is not None, scale=scale)
        out = out.reshape(*xm.shape[:2], h_loc * dh).to(cdtype(cfg))
        return dense_apply(dense_tile(p.wo, "mlp", ("fsdp",), m, coords), out, cfg)

    return model_parts(x, one, n), cache


# =====================================================================================
# MLA (DeepSeek-V2)
# =====================================================================================
class MLA(nn.Module):
    """``wdq`` (d, q_lora), ``q_norm``, ``wuq`` (q_lora, H, dn + dr), ``wdkv``
    (d, kv_lora), ``kv_norm``, ``wkr`` (d, dr; the shared rope key), ``wuk``
    (kv_lora, H, dn), ``wuv`` (kv_lora, H, dv) and ``wo`` (H·dv, d)."""

    def __init__(self, wdq: Dense, q_norm: Norm, wuq: Dense, wdkv: Dense, kv_norm: Norm,
                 wkr: Dense, wuk: Dense, wuv: Dense, wo: Dense):
        super().__init__()
        self.wdq, self.q_norm, self.wuq = wdq, q_norm, wuq
        self.wdkv, self.kv_norm, self.wkr = wdkv, kv_norm, wkr
        self.wuk, self.wuv, self.wo = wuk, wuv, wo


def mla_init(cfg: ModelConfig, *, gen=None, device=None) -> MLA:
    d, H = cfg.d_model, cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    kw = dict(gen=gen, device=device)
    return MLA(
        dense_init(d, (qr,), cfg, **kw),
        norm_init(qr, cfg, device=device),
        dense_init(qr, (H, dn + dr), cfg, **kw),
        dense_init(d, (kr,), cfg, **kw),
        norm_init(kr, cfg, device=device),
        dense_init(d, (dr,), cfg, **kw),
        dense_init(kr, (H, dn), cfg, **kw),
        dense_init(kr, (H, dv), cfg, **kw),
        dense_init(H * dv, (d,), cfg, **kw),
    )


def mla_axes(cfg: ModelConfig) -> dict:
    return {
        "wdq": dense_axes("fsdp", (None,)),
        "q_norm": norm_axes(cfg),
        "wuq": dense_axes("fsdp", ("heads", "head_dim")),
        "wdkv": dense_axes("fsdp", (None,)),
        "kv_norm": norm_axes(cfg),
        "wkr": dense_axes("fsdp", (None,)),
        "wuk": dense_axes("fsdp", ("heads", "head_dim")),
        "wuv": dense_axes("fsdp", ("heads", "head_dim")),
        "wo": dense_axes("mlp", ("fsdp",)),
    }


def mla_heads_split(cfg: ModelConfig) -> int:
    """Over how many model positions the active rules split MLA's heads
    (``wuq``'s ``heads`` axis; 1: the whole layer on the first position).
    ``wuk``, ``wuv`` and ``wo``'s rows must split with them, else
    ``ValueError``."""
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    qr, kr = cfg.q_lora_rank, cfg.kv_lora_rank
    n = model_split(("fsdp", "heads", "head_dim"), (qr, H, dn + dr))[1]
    if n == 1:
        return 1
    leaves = {"wuk": (("fsdp", "heads", "head_dim"), (kr, H, dn), 1),
              "wuv": (("fsdp", "heads", "head_dim"), (kr, H, dv), 1),
              "wo": (("mlp", "fsdp"), (H * dv, cfg.d_model), 0)}
    for name, (axes, shape, dim) in leaves.items():
        if model_split(axes, shape) != (dim, n):
            raise ValueError(f"mla: {name} {shape} does not split with its {H} heads ({n} ways "
                             f"over model = {model_size()})")
    return n


def mla_apply(
    p: MLA,
    x: torch.Tensor,  # (B, S, d)
    cfg: ModelConfig,
    *,
    positions: torch.Tensor,
    causal: bool = True,
    cache: Optional[KVCache] = None,
    cache_len: Optional[int] = None,
    ctx_parallel: bool = False,
):
    """Returns (out (B,S,d), new_cache). Under a ``model`` axis that splits
    the heads, each position computes its own (:func:`_mla_heads`), the
    context-parallel decode over sequence tiles excepted: there ``wuq`` and
    ``wo`` run through ``dense_tp`` (column- and row-parallel) and every
    sequence tile rebuilds all heads' keys and values from its slice of the
    latent, with ``wuk`` and ``wuv`` gathered whole onto it where they are
    split (:func:`_on`)."""
    B, S, d = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    scale = 1.0 / math.sqrt(dn + dr)
    seq_tiles = (ctx_parallel and cache is not None and isinstance(cache.k, Placed)
                 and cache.k.sharding.splits(cache.k.ndim)[1] > 1)
    n = mla_heads_split(cfg) if model_size() > 1 and not seq_tiles else 1

    cq = norm_apply(p.q_norm, dense_apply(p.wdq, x, cfg), cfg)
    sin, cos = rope_sin_cos(positions, dr, cfg.rope_theta)
    ckv = norm_apply(p.kv_norm, dense_apply(p.wdkv, x, cfg), cfg)  # (B,S,kr)
    k_rope = dense_apply(p.wkr, x, cfg)[:, :, None, :]  # (B,S,1,dr)
    k_rope = apply_rope(k_rope, sin[None], cos[None])[:, :, 0]  # (B,S,dr)
    if n > 1:
        return _mla_heads(p, cfg, cq, ckv, k_rope, sin, cos, cache, cache_len, causal, n)

    # over sequence tiles, as gqa_apply: wuq column-parallel and wo row-parallel where the
    # rules split the heads; each tile rebuilds every head's K/V with wuk and wuv whole
    def dense(d: Dense, x_, in_axis, out_axes):
        return dense_tp(d, x_, cfg, in_axis, out_axes) if seq_tiles else dense_apply(d, x_, cfg)

    q = dense(p.wuq, cq, "fsdp", ("heads", "head_dim"))  # (B,S,H,dn+dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, sin[None], cos[None])

    def rebuild(c, r):
        """Each head's keys and values from the latent ``c`` and rope key
        ``r`` (B, T, ·), on their device (with ``wuk`` and ``wuv`` whole
        there: gathered where the serving layout split them)."""
        k_nope = dense_apply(_on(p.wuk, c.device), c, cfg)  # (B,T,H,dn)
        vv = dense_apply(_on(p.wuv, c.device), c, cfg)  # (B,T,H,dv)
        rope = r[:, :, None, :].to(k_nope.dtype).expand(*c.shape[:2], H, dr)
        return torch.cat([k_nope, rope], dim=-1), vv

    q_full = torch.cat([q_nope, q_rope], dim=-1).reshape(B, S, H, 1, dn + dr)
    new_cache = None
    if cache is not None:
        cache_len = int(cache_len)
        ck = _cache_write(cache.k, ckv, cache_len, ctx_parallel)
        cr = _cache_write(cache.v, k_rope, cache_len, ctx_parallel)
        new_cache = KVCache(ck, cr)
        T = ck.shape[1]
        valid = (torch.arange(T, device=x.device) <= cache_len).expand(B, T)
        if isinstance(ck, Placed):  # sequence tiles: rebuild K/V and attend tile by tile
            out = _attend_decode_tiles(q_full, ck, cr, scale=scale, valid=valid, kv=rebuild)
        else:
            out = _attend_decode(q_full, *rebuild(ck, cr), scale=scale, valid=valid)
    else:
        out = _attend_chunked(q_full, *rebuild(ckv, k_rope), causal=causal, window=None,
                              scale=scale, p_dtype=cdtype(cfg))

    out = shard(out.reshape(B, S, H * dv).to(cdtype(cfg)), ("batch", "seq", "mlp"))
    return dense(p.wo, out, "mlp", ("fsdp",)), new_cache


def _mla_heads(p: MLA, cfg: ModelConfig, cq, ckv, k_rope, sin, cos, cache, cache_len, causal,
               n: int):
    """:func:`mla_apply` with the heads over ``model``: the latents ``cq``
    and ``ckv`` and the shared rope key come whole from the data shard's
    first position; model position m projects its heads' queries
    (``wuq``), rebuilds its heads' keys and values from the latent
    (``wuk``, ``wuv``), attends (in decode against its own replica of the
    latent cache, after writing this step's row into it) and multiplies its
    rows of ``wo``; one sum. A decode cache must be laid by
    ``lm.init_cache`` under the same rules (a replica per position)."""
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    h_loc = H // n
    scale = 1.0 / math.sqrt(dn + dr)
    heads = ("heads", "head_dim")
    if cache is not None:
        if not isinstance(cache.k, Placed):
            raise ValueError("mla: a decode cache under a model axis that splits the heads must "
                             "be laid by lm.init_cache under the same rules (a replica per "
                             "position)")
        cache_len = int(cache_len)
    rows_of = {tuple(c.items()): r for c, r in batch_shards(cq.shape)}

    def one(m, cq_rows, coords):
        dev = cq_rows.device
        rows = rows_of[tuple(coords.items())]
        c_new, r_new = ckv[rows].to(dev), k_rope[rows].to(dev)
        q = dense_apply(dense_tile(p.wuq, "fsdp", heads, m, coords), cq_rows, cfg)
        q_rope = apply_rope(q[..., dn:], sin.to(dev)[None], cos.to(dev)[None])
        B, S = q.shape[:2]
        q_full = torch.cat([q[..., :dn], q_rope], dim=-1).reshape(B, S, h_loc, 1, dn + dr)
        if cache is not None:
            pos = model_positions(coords)[m]
            c_all = _cache_write(cache.k.tiles[pos], c_new, cache_len)
            r_all = _cache_write(cache.v.tiles[pos], r_new, cache_len)
        else:
            c_all, r_all = c_new, r_new
        k_nope = dense_apply(dense_tile(p.wuk, "fsdp", heads, m, coords), c_all, cfg)
        vv = dense_apply(dense_tile(p.wuv, "fsdp", heads, m, coords), c_all, cfg)
        rope = r_all[:, :, None, :].to(k_nope.dtype).expand(*c_all.shape[:2], h_loc, dr)
        k = torch.cat([k_nope, rope], dim=-1)
        if cache is not None:
            T = c_all.shape[1]
            valid = (torch.arange(T, device=dev) <= cache_len).expand(B, T)
            out = _attend_decode(q_full, k, vv, scale=scale, valid=valid)
        else:
            out = _attend_chunked(q_full, k, vv, causal=causal, window=None, scale=scale,
                                  p_dtype=cdtype(cfg))
        out = out.reshape(B, S, h_loc * dv).to(cdtype(cfg))
        return dense_apply(dense_tile(p.wo, "mlp", ("fsdp",), m, coords), out, cfg)

    return model_parts(cq, one, n), cache
