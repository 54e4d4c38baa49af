"""State-space / RNN mixers: Mamba-1 (Jamba) and RWKV-6 (Finch).

The counterpart of ``repro._unused.models.ssm``, in plain PyTorch. Both run
in chunked form in prefill and as an O(1)-state recurrence in decode:

* Mamba-1: the selective scan ``h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t x_t``,
  a loop over chunks of ``MAMBA_CHUNK`` steps. Inside a chunk the
  first-order recurrence runs as a log-depth (Hillis–Steele) scan, where the
  reference runs ``lax.associative_scan``: the same products in another
  association order, so the two agree to float32 roundoff (the tests hold
  them at 1e-5).
* RWKV-6: the per-head state ``S_t = diag(w_t) S_{t-1} + k_t v_tᵀ`` with a
  data-dependent decay ``w_t``, a loop over chunks of ``RWKV_CHUNK`` steps;
  inside a chunk the pairwise decay ratios ``exp(L_{i-1} − L_j)`` (j < i)
  form the intra-chunk attention, and the chunk boundary carries the dense
  state.

One deliberate difference from the reference: its chunked WKV takes
``exp(L_{i-1} − L_j)`` for every (i, j) and masks the upper triangle after
the product. Above the diagonal that exponent is ≥ 0, and once a channel's
log-decay over a chunk passes about 88 it overflows to inf and the masked
product to NaN. The port masks the exponent to −inf above and on the
diagonal before ``exp``, which gives the reference's values wherever the
reference is finite and stays finite where it is not.

Decode caches: Mamba (the last ``d_conv − 1`` conv inputs in the cache
dtype, ``h`` float32); RWKV (the token-shift inputs ``x_tm`` and ``x_cm``,
the state ``s`` float32). The caches are replaced, not written in place,
except for the tiles below.

Tensor parallelism (a rule context whose ``model`` axis splits the layer,
the reference's sharding of ``mamba_axes`` and ``rwkv_axes``):

* Mamba splits ``d_inner`` over ``mlp`` (:func:`mamba_split`). Model
  position m takes its di/M columns of **each** half of ``in_proj`` (x's
  and the gate z's: ``in_proj`` is (d, 2·di), and the rules' contiguous
  split would give the first half's columns only to the first half of the
  positions), runs the causal conv, ``x_proj`` on its rows: the first pass.
  The partials of ``x_proj``'s (B, S, dt_rank + 2N) output are summed once
  and every position reads the sum: its ``dt_proj`` columns, ``dt_bias``,
  ``A_log``, ``D``, the scan on its channels (per channel, so it splits
  exactly), the gate, its rows of ``out_proj``; one more sum
  (``sharding.place.model_parts`` with ``then``). In decode each position's ``conv``
  and ``h`` are its ``mlp`` tiles of the cache, written in place.
* RWKV-6's time mix splits its heads (:func:`rwkv_heads_split`), and only
  where the rules split the heads: the token shift, the ``mu`` mixes and
  the decay LoRA (whole leaves) run once on the data shard's first
  position; each position projects r, k, v on its heads and the gate on
  the same channels, runs the WKV on its heads with its ``u`` and
  groupnorm, multiplies its rows of ``wo``; one sum. In decode each
  position's ``s`` is its ``heads`` tile of the cache, written in place;
  ``x_tm`` stays whole.

Where the rules leave ``d_inner`` or the heads whole, the mixer computes
the whole layer on the data shard's first position, as on one device. A
split whose leaves would not align (another rule set splitting the gate
or one half differently from the heads or channels) raises
``ValueError``; nothing falls back.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.place import Placed, model_parts, model_tile
from repro_torch.sharding.rules import batch_shards, model_positions, model_size, model_split
from .layers import (Dense, DenseTile, _const, cdtype, dense_apply, dense_axes, dense_init,
                     dense_tile, pdtype)

__all__ = [
    "Mamba", "mamba_init", "mamba_axes", "mamba_apply", "mamba_split", "MambaCache",
    "RWKV", "rwkv_init", "rwkv_axes", "rwkv_apply", "rwkv_heads_split", "RwkvCache",
]

MAMBA_CHUNK = 64
RWKV_CHUNK = 32


class MambaCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, di) recent pre-conv inputs
    h: torch.Tensor  # (B, di, N) SSM state


class RwkvCache(NamedTuple):
    x_tm: torch.Tensor  # (B, 1, d) last input seen by time-mix
    x_cm: torch.Tensor  # (B, 1, d) last input seen by channel-mix
    s: torch.Tensor  # (B, H, dk, dv) wkv state


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


# =====================================================================================
# Mamba-1
# =====================================================================================
class Mamba(nn.Module):
    """``in_proj`` (d, 2·di), ``conv_w`` (dc, di), ``conv_b`` (di), ``x_proj``
    (di, dt_rank + 2N), ``dt_proj`` (dt_rank, di; no bias), ``dt_bias`` (di),
    ``A_log`` (di, N), ``D`` (di) and ``out_proj`` (di, d)."""

    def __init__(self, in_proj: Dense, conv_w, conv_b, x_proj: Dense, dt_proj: Dense, dt_bias,
                 A_log, D, out_proj: Dense):
        super().__init__()
        self.in_proj, self.conv_w, self.conv_b = in_proj, conv_w, conv_b
        self.x_proj, self.dt_proj, self.dt_bias = x_proj, dt_proj, dt_bias
        self.A_log, self.D, self.out_proj = A_log, D, out_proj


def mamba_init(cfg: ModelConfig, *, gen=None, device=None) -> Mamba:
    """The reference's recipe: ``conv_w`` ~ N(0, 1)/√dc, ``conv_b`` 0, ``dt``
    log-uniform in [1e-3, 0.1] stored as ``dt_bias`` = softplus⁻¹(dt),
    ``A_log`` = log(1..N) on every channel, ``D`` 1."""
    d, di, N, dr, dc = (cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank,
                        cfg.mamba_d_conv)
    kw = dict(gen=gen, device=device)
    dtype = pdtype(cfg)
    conv_w = torch.empty((dc, di), dtype=dtype, device=device)
    dt_bias = torch.empty((di,), dtype=dtype, device=device)
    A_log = torch.empty((di, N), dtype=dtype, device=device)
    if conv_w.device.type != "meta":
        conv_w.normal_(generator=gen).div_(math.sqrt(dc))
        u = torch.rand((di,), generator=gen, dtype=torch.float32, device=device)
        dt = torch.exp(u * (np.log(0.1) - np.log(0.001)) + np.log(0.001))
        dt_bias.copy_(torch.log(torch.expm1(dt)))
        A_log.copy_(torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device))
                    .expand(di, N))
    return Mamba(
        dense_init(d, (2 * di,), cfg, **kw),
        _param(conv_w),
        _const((di,), cfg, device, 0.0),
        dense_init(di, (dr + 2 * N,), cfg, **kw),
        dense_init(dr, (di,), cfg, **kw),
        _param(dt_bias),
        _param(A_log),
        _const((di,), cfg, device, 1.0),
        dense_init(di, (d,), cfg, **kw),
    )


def mamba_axes(cfg: ModelConfig) -> dict:
    return {
        "in_proj": dense_axes("fsdp", ("mlp",)),
        "conv_w": ("conv", "mlp"),
        "conv_b": ("mlp",),
        "x_proj": dense_axes("mlp", (None,)),
        "dt_proj": dense_axes(None, ("mlp",)),
        "dt_bias": ("mlp",),
        "A_log": ("mlp", "state"),
        "D": ("mlp",),
        "out_proj": dense_axes("mlp", ("fsdp",)),
    }


def _first_order_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of ``h_t = a_t h_{t-1} + b_t`` along dim 1 from
    h = 0: (A_t = a_t ⋯ a_0, B_t = h_t), in log2(n) Hillis–Steele steps
    (the reference's ``associative_scan`` combine, another association)."""
    n, off = a.shape[1], 1
    while off < n:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return a, b


def _mamba_scan_chunked(dt, A, Bc, Cc, xm, h0, chunk: int):
    """The selective scan: h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,
    y_t = h_t · C_t; the (B, S, di, N) state sequence is formed one chunk at
    a time.

    dt/xm: (B,S,di); Bc/Cc: (B,S,N); A: (di,N); h0: (B,di,N) f32.
    Returns (y (B,S,di) f32, h_last).
    """
    B, S, di = dt.shape
    pad = (-S) % chunk
    if pad:
        dt, xm, Bc, Cc = (F.pad(a, (0, 0, 0, pad)) for a in (dt, xm, Bc, Cc))
    h, ys = h0, []
    for c0 in range(0, S + pad, chunk):
        dt_i, xm_i, B_i, C_i = (a[:, c0:c0 + chunk] for a in (dt, xm, Bc, Cc))
        decay = torch.exp(dt_i[..., None] * A[None, None])  # (B,chunk,di,N)
        inc = (dt_i * xm_i)[..., None] * B_i[:, :, None, :]
        Acum, Bcum = _first_order_scan(decay, inc)
        h_seq = Acum * h[:, None] + Bcum
        ys.append(torch.einsum("bcdn,bcn->bcd", h_seq, C_i))
        h = h_seq[:, -1]
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_split(cfg: ModelConfig) -> int:
    """Over how many model positions the active rules split Mamba's
    ``d_inner`` (1: the whole layer on the first position). Every leaf
    that names ``mlp`` must split along it the same number of ways, else
    ``ValueError``."""
    di = cfg.mamba_d_inner
    n = model_split(("mlp",), (di,))[1]
    if n == 1:
        return 1
    d, N, dr, dc = cfg.d_model, cfg.mamba_d_state, cfg.dt_rank, cfg.mamba_d_conv
    leaves = {"in_proj": (("fsdp", None, "mlp"), (d, 2, di), 2),  # lm.in_proj_layout's view
              "conv_w": (("conv", "mlp"), (dc, di), 1),
              "x_proj": (("mlp", None), (di, dr + 2 * N), 0),
              "dt_proj": ((None, "mlp"), (dr, di), 1),
              "A_log": (("mlp", "state"), (di, N), 0),
              "out_proj": (("mlp", "fsdp"), (di, d), 0)}
    for name, (axes, shape, dim) in leaves.items():
        if model_split(axes, shape) != (dim, n):
            raise ValueError(f"mamba: {name} {shape} does not split over d_inner = {di} as its "
                             f"channels do ({n} ways) over model = {model_size()}")
    return n


def _in_proj_halves(w, m: int, n: int, di: int, coords, dev):
    """Model position m's columns [m·di/n, (m+1)·di/n) of each half of
    ``in_proj`` (x's, then the gate z's), on ``dev``. The layouts over a
    mesh (``lm.in_proj_layout``) lay ``in_proj`` as a (d, 2, di) view split
    along its last axis, so the halves are views of the position's tile; a
    plain (d, 2·di) tensor is sliced."""
    if isinstance(w, Placed):
        t = w.model_tile(model_positions(coords)[m])
        return t[:, 0], t[:, 1]
    c = di // n
    return [w[:, half * di + m * c:half * di + (m + 1) * c].to(dev) for half in (0, 1)]


def _conv_silu(xm, conv_w, conv_b, cache_conv, dtype):
    """The causal depthwise conv and its SiLU: (activation, the new conv
    history or ``None`` in prefill). A tap loop in prefill, an einsum over
    the history in decode."""
    S, dc = xm.shape[1], conv_w.shape[0]
    conv_w = conv_w.to(dtype)
    if cache_conv is None:
        acc = torch.zeros_like(xm)
        for t in range(dc):
            xs = F.pad(xm, (0, 0, dc - 1 - t, 0))[:, :S]
            acc = acc + xs * conv_w[t]
        new_conv = None
    else:
        hist = torch.cat([cache_conv.to(dtype), xm], dim=1)  # (B, dc, di)
        acc = torch.einsum("btd,td->bd", hist, conv_w)[:, None, :]
        new_conv = hist[:, 1:].to(cache_conv.dtype)
    return F.silu(acc + conv_b.to(dtype)), new_conv


def _ssm_out(xm, z, proj, dt_proj, dt_bias, A_log, D, out_proj, h_prev, cfg):
    """From the conv's activation ``xm`` (B, S, c), the gate ``z`` and
    ``x_proj``'s output ``proj`` (B, S, dt_rank + 2N): Δ, the scan over the
    c channels (``h_prev`` None: prefill from zero; else one decode step
    from it), the skip, the gate and ``out_proj`` → (output, new h or
    None)."""
    dr, N, dtype = cfg.dt_rank, cfg.mamba_d_state, cdtype(cfg)
    dt_low, Bc, Cc = proj.split([dr, N, N], dim=-1)
    dt = F.softplus(dense_apply(dt_proj, dt_low, cfg) + dt_bias.to(dtype)).float()
    A = -torch.exp(A_log.float())  # (c,N)
    if h_prev is None:
        h0 = torch.zeros((xm.shape[0], xm.shape[2], N), dtype=torch.float32, device=xm.device)
        y, _ = _mamba_scan_chunked(dt, A, Bc.float(), Cc.float(), xm.float(), h0, MAMBA_CHUNK)
        h = None
    else:
        decay = torch.exp(dt[:, 0, :, None] * A[None])  # (B,c,N)
        inc = (dt[:, 0] * xm[:, 0].float())[..., None] * Bc.float()[:, 0, None, :]
        h = h_prev.float() * decay + inc
        y = torch.einsum("bdn,bn->bd", h, Cc.float()[:, 0])[:, None]
    y = y.to(dtype) + D.to(dtype) * xm
    y = y * F.silu(z)
    return dense_apply(out_proj, y, cfg), h


def mamba_apply(p: Mamba, x: torch.Tensor, cfg: ModelConfig, *, cache: MambaCache | None = None):
    """x (B, S, d) → (B, S, d). With ``cache`` (decode) S must be 1. Under
    a ``model`` axis that splits ``d_inner``: :func:`_mamba_tp`."""
    n = mamba_split(cfg) if model_size() > 1 else 1
    if n > 1:
        return _mamba_tp(p, x, cfg, cache, n)
    # (B,S,di) each; a weight in lm.in_proj_layout's (d, 2, di) gives (B,S,2,di)
    xm, z = dense_apply(p.in_proj, x, cfg).flatten(2).chunk(2, dim=-1)
    xm, new_conv = _conv_silu(xm, p.conv_w, p.conv_b, None if cache is None else cache.conv,
                              cdtype(cfg))
    out, h = _ssm_out(xm, z, dense_apply(p.x_proj, xm, cfg), p.dt_proj, p.dt_bias, p.A_log,
                      p.D, p.out_proj, None if cache is None else cache.h, cfg)
    new_cache = None if cache is None else MambaCache(new_conv, h.to(cache.h.dtype))
    return out, new_cache


def _mamba_tp(p: Mamba, x: torch.Tensor, cfg: ModelConfig, cache: MambaCache | None, n: int):
    """:func:`mamba_apply` with ``d_inner`` over ``mlp``, in two passes
    (``model_parts`` with ``then``): each position's conv and ``x_proj`` partial, one
    sum, then its scan and ``out_proj`` partial, one more sum. A decode
    cache must be laid by ``lm.init_cache`` under the same rules (its
    ``mlp`` tiles, written in place)."""
    di, dtype = cfg.mamba_d_inner, cdtype(cfg)
    if cache is not None and not isinstance(cache.h, Placed):
        raise ValueError("mamba: a decode cache under a model axis that splits d_inner must "
                         "be laid by lm.init_cache under the same rules (mlp tiles)")
    mlp = ("mlp",)

    def first(m, xm_rows, coords):
        dev = xm_rows.device
        pos = model_positions(coords)[m]
        w_x, w_z = _in_proj_halves(p.in_proj.w, m, n, di, coords, dev)
        xm = dense_apply(DenseTile(w_x), xm_rows, cfg)  # (B,S,di/n)
        z = dense_apply(DenseTile(w_z), xm_rows, cfg)
        conv = None if cache is None else cache.conv.tiles[pos]
        xm, new_conv = _conv_silu(xm, model_tile(p.conv_w, ("conv", "mlp"), m, coords),
                                  model_tile(p.conv_b, mlp, m, coords), conv, dtype)
        if new_conv is not None:
            conv.copy_(new_conv)
        proj = dense_apply(dense_tile(p.x_proj, "mlp", (None,), m, coords), xm, cfg)
        return proj, (xm, z)

    def second(m, kept, proj, coords):
        xm, z = kept
        pos = model_positions(coords)[m]
        h_prev = None if cache is None else cache.h.tiles[pos]
        out, h = _ssm_out(xm, z, proj, dense_tile(p.dt_proj, None, mlp, m, coords),
                          model_tile(p.dt_bias, mlp, m, coords),
                          model_tile(p.A_log, ("mlp", "state"), m, coords),
                          model_tile(p.D, mlp, m, coords),
                          dense_tile(p.out_proj, "mlp", ("fsdp",), m, coords), h_prev, cfg)
        if h is not None:
            h_prev.copy_(h)
        return out

    return model_parts(x, first, n, then=second), cache


# =====================================================================================
# RWKV-6
# =====================================================================================
class RWKV(nn.Module):
    """``mu`` (5, d; the token-shift mixes of r, k, v, w, g), ``wr``/``wk``/
    ``wv`` (d, H, dh), ``wg`` (d, d), ``w0`` (d; the base log-log decay),
    ``w_lora_a`` (d, decay_lora), ``w_lora_b`` (decay_lora, d), ``u`` (H, dh;
    the bonus), ``ln_scale``/``ln_bias`` (H, dh; the per-head groupnorm) and
    ``wo`` (d, d)."""

    def __init__(self, mu, wr: Dense, wk: Dense, wv: Dense, wg: Dense, w0, w_lora_a: Dense,
                 w_lora_b: Dense, u, ln_scale, ln_bias, wo: Dense):
        super().__init__()
        self.mu, self.wr, self.wk, self.wv, self.wg = mu, wr, wk, wv, wg
        self.w0, self.w_lora_a, self.w_lora_b = w0, w_lora_a, w_lora_b
        self.u, self.ln_scale, self.ln_bias, self.wo = u, ln_scale, ln_bias, wo


def rwkv_init(cfg: ModelConfig, *, gen=None, device=None) -> RWKV:
    """The reference's recipe: ``mu`` 0.5, ``w0`` −6, ``u`` 0, the groupnorm
    1 and 0, ``w_lora_b`` at scale 0.01; the projections N(0, 1/in)."""
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    H = d // dh
    kw = dict(gen=gen, device=device)
    return RWKV(
        _const((5, d), cfg, device, 0.5),
        dense_init(d, (H, dh), cfg, **kw),
        dense_init(d, (H, dh), cfg, **kw),
        dense_init(d, (H, dh), cfg, **kw),
        dense_init(d, (d,), cfg, **kw),
        _const((d,), cfg, device, -6.0),
        dense_init(d, (cfg.rwkv_decay_lora,), cfg, **kw),
        dense_init(cfg.rwkv_decay_lora, (d,), cfg, scale=0.01, **kw),
        _const((H, dh), cfg, device, 0.0),
        _const((H, dh), cfg, device, 1.0),
        _const((H, dh), cfg, device, 0.0),
        dense_init(d, (d,), cfg, **kw),
    )


def rwkv_axes(cfg: ModelConfig) -> dict:
    return {
        "mu": (None, "embed"),
        "wr": dense_axes("fsdp", ("heads", "head_dim")),
        "wk": dense_axes("fsdp", ("heads", "head_dim")),
        "wv": dense_axes("fsdp", ("heads", "head_dim")),
        "wg": dense_axes("fsdp", ("mlp",)),
        "w0": ("embed",),
        "w_lora_a": dense_axes("fsdp", (None,)),
        "w_lora_b": dense_axes(None, ("embed",)),
        "u": ("heads", "head_dim"),
        "ln_scale": ("heads", "head_dim"),
        "ln_bias": ("heads", "head_dim"),
        "wo": dense_axes("mlp", ("fsdp",)),
    }


def _rwkv_chunked(r, k, v, logw, u, s0, chunk: int):
    """Chunked WKV. r/k/v/logw: (B, H, S, dh); u: (H, dh); s0: (B,H,dh,dh).

    Returns (out (B,H,S,dh), s_last). All math f32. Padding with logw = 0
    (w = 1) is harmless: a padded k = 0 adds nothing.
    """
    B, H, S, dh = r.shape
    pad = (-S) % chunk
    if pad:
        r, k, v, logw = (F.pad(a, (0, 0, 0, pad)) for a in (r, k, v, logw))
    # strictly lower: j < i
    below = torch.ones((chunk, chunk), dtype=torch.bool, device=r.device).tril(-1)
    s, outs = s0, []
    for c0 in range(0, S + pad, chunk):
        ri, ki, vi, lwi = (a[:, :, c0:c0 + chunk] for a in (r, k, v, logw))  # (B,H,C,dh)
        L = torch.cumsum(lwi, dim=2)  # inclusive log-decay products
        Lm1 = L - lwi  # L_{i-1}
        # intra-chunk: ratio_{ijd} = exp(L_{i-1,d} − L_{j,d}) for j < i; the exponent is
        # masked to −inf on and above the diagonal before exp (there it is ≥ 0)
        expo = Lm1[:, :, :, None, :] - L[:, :, None, :, :]  # (B,H,C,C,dh)
        ratio = torch.exp(expo.masked_fill(~below[:, :, None], float("-inf")))
        A = torch.einsum("bhid,bhijd,bhjd->bhij", ri, ratio, ki)
        diag = (ri * ki * u[None, :, None, :]).sum(-1)  # (B,H,C) bonus term
        out = torch.einsum("bhij,bhjd->bhid", A, vi) + diag[..., None] * vi
        # inter-chunk: contribution of the carried state
        out = out + torch.einsum("bhid,bhde->bhie", ri * torch.exp(Lm1), s)
        # state update
        kd = ki * torch.exp(L[:, :, -1:, :] - L)  # decay from j to the chunk's end
        s = s * torch.exp(L[:, :, -1])[..., None] + torch.einsum("bhjd,bhje->bhde", kd, vi)
        outs.append(out)
    return torch.cat(outs, dim=2)[:, :, :S], s


def rwkv_heads_split(cfg: ModelConfig) -> int:
    """Over how many model positions the active rules split RWKV-6's time
    mix: the number of ways they split its heads (``wr``'s ``heads`` axis),
    1 where the heads stay whole (then the whole layer runs on the first
    position, whatever the gate's ``mlp`` axis would allow). The gate's
    columns, ``wo``'s rows and the per-head leaves must split with the
    heads, else ``ValueError``."""
    d, dh = cfg.d_model, cfg.rwkv_head_dim
    H = d // dh
    n = model_split(("fsdp", "heads", "head_dim"), (d, H, dh))[1]
    if n == 1:
        return 1
    leaves = {"wg": (("fsdp", "mlp"), (d, d), 1), "wo": (("mlp", "fsdp"), (d, d), 0),
              "u": (("heads", "head_dim"), (H, dh), 0)}
    for name, (axes, shape, dim) in leaves.items():
        if model_split(axes, shape) != (dim, n):
            raise ValueError(f"rwkv6 time mix: {name} {shape} does not split with its {H} heads "
                             f"({n} ways over model = {model_size()})")
    return n


def _rwkv_mix(p: RWKV, x: torch.Tensor, cfg: ModelConfig, cache: RwkvCache | None):
    """The token shift, the five ``mu`` mixes and the data-dependent decay
    ``log w`` (B, S, d) float32: w = exp(-exp(w0 + lora(xw)))."""
    S = x.shape[1]
    x_prev = F.pad(x, (0, 0, 1, 0))[:, :S] if cache is None else cache.x_tm.to(x.dtype)
    mu = p.mu.to(cdtype(cfg))
    xr, xk, xv, xw, xg = (x * mu[i] + x_prev * (1 - mu[i]) for i in range(5))
    lora = dense_apply(p.w_lora_b, torch.tanh(dense_apply(p.w_lora_a, xw, cfg)), cfg)
    return xr, xk, xv, xg, -torch.exp(p.w0.float() + lora.float())  # log w ≤ 0


def _rwkv_heads(wr, wk, wv, wg, u, ln_scale, ln_bias, wo, xr, xk, xv, xg, logw, s_prev, cfg):
    """The time mix on a group of h heads: r, k, v (d, h, dh) and the gate
    wg (d, h·dh) projected, the WKV from zero (``s_prev`` None, prefill) or
    one step from ``s_prev`` (B, h, dh, dh), the per-head groupnorm, the
    gate and ``wo`` (h·dh, d) → (output, the new state or None)."""
    B, S, _ = xr.shape
    r = dense_apply(wr, xr, cfg).transpose(1, 2)  # (B,h,S,dh)
    k = dense_apply(wk, xk, cfg).transpose(1, 2)
    v = dense_apply(wv, xv, cfg).transpose(1, 2)
    g = F.silu(dense_apply(wg, xg, cfg))
    h, dh = r.shape[1], r.shape[3]
    logw = logw.reshape(B, S, h, dh).transpose(1, 2)
    rf, kf, vf = (a.float() for a in (r, k, v))
    u = u.float()
    if s_prev is None:
        s0 = torch.zeros((B, h, dh, dh), dtype=torch.float32, device=xr.device)
        out, _ = _rwkv_chunked(rf, kf, vf, logw, u, s0, RWKV_CHUNK)
        s_new = None
    else:
        s = s_prev.float()
        ri, ki, vi = rf[:, :, 0], kf[:, :, 0], vf[:, :, 0]  # (B,h,dh)
        kv = torch.einsum("bhd,bhe->bhde", ki, vi)
        out = torch.einsum("bhd,bhde->bhe", ri, s + u[None, :, :, None] * kv)
        s_new = s * torch.exp(logw[:, :, 0])[..., None] + kv
        out = out[:, :, None]  # (B,h,1,dh)

    # per-head groupnorm, gate, output proj
    o = out.transpose(1, 2)  # (B,S,h,dh)
    mean = o.mean(-1, keepdim=True)
    var = ((o - mean) ** 2).mean(-1, keepdim=True)
    o = (o - mean) * torch.rsqrt(var + 64e-5)
    o = o * ln_scale.float() + ln_bias.float()
    o = o.reshape(B, S, h * dh).to(cdtype(cfg)) * g
    return dense_apply(wo, o, cfg), s_new


def rwkv_apply(p: RWKV, x: torch.Tensor, cfg: ModelConfig, *, cache: RwkvCache | None = None):
    """RWKV-6 time mixing. x (B,S,d) → (B,S,d). Decode writes x into
    ``x_tm``; the block writes ``x_cm``. Under a ``model`` axis that splits
    the heads: :func:`_rwkv_tp`."""
    n = rwkv_heads_split(cfg) if model_size() > 1 else 1
    xr, xk, xv, xg, logw = _rwkv_mix(p, x, cfg, cache)
    if n > 1:
        out = _rwkv_tp(p, cfg, cache, n, xr, xk, xv, xg, logw)
        s = None if cache is None else cache.s
    else:
        out, s = _rwkv_heads(p.wr, p.wk, p.wv, p.wg, p.u, p.ln_scale, p.ln_bias, p.wo, xr, xk,
                             xv, xg, logw, None if cache is None else cache.s, cfg)
        s = None if cache is None else s.to(cache.s.dtype)
    if cache is None:
        return out, None
    return out, RwkvCache(x.to(cache.x_tm.dtype), cache.x_cm, s)


def _rwkv_tp(p: RWKV, cfg: ModelConfig, cache: RwkvCache | None, n: int, xr, xk, xv, xg, logw):
    """The time mix with the heads over ``model``: each position's heads of
    r, k, v, its channels of the gate and of ``log w``, its WKV, ``u`` and
    groupnorm, and its rows of ``wo``; one sum. A decode cache must be laid
    by ``lm.init_cache`` under the same rules (``s`` as ``heads`` tiles,
    written in place)."""
    if cache is not None and not isinstance(cache.s, Placed):
        raise ValueError("rwkv6 time mix: a decode cache under a model axis that splits the "
                         "heads must be laid by lm.init_cache under the same rules (heads tiles)")
    c = cfg.d_model // n  # each position's channels: its heads × head_dim
    rows_of = {tuple(k.items()): r for k, r in batch_shards(xr.shape)}
    heads = ("heads", "head_dim")

    def one(m, xr_rows, coords):
        dev = xr_rows.device
        rows = rows_of[tuple(coords.items())]
        xk_, xv_, xg_ = (a[rows].to(dev) for a in (xk, xv, xg))
        lw = logw[rows][..., m * c:(m + 1) * c].to(dev)
        s_tile = None if cache is None else cache.s.tiles[model_positions(coords)[m]]
        out, s_new = _rwkv_heads(
            *(dense_tile(w, "fsdp", heads, m, coords) for w in (p.wr, p.wk, p.wv)),
            dense_tile(p.wg, "fsdp", ("mlp",), m, coords),
            *(model_tile(w, heads, m, coords) for w in (p.u, p.ln_scale, p.ln_bias)),
            dense_tile(p.wo, "mlp", ("fsdp",), m, coords), xr_rows, xk_, xv_, xg_, lw, s_tile,
            cfg)
        if s_new is not None:
            s_tile.copy_(s_new)
        return out

    return model_parts(xr, one, n)
