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
the state ``s`` float32). The caches are replaced, not written in place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from .layers import Dense, _const, cdtype, dense_apply, dense_axes, dense_init, pdtype

__all__ = [
    "Mamba", "mamba_init", "mamba_axes", "mamba_apply", "MambaCache",
    "RWKV", "rwkv_init", "rwkv_axes", "rwkv_apply", "RwkvCache",
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


def mamba_apply(p: Mamba, x: torch.Tensor, cfg: ModelConfig, *, cache: MambaCache | None = None):
    """x (B, S, d) → (B, S, d). With ``cache`` (decode) S must be 1."""
    B, S, d = x.shape
    di, N, dr, dc = cfg.mamba_d_inner, cfg.mamba_d_state, cfg.dt_rank, cfg.mamba_d_conv
    dtype = cdtype(cfg)

    xm, z = dense_apply(p.in_proj, x, cfg).chunk(2, dim=-1)  # (B,S,di) each

    # causal depthwise conv: a tap loop in prefill, an einsum over the history in decode
    conv_w = p.conv_w.to(dtype)
    if cache is None:
        acc = torch.zeros_like(xm)
        for t in range(dc):
            xs = F.pad(xm, (0, 0, dc - 1 - t, 0))[:, :S]
            acc = acc + xs * conv_w[t]
        new_conv = None
    else:
        hist = torch.cat([cache.conv.to(dtype), xm], dim=1)  # (B, dc, di)
        acc = torch.einsum("btd,td->bd", hist, conv_w)[:, None, :]
        new_conv = hist[:, 1:].to(cache.conv.dtype)
    xm = F.silu(acc + p.conv_b.to(dtype))

    dt_low, Bc, Cc = dense_apply(p.x_proj, xm, cfg).split([dr, N, N], dim=-1)
    dt = F.softplus(dense_apply(p.dt_proj, dt_low, cfg) + p.dt_bias.to(dtype)).float()
    A = -torch.exp(p.A_log.float())  # (di,N)

    if cache is None:
        h0 = torch.zeros((B, di, N), dtype=torch.float32, device=x.device)
        y, _ = _mamba_scan_chunked(dt, A, Bc.float(), Cc.float(), xm.float(), h0, MAMBA_CHUNK)
        new_cache = None
    else:
        decay = torch.exp(dt[:, 0, :, None] * A[None])  # (B,di,N)
        inc = (dt[:, 0] * xm[:, 0].float())[..., None] * Bc.float()[:, 0, None, :]
        h = cache.h.float() * decay + inc
        y = torch.einsum("bdn,bn->bd", h, Cc.float()[:, 0])[:, None]
        new_cache = MambaCache(new_conv, h.to(cache.h.dtype))

    y = y.to(dtype) + p.D.to(dtype) * xm
    y = y * F.silu(z)
    return dense_apply(p.out_proj, y, cfg), new_cache


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


def rwkv_apply(p: RWKV, x: torch.Tensor, cfg: ModelConfig, *, cache: RwkvCache | None = None):
    """RWKV-6 time mixing. x (B,S,d) → (B,S,d). Decode writes x into
    ``x_tm``; the block writes ``x_cm``."""
    B, S, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    dtype = cdtype(cfg)

    if cache is None:
        x_prev = F.pad(x, (0, 0, 1, 0))[:, :S]
    else:
        x_prev = cache.x_tm.to(x.dtype)
    mu = p.mu.to(dtype)
    xr, xk, xv, xw, xg = (x * mu[i] + x_prev * (1 - mu[i]) for i in range(5))

    r = dense_apply(p.wr, xr, cfg).transpose(1, 2)  # (B,H,S,dh)
    k = dense_apply(p.wk, xk, cfg).transpose(1, 2)
    v = dense_apply(p.wv, xv, cfg).transpose(1, 2)
    g = F.silu(dense_apply(p.wg, xg, cfg))

    # data-dependent decay (the Finch feature): w = exp(-exp(w0 + lora(xw)))
    lora = dense_apply(p.w_lora_b, torch.tanh(dense_apply(p.w_lora_a, xw, cfg)), cfg)
    logw = -torch.exp(p.w0.float() + lora.float())  # log w ≤ 0, (B,S,d)
    logw = logw.reshape(B, S, H, dh).transpose(1, 2)

    rf, kf, vf = (a.float() for a in (r, k, v))
    u = p.u.float()

    if cache is None:
        s0 = torch.zeros((B, H, dh, dh), dtype=torch.float32, device=x.device)
        out, _ = _rwkv_chunked(rf, kf, vf, logw, u, s0, RWKV_CHUNK)
        new_cache = None
    else:
        s = cache.s.float()
        ri, ki, vi = rf[:, :, 0], kf[:, :, 0], vf[:, :, 0]  # (B,H,dh)
        kv = torch.einsum("bhd,bhe->bhde", ki, vi)
        out = torch.einsum("bhd,bhde->bhe", ri, s + u[None, :, :, None] * kv)
        s_new = s * torch.exp(logw[:, :, 0])[..., None] + kv
        out = out[:, :, None]  # (B,H,1,dh)
        new_cache = RwkvCache(x.to(cache.x_tm.dtype), cache.x_cm, s_new.to(cache.s.dtype))

    # per-head groupnorm, gate, output proj
    o = out.transpose(1, 2)  # (B,S,H,dh)
    mean = o.mean(-1, keepdim=True)
    var = ((o - mean) ** 2).mean(-1, keepdim=True)
    o = (o - mean) * torch.rsqrt(var + 64e-5)
    o = o * p.ln_scale.float() + p.ln_bias.float()
    o = o.reshape(B, S, d).to(dtype) * g
    return dense_apply(p.wo, o, cfg), new_cache
