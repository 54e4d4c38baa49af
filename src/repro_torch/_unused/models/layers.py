"""Foundational layers: dense, norms, embeddings, RoPE, FFNs.

The counterpart of ``repro._unused.models.layers``. A JAX pytree of
parameters becomes an ``nn.Module`` whose parameter names are the pytree's
keys (``w``, ``b``, ``scale``, ``bias``, ``table``; an FFN holds ``wi``,
``wo`` and for SwiGLU ``wg``); the ``*_apply`` functions take the module and
tensors as the reference's take the pytree and arrays. Parameters are made
with ``requires_grad=False`` for serving (here and in ``moe.py`` and
``ssm.py``); a trainer switches them on with ``module.requires_grad_(True)``.
They stay in ``param_dtype`` and are cast to ``compute_dtype`` at each use;
norms compute in float32 and cast back to the input's dtype. Initializers draw from an
explicit ``torch.Generator`` on the parameters' device, so their numbers
differ from ``jax.random``'s: the tests carry the reference's weights across
with :func:`repro_torch.interop.convert_lm_params`. The RWKV channel mix
(``ffn_act="rwkv_cm"``) is a :class:`ChannelMix` with ``mu``, ``wk``, ``wv``
and ``wr``. The ``*_axes`` functions give each module's leaves their
logical axes, keyed as its parameters are (``sharding.rules``).

Tensor parallelism (a rule context whose ``model`` axis has more than one
position): :func:`dense_tp` is the dense layer over the model positions,
column-parallel where the rules split its output axis (the positions'
columns joined), row-parallel where they split its input axis (each
position's partial product of its columns of x, then the sum); whole on
the first position otherwise. :func:`ffn_apply` splits the hidden
dimension over ``mlp``: each position computes its columns of ``wi``
(``wg``) and its rows of ``wo``, and the partials are summed once per FFN.
The RWKV channel mix splits ``wk``'s columns and ``wv``'s rows the same
way; its token-shift mixes and its receptance (``wr``, unsplit) run once
on the first position, which multiplies the sum.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.place import join_model_parts, model_parts, model_tile
from repro_torch.sharding.rules import model_size, model_split

__all__ = [
    "Dense", "DenseTile", "dense_init", "dense_axes", "dense_apply", "dense_tile", "dense_tp",
    "Norm", "norm_init", "norm_axes", "norm_apply",
    "Embed", "round_vocab", "embed_init", "embed_axes",
    "rope_sin_cos", "apply_rope",
    "FFN", "ChannelMix", "ffn_init", "ffn_axes", "ffn_apply",
    "cdtype", "pdtype",
]


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _normal(shape, cfg, gen, device, std: float) -> nn.Parameter:
    t = torch.empty(shape, dtype=pdtype(cfg), device=device)
    if t.device.type != "meta":
        t.normal_(generator=gen).mul_(std)
    return nn.Parameter(t, requires_grad=False)


def _const(shape, cfg, device, value: float) -> nn.Parameter:
    return nn.Parameter(torch.full(shape, value, dtype=pdtype(cfg), device=device),
                        requires_grad=False)


# ---- dense / linear -----------------------------------------------------------
class Dense(nn.Module):
    """``w`` (in_dim, *out_dims) and, with a bias, ``b`` (*out_dims)."""

    def __init__(self, w: nn.Parameter, b: nn.Parameter | None = None):
        super().__init__()
        self.w = w
        self.b = b


def dense_init(in_dim: int, out_dims: Sequence[int], cfg, *, gen=None, device=None,
               bias=False, scale=None) -> Dense:
    if scale is None:
        scale = 1.0 / np.sqrt(in_dim)
    w = _normal((in_dim, *out_dims), cfg, gen, device, float(scale))
    return Dense(w, _const(tuple(out_dims), cfg, device, 0.0) if bias else None)


def dense_axes(in_axis, out_axes, *, bias=False) -> dict:
    """The logical axes of a :class:`Dense`'s leaves (``sharding.rules``)."""
    a = {"w": (in_axis, *out_axes)}
    if bias:
        a["b"] = tuple(out_axes)
    return a


def dense_apply(p: Dense | DenseTile, x: torch.Tensor, cfg) -> torch.Tensor:
    """x (..., in_dim) → (..., *out_dims) in the compute dtype: the
    reference's ``"...d,dh->...h"`` and ``"bsd,dhe->bshe"`` contractions.
    An x of another dtype (a cached MLA latent) promotes as JAX's einsum
    does: both operands go to the wider dtype after ``w``'s cast."""
    w = p.w.to(cdtype(cfg))
    if x.dtype != w.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dtype), w.to(dtype)
    out_dims = w.shape[1:]
    y = (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:-1], *out_dims)
    if p.b is not None:
        y = y + p.b.to(cdtype(cfg))
    return y


class DenseTile(NamedTuple):
    """A model position's ``w`` and ``b`` tiles, which :func:`dense_apply`
    takes as it takes a :class:`Dense` (no module built per step)."""

    w: torch.Tensor
    b: torch.Tensor | None = None


def dense_tile(p: Dense, in_axis, out_axes, m: int, coords=None) -> DenseTile:
    """What model position ``m`` (of the data shard at ``coords``) computes
    with: the tiles of ``w`` and ``b``
    (:func:`~repro_torch.sharding.place.model_tile`)."""
    b = None if p.b is None else model_tile(p.b, tuple(out_axes), m, coords)
    return DenseTile(model_tile(p.w, (in_axis, *out_axes), m, coords), b)


def dense_tp(p: Dense, x: torch.Tensor, cfg, in_axis, out_axes) -> torch.Tensor:
    """:func:`dense_apply` over the model positions of each data shard:
    row-parallel where the rules split ``w``'s input axis (each position
    multiplies its columns of x by its rows of ``w``; the partials are
    summed, then the bias added), column-parallel where they split an
    output axis (the positions' outputs joined on the first), on the first
    position where ``w`` is whole; :func:`dense_apply` itself without a
    ``model`` axis."""
    if model_size() == 1:
        return dense_apply(p, x, cfg)
    axes = (in_axis, *out_axes)
    dim, n = model_split(axes, p.w.shape)
    if dim == 0:
        cols = p.w.shape[0] // n

        def partial(m, xm, coords):
            w = model_tile(p.w, axes, m, coords)
            return dense_apply(DenseTile(w), xm[..., m * cols:(m + 1) * cols], cfg)

        y = model_parts(x, partial, n)
        return y if p.b is None else y + model_tile(p.b, tuple(out_axes), 0).to(cdtype(cfg))
    out_dim = x.dim() - 2 + (dim or 1)  # the split output axis of y (..., *out_dims)
    return model_parts(x, lambda m, xm, c: dense_apply(dense_tile(p, in_axis, out_axes, m, c),
                                                       xm, cfg),
                       n, join=lambda parts, _: join_model_parts(parts, out_dim))


# ---- norms ---------------------------------------------------------------------
class Norm(nn.Module):
    """``scale`` and, for LayerNorm, ``bias``."""

    def __init__(self, scale: nn.Parameter, bias: nn.Parameter | None = None):
        super().__init__()
        self.scale = scale
        self.bias = bias


def norm_init(dim: int, cfg, *, device=None) -> Norm:
    bias = _const((dim,), cfg, device, 0.0) if cfg.norm_type == "layernorm" else None
    return Norm(_const((dim,), cfg, device, 1.0), bias)


def norm_axes(cfg) -> dict:
    a = {"scale": ("embed",)}
    if cfg.norm_type == "layernorm":
        a["bias"] = ("embed",)
    return a


def norm_apply(p: Norm, x: torch.Tensor, cfg) -> torch.Tensor:
    xf = x.float()
    if cfg.norm_type == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p.scale.float() + p.bias.float()
    else:  # rmsnorm
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p.scale.float()
    return y.to(x.dtype)


# ---- embeddings ------------------------------------------------------------------
def round_vocab(vocab: int, multiple: int = 256) -> int:
    return -(-vocab // multiple) * multiple


class Embed(nn.Module):
    """``table`` (round_vocab(vocab), d_model)."""

    def __init__(self, table: nn.Parameter):
        super().__init__()
        self.table = table


def embed_init(cfg, *, gen=None, device=None) -> Embed:
    return Embed(_normal((round_vocab(cfg.vocab), cfg.d_model), cfg, gen, device, 0.02))


def embed_axes() -> dict:
    return {"table": ("vocab", "fsdp")}


# ---- rotary position embeddings ---------------------------------------------------
@functools.lru_cache(maxsize=64)
def _inv_freq(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    """The reference's float32 numpy inverse frequencies, copied to the
    device once (a copy per call would synchronize every layer)."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    return torch.as_tensor(inv, device=device)


def rope_sin_cos(positions: torch.Tensor, dim: int, theta: float):
    """positions (...,) int → sin, cos (..., dim/2) f32."""
    inv = _inv_freq(dim, theta, positions.device)
    ang = positions.float()[..., None] * inv[None, :]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, dh) with sin/cos (..., S, dh/2): rotate-half, the halves
    concatenated (not interleaved)."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2], x[..., d2:]
    s, c = sin[..., None, :], cos[..., None, :]  # broadcast over heads
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---- feed-forward variants ---------------------------------------------------------
class FFN(nn.Module):
    """``wi``, ``wo`` and, for SwiGLU, ``wg``."""

    def __init__(self, wi: Dense, wo: Dense, wg: Dense | None = None):
        super().__init__()
        self.wi = wi
        self.wg = wg
        self.wo = wo


class ChannelMix(nn.Module):
    """The RWKV channel mix: ``mu`` (2, d), the token-shift mixes of the key
    and the receptance, ``wk`` (d, d_ff), ``wv`` (d_ff, d) and ``wr`` (d, d)."""

    def __init__(self, mu: nn.Parameter, wk: Dense, wv: Dense, wr: Dense):
        super().__init__()
        self.mu, self.wk, self.wv, self.wr = mu, wk, wv, wr


def ffn_init(cfg: ModelConfig, d_ff: int, *, gen=None, device=None) -> FFN | ChannelMix:
    d = cfg.d_model
    kw = dict(gen=gen, device=device)
    if cfg.ffn_act == "rwkv_cm":
        return ChannelMix(_const((2, d), cfg, device, 0.5), dense_init(d, (d_ff,), cfg, **kw),
                          dense_init(d_ff, (d,), cfg, **kw), dense_init(d, (d,), cfg, **kw))
    wi = dense_init(d, (d_ff,), cfg, **kw)
    wg = dense_init(d, (d_ff,), cfg, **kw) if cfg.ffn_act == "swiglu" else None
    return FFN(wi, dense_init(d_ff, (d,), cfg, **kw), wg)


def ffn_axes(cfg: ModelConfig) -> dict:
    if cfg.ffn_act == "swiglu":
        return {
            "wi": dense_axes("fsdp", ("mlp",)),
            "wg": dense_axes("fsdp", ("mlp",)),
            "wo": dense_axes("mlp", ("fsdp",)),
        }
    if cfg.ffn_act == "rwkv_cm":
        return {
            "mu": (None, "embed"),
            "wk": dense_axes("fsdp", ("mlp",)),
            "wv": dense_axes("mlp", ("fsdp",)),
            "wr": dense_axes("fsdp", ("embed",)),
        }
    return {"wi": dense_axes("fsdp", ("mlp",)), "wo": dense_axes("mlp", ("fsdp",))}


def ffn_apply(p: FFN | ChannelMix, x: torch.Tensor, cfg: ModelConfig, *,
              x_prev: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, S, d) → (B, S, d). GELU is the tanh approximation, as
    ``jax.nn.gelu``'s default. ``x_prev`` is the token-shifted input of the
    RWKV channel mix (``None``: x itself); the other variants ignore it.
    Under a ``model`` axis: :func:`_ffn_tp`."""
    if model_size() > 1:
        return _ffn_tp(p, x, cfg, x_prev)
    if cfg.ffn_act == "swiglu":
        h = F.silu(dense_apply(p.wg, x, cfg)) * dense_apply(p.wi, x, cfg)
        return dense_apply(p.wo, h, cfg)
    if cfg.ffn_act == "rwkv_cm":
        xp = x if x_prev is None else x_prev
        mu = p.mu.to(x.dtype)
        xk = x * mu[0] + xp * (1 - mu[0])
        xr = x * mu[1] + xp * (1 - mu[1])
        k = torch.square(F.relu(dense_apply(p.wk, xk, cfg)))
        r = torch.sigmoid(dense_apply(p.wr, xr, cfg))
        return r * dense_apply(p.wv, k, cfg)
    h = dense_apply(p.wi, x, cfg)
    if cfg.ffn_act == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return dense_apply(p.wo, h, cfg)


def _ffn_tp(p: FFN | ChannelMix, x: torch.Tensor, cfg: ModelConfig,
            x_prev: torch.Tensor | None) -> torch.Tensor:
    """:func:`ffn_apply` with the hidden dimension over ``mlp``: each model
    position's columns of ``wi`` (``wg``, the channel mix's ``wk``) and rows
    of ``wo`` (``wv``), one sum of the partials (on the first position, in
    model order); on the first position alone where the rules leave the
    hidden dimension whole."""
    rwkv = cfg.ffn_act == "rwkv_cm"
    w_in = p.wk if rwkv else p.wi
    n = model_split(("fsdp", "mlp"), w_in.w.shape)[1]

    if rwkv:
        xp = x if x_prev is None else x_prev
        mu = p.mu.to(x.dtype)
        xk = x * mu[0] + xp * (1 - mu[0])
        xr = x * mu[1] + xp * (1 - mu[1])

        def partial(m, xm, c):
            k = torch.square(F.relu(dense_apply(dense_tile(p.wk, "fsdp", ("mlp",), m, c), xm, cfg)))
            return dense_apply(dense_tile(p.wv, "mlp", ("fsdp",), m, c), k, cfg)

        r = torch.sigmoid(dense_apply(p.wr, xr, cfg))
        return r * model_parts(xk, partial, n)

    def partial(m, xm, c):
        h = dense_apply(dense_tile(p.wi, "fsdp", ("mlp",), m, c), xm, cfg)
        if cfg.ffn_act == "swiglu":
            h = F.silu(dense_apply(dense_tile(p.wg, "fsdp", ("mlp",), m, c), xm, cfg)) * h
        elif cfg.ffn_act == "relu2":
            h = torch.square(F.relu(h))
        else:
            h = F.gelu(h, approximate="tanh")
        return dense_apply(dense_tile(p.wo, "mlp", ("fsdp",), m, c), h, cfg)

    return model_parts(x, partial, n)
