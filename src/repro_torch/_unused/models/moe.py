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
GEMMs); the reference computes them outside any Pallas kernel too.

Under a rule context (``sharding.rules.axis_rules``) whose ``experts``
axis divides ``n_experts``, ``moe_apply`` takes the expert-parallel path
``_moe_apply_ep``, as the reference does, a one-device ``(1, 1)`` mesh
included. Its routing group is a data shard's local tokens, all rows
together, with capacity ``C = clip(ceil(cf·T·k/E), 1, T)``, so it drops
other entries than the dense path, whose groups are the rows. Each model
shard computes its ``E/ep`` experts on its own device of the mesh, with
the expert slice that rests there (``sharding.place.model_tile``: the
tile of the serving layout or of the mesh train step, never a per-step
copy of the weights); their sum (the reference's ``psum``) lands on the
data shard's first device, and the shared experts are added after it.
Where ``experts`` does not divide a ``model`` axis of more than one
position, the dense path runs with the expert hidden dimension over
``expert_mlp`` (the reference's GSPMD split): routing, dispatch and
combine once on the first position, each position's slice of
``d_ff_expert`` in the expert SwiGLU, one sum of the expert outputs. The
shared experts split ``mlp`` the same way under a ``model`` axis.
``dropped`` counts the entries that the dense path drops by capacity on
an input; ``ep_load`` gives each shard's kept and dropped entries on the
expert-parallel path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.launch import cost
from repro_torch.sharding.place import model_parts, model_tile
from repro_torch.sharding.rules import (batch_shards, current_rules, mesh_position, model_size,
                                        model_split, on_position, shard)
from .layers import FFN, Dense, cdtype, dense_axes, dense_init, pdtype

__all__ = ["MoE", "moe_init", "moe_axes", "moe_apply", "moe_capacity", "dropped", "ep_load"]


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


#: the logical axes of the routed experts' weights
_EXPERT_AXES = {"wi": ("experts", "fsdp", "expert_mlp"), "wg": ("experts", "fsdp", "expert_mlp"),
                "wo": ("experts", "expert_mlp", "fsdp")}
_SHARED_AXES = {"wi": ("fsdp", "mlp"), "wg": ("fsdp", "mlp"), "wo": ("mlp", "fsdp")}


def moe_axes(cfg: ModelConfig) -> dict:
    a = {
        "router": {"w": ("fsdp", None)},
        "wi": ("experts", "fsdp", "expert_mlp"),
        "wg": ("experts", "fsdp", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "fsdp"),
    }
    if cfg.n_shared_experts:
        a["shared"] = {
            "wi": dense_axes("fsdp", ("mlp",)),
            "wg": dense_axes("fsdp", ("mlp",)),
            "wo": dense_axes("mlp", ("fsdp",)),
        }
    return a


def _route(p: MoE, x: torch.Tensor, cfg: ModelConfig):
    """(gate (B,S,k) f32, ids (B,S,k) int64): softmax in float32, then the k
    largest with the lower expert id first on ties, renormalized."""
    logits = x.float() @ p.router.w.to(x.device).float()
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
    """x (B, S, d) → (B, S, d) in x's dtype: the expert-parallel path when
    the rules allow it (:func:`_ep_enabled`), else the dense path."""
    ep_axis = _ep_enabled(cfg)
    if ep_axis is not None:
        return _moe_apply_ep(p, x, cfg, ep_axis)
    if model_size() > 1:
        return _moe_apply_dense(p, x, cfg, experts=_experts_tp)
    return _moe_apply_dense(p, x, cfg)


def _expert_swiglu(buf: torch.Tensor, wi, wg, wo) -> torch.Tensor:
    """The expert SwiGLU on the dispatch buffer (B, E, C, d), batched over
    the expert axis."""
    h = F.silu(torch.einsum("becd,edf->becf", buf, wg)) * torch.einsum("becd,edf->becf", buf, wi)
    h = shard(h, ("batch", "experts", None, "expert_mlp"))
    return torch.einsum("becf,efd->becd", h, wo)


def _experts_whole(p: MoE, buf: torch.Tensor, dtype) -> torch.Tensor:
    return _expert_swiglu(buf, *(w.to(dtype) for w in (p.wi, p.wg, p.wo)))


def _experts_tp(p: MoE, buf: torch.Tensor, dtype) -> torch.Tensor:
    """:func:`_expert_swiglu` with ``d_ff_expert`` over ``expert_mlp``: each
    model position's columns of ``wi``/``wg`` and rows of ``wo``, the
    partial outputs summed once (on the first position where the rules
    leave the hidden dimension whole)."""
    def partial(m, bm, coords):
        return _expert_swiglu(bm, *(model_tile(getattr(p, k), _EXPERT_AXES[k], m, coords)
                                    .to(dtype) for k in ("wi", "wg", "wo")))

    return model_parts(buf, partial, model_split(_EXPERT_AXES["wi"], p.wi.shape)[1])


def _moe_apply_dense(p: MoE, x: torch.Tensor, cfg: ModelConfig,
                     experts=_experts_whole) -> torch.Tensor:
    """x (B, S, d) → (B, S, d). Routing groups = batch rows. ``experts``
    computes the expert outputs (B, E, C, d) from the dispatch buffer."""
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
    buf = shard(buf[:, : E * C].reshape(B, E, C, d), ("batch", "experts", None, None))

    # ---- the experts (SwiGLU), batched over the expert axis -------------------------
    y = shard(experts(p, buf, dtype), ("batch", "experts", None, None))

    # ---- combine: gather back, weight by gate, add to the token rows ---------------
    y_flat = torch.cat([y.reshape(B, E * C, d), y.new_zeros((B, 1, d))], dim=1)
    out_e = y_flat[rows, dest] * gate_s[..., None].to(dtype)  # dropped → 0
    out = torch.zeros((B, S, d), dtype=dtype, device=dev)
    out.index_put_((rows.expand(B, S * k), tok_s), out_e, accumulate=True)
    return _add_shared(p, x, out, cfg).to(x.dtype)


def _add_shared(p: MoE, x: torch.Tensor, out: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Shared experts as a dense SwiGLU on every token, in the promoted dtype
    of x and the compute dtype (the reference's einsum promotion); under a
    ``model`` axis with the hidden dimension over ``mlp``, one sum."""
    if p.shared is None:
        return out
    dtype = torch.promote_types(x.dtype, cdtype(cfg))
    sh = p.shared
    xs = x.to(dtype)

    def swiglu(xm, wi, wg, wo):
        return (F.silu(xm @ wg.to(dtype)) * (xm @ wi.to(dtype))) @ wo.to(dtype)

    if model_size() == 1:
        return out + swiglu(xs, sh.wi.w, sh.wg.w, sh.wo.w)
    return out + model_parts(xs, lambda m, xm, c: swiglu(xm, *(
        model_tile(getattr(sh, k).w, _SHARED_AXES[k], m, c) for k in ("wi", "wg", "wo"))),
        model_split(_SHARED_AXES["wi"], sh.wi.w.shape)[1])


# ---- expert parallelism ---------------------------------------------------------------
def _ep_enabled(cfg: ModelConfig) -> str | None:
    """The mesh axis for expert parallelism if usable, else None: a rule
    context whose ``experts`` rule names a mesh axis that divides
    ``n_experts``."""
    r = current_rules()
    if r is None:
        return None
    ax = r.rules.get("experts")
    if isinstance(ax, tuple):
        ax = ax[0] if ax else None
    if ax is None or ax not in r.mesh.axis_names:
        return None
    if cfg.n_experts % int(r.mesh.shape[ax]) != 0:
        return None
    return ax


def _ep_route(p: MoE, xl: torch.Tensor, cfg: ModelConfig):
    """One data shard's routing over all its T = B·S tokens, in float32:
    (tok_s, gate_s, ids_s, rank, keep, C) for the T·k entries sorted by
    expert, stably; ``keep`` is rank < C = clip(ceil(cf·T·k/E), 1, T)."""
    Bl, Sl, _ = xl.shape
    T, E, k = Bl * Sl, cfg.n_experts, cfg.top_k
    C = max(min(int(math.ceil(cfg.capacity_factor * T * k / E)), T), 1)
    gate, ids = _route(p, xl, cfg)
    dev = xl.device
    ids_f = ids.reshape(T * k)
    order = torch.argsort(ids_f, stable=True)
    ids_s = ids_f[order]
    tok_s = torch.arange(T, device=dev).repeat_interleave(k)[order]
    gate_s = gate.reshape(T * k)[order]
    starts = torch.searchsorted(ids_s, torch.arange(E, device=dev))
    rank = torch.arange(T * k, device=dev) - starts[ids_s]
    return tok_s, gate_s, ids_s, rank, rank < C, C


def _moe_apply_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig, ep_axis: str) -> torch.Tensor:
    """The expert-parallel path (the reference's ``shard_map`` body per
    shard). For each data shard and each model shard ``m`` along
    ``ep_axis``: route the shard's tokens, compute the routed contribution
    of experts ``[m·E/ep, (m+1)·E/ep)`` on the mesh device at (data shard,
    m), and sum the model shards' outputs on the data shard's first device;
    the data shards' rows are joined on x's device, then the shared experts
    are added."""
    rules = current_rules()
    mesh = rules.mesh
    d, E = x.shape[-1], cfg.n_experts
    ep = int(mesh.shape[ep_axis])
    E_loc = E // ep
    dtype = cdtype(cfg)
    outs = []
    for coords, rows in batch_shards(x.shape):
        xs = x[rows]
        Bl, Sl, _ = xs.shape
        T = Bl * Sl
        first = mesh.devices[mesh_position(mesh, {**coords, ep_axis: 0})]
        xl = xs.to(first)
        tok_s, gate_s, ids_s, rank, keep, C = _ep_route(p, xl, cfg)
        xt = xl.reshape(T, d)
        routed = None
        first_pos = mesh_position(mesh, {**coords, ep_axis: 0})
        for m in range(ep):
            pos = mesh_position(mesh, {**coords, ep_axis: m})
            dev = mesh.devices[pos]
            with on_position(pos):
                # slots of THIS shard's experts only
                dest = ids_s * C + rank - m * E_loc * C
                valid = keep & (dest >= 0) & (dest < E_loc * C)
                dest = torch.where(valid, dest, E_loc * C).to(dev)
                buf = torch.zeros((E_loc * C + 1, d), dtype=dtype, device=dev)
                sent = xt[tok_s].to(dev, dtype)
                buf[dest] = sent
                buf = buf[: E_loc * C].reshape(E_loc, C, d)
                wi, wg, wo = (model_tile(getattr(p, k), _EXPERT_AXES[k], m, coords).to(dtype)
                              for k in ("wi", "wg", "wo"))
                h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) * torch.einsum(
                    "ecd,edf->ecf", buf, wi)
                y = torch.einsum("ecf,efd->ecd", h, wo).reshape(E_loc * C, d)
                y = torch.cat([y, y.new_zeros((1, d))])
                contrib = y[dest] * (gate_s * valid).to(dev, dtype)[:, None]
                out = torch.zeros((T, d), dtype=dtype, device=dev)
                out = out.index_put((tok_s.to(dev),), contrib, accumulate=True)
            counter = cost.active()
            if counter is not None and m:  # the tokens out to shard m and its sums back
                counter.collective("all-to-all", sent.numel() * sent.element_size(), pos)
                counter.collective("all-to-all", out.numel() * out.element_size(), first_pos)
            routed = out.to(first) if routed is None else routed + out.to(first)
        outs.append(routed.reshape(Bl, Sl, d).to(x.device))
    routed = outs[0] if len(outs) == 1 else torch.cat(outs, dim=0)
    return _add_shared(p, x, routed, cfg).to(x.dtype)


def ep_load(p: MoE, x: torch.Tensor, cfg: ModelConfig) -> list[dict]:
    """Under the rules of the expert-parallel path, each (data shard, model
    shard)'s ``kept`` and ``dropped`` routed entries on input ``x``: a list
    over data shards of ``{"coords", "kept": [per model shard],
    "dropped": [...] , "capacity": C}`` (ints)."""
    ep_axis = _ep_enabled(cfg)
    if ep_axis is None:
        raise ValueError("ep_load needs a rule context that enables expert parallelism")
    ep = int(current_rules().mesh.shape[ep_axis])
    E_loc = cfg.n_experts // ep
    out = []
    for coords, rows in batch_shards(x.shape):
        xs = x[rows]
        _, _, ids_s, _, keep, C = _ep_route(p, xs, cfg)
        shard_of = ids_s // E_loc
        out.append({"coords": dict(coords), "capacity": C,
                    "kept": [int((keep & (shard_of == m)).sum()) for m in range(ep)],
                    "dropped": [int((~keep & (shard_of == m)).sum()) for m in range(ep)]})
    return out
