"""AdamW + cosine schedule in plain tensor ops (no ``torch.optim``).

The counterpart of ``repro._unused.train.optimizer``. The parameters,
gradients and moments are dicts keyed by the port's parameter names
(``dict(model.named_parameters())``); :func:`adamw_update` writes the new
parameters and moments in place, one leaf at a time, so that the step
needs no second copy of the state. Over a mesh the leaves are
:class:`~repro_torch.sharding.place.Placed` tiles and
:func:`adamw_update_tiles` runs the same update once per tile, on its
device, with the global gradient norm of the distinct tiles. The arithmetic is the reference's:
gradients scaled by one global-norm clip, bias-corrected moments, weight
decay on every leaf (norms and biases included), schedule and corrections
in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch

from repro_torch.sharding.rules import on_position

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update", "adamw_update_tiles",
           "cosine_schedule", "global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: str = "float32"


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar on the CPU
    m: dict  # name → first moment
    v: dict  # name → second moment


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 0 at ``total_steps``: a float32
    scalar on the CPU."""
    step = _f32(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    return cfg.lr * warm * 0.5 * (1.0 + torch.cos(_f32(math.pi) * prog))


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig) -> OptState:
    dt = getattr(torch, cfg.state_dtype)

    def zeros():
        return {k: torch.zeros(p.shape, dtype=dt, device=p.device) for k, p in params.items()}

    return OptState(torch.zeros((), dtype=torch.int32), zeros(), zeros())


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree.values()))


def _adamw_leaf(p, g, m, v, lr, scale, b1c, b2c, cfg: AdamWConfig) -> None:
    """One leaf's update, in place, on the leaf's device."""
    if isinstance(scale, torch.Tensor):
        scale = scale.to(g.device)
    g = g.float() * scale
    m_new = cfg.b1 * m.float() + (1 - cfg.b1) * g
    v_new = cfg.b2 * v.float() + (1 - cfg.b2) * g * g
    delta = (m_new / b1c) / (torch.sqrt(v_new / b2c) + cfg.eps) + cfg.weight_decay * p.float()
    p.copy_(p.float() - lr * delta)
    m.copy_(m_new)
    v.copy_(v_new)


def _schedule(state: OptState, gnorm: torch.Tensor, cfg: AdamWConfig):
    step = state.step + 1
    scale = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    b1c = 1.0 - _f32(cfg.b1) ** step.float()
    b2c = 1.0 - _f32(cfg.b2) ** step.float()
    return step, cosine_schedule(cfg, step), scale, b1c, b2c


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 state: OptState, cfg: AdamWConfig):
    """Returns (params, new_state, metrics); ``params`` and the moments are
    updated in place, ``grads`` is read. ``metrics``: ``grad_norm`` (on the
    gradients' device) and ``lr``."""
    gnorm = global_norm(grads)
    step, lr, scale, b1c, b2c = _schedule(state, gnorm, cfg)
    for key, p in params.items():
        _adamw_leaf(p, grads[key], state.m[key], state.v[key], lr, scale, b1c, b2c, cfg)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def adamw_update_tiles(params: Mapping, grads: Mapping, state: OptState, cfg: AdamWConfig):
    """:func:`adamw_update` over :class:`~repro_torch.sharding.place.Placed`
    parameters, gradients and moments of one layout: every tile (replicas
    included) takes the update of its own slice on its device. The
    gradient norm sums each distinct gradient tile once, on the first
    parameter's device."""
    dev = next(iter(params.values())).device
    gnorm = torch.sqrt(sum(torch.sum(torch.square(t.float())).to(dev)
                           for g in grads.values() for t in g.blocks().values()))
    step, lr, scale, b1c, b2c = _schedule(state, gnorm, cfg)
    for key, p in params.items():
        g, m, v = grads[key], state.m[key], state.v[key]
        for pos in p.positions():
            with on_position(pos):
                _adamw_leaf(p.tiles[pos], g.tiles[pos], m.tiles[pos], v.tiles[pos], lr, scale,
                            b1c, b2c, cfg)
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm, "lr": lr}
