"""Pipeline parallelism: a GPipe microbatch pipeline over a ``pipe`` mesh axis.

The counterpart of ``repro.launch.pp``, in one process over a device list:
stage ``s`` runs on the pipe axis's ``s``-th device (the other axes at 0)
with its slice of the stacked stage parameters, on the classic fill-drain
schedule. With M microbatches and P stages, step ``t`` runs stage ``s`` on
microbatch ``t − s`` where ``0 <= t − s < M``; its output hops to stage
``s + 1``'s device (``.to(..., non_blocking=True)``, the reference's
``ppermute``), and the last stage's outputs are gathered on the input's
device. The bubble fraction is (P − 1)/(M + P − 1). Stages that the
schedule leaves idle compute nothing here (the reference computes them on
zeros and masks them out), so the values are those of the sequential
composition.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.sharding.place import map_tree
from repro_torch.sharding.rules import mesh_position

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


def pipeline_apply(
    stage_fn: Callable,  # (stage_params, x_microbatch) -> x_microbatch
    stage_params,  # tree of tensors stacked over stages (leading dim = P)
    x: torch.Tensor,  # (M, mb, ...) microbatched input
    mesh,
    *,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run a P-stage pipeline over M microbatches; returns (M, mb, ...) on
    x's device."""
    n_stages = int(mesh.shape[axis])
    M = x.shape[0]
    devices = [mesh.devices[mesh_position(mesh, {axis: s})] for s in range(n_stages)]
    params = [map_tree(lambda p, s=s, dev=dev: p[s].to(dev), stage_params)
              for s, dev in enumerate(devices)]
    inflight: list = [None] * n_stages  # the microbatch waiting at each stage's input
    out = [None] * M
    for t in range(M + n_stages - 1):
        for s in reversed(range(n_stages)):  # downstream first: a hop lands for step t + 1
            mb = t - s
            if not 0 <= mb < M:
                continue
            inp = x[mb].to(devices[0], non_blocking=True) if s == 0 else inflight[s]
            y = stage_fn(params[s], inp)
            if s == n_stages - 1:
                out[mb] = y
            else:
                inflight[s + 1] = y.to(devices[s + 1], non_blocking=True)
    return torch.stack([y.to(x.device) for y in out])
