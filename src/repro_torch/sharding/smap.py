"""The lane split: the port's counterpart of ``repro.sharding.smap.lane_shard_map``.

The PBVD decode shards nothing but the last (lane) axis of its ``(T, R, B)``
framed blocks, and parallel blocks never interact, so a sharded decode is a
partition with no collectives: the lanes are cut into ``n_shards`` equal
contiguous slices, each slice is moved to its device and decoded there, and
the ``(D, B / n_shards)`` results come back to one device, joined along the
lane axis.

The slices follow the row-major order of the lane-carrying mesh axes, which
is the order a ``PartitionSpec((axes...))`` gives in the reference. Mesh axes
outside them (for example ``model``) replicate the lanes in the reference;
here each lane shard is decoded once, on its first device (the one whose
other axis indices are all 0), which gives the same bits without the
replicas' launches.

Launches stay asynchronous: nothing here synchronizes between shards.

A mesh that spans processes (``DecodeMesh.spans_processes``) has every rank
split the same lanes the same way, launch only the slices its own devices
hold, and end with every slice's bits: each rank copies its slices' bits to
the host, and one ``all_gather`` over the fleet's gloo group
(:func:`~repro_torch.launch.mesh.fleet_group`) joins them in slice order on
every rank. That copy is the rank's first synchronization.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import fleet_group

__all__ = ["lane_shard_devices", "lane_shard_owners", "lane_split"]


def _shard_major(mesh, grid, axes: Sequence[str]) -> list:
    """``grid`` (shaped as the mesh) in shard order: ``axes`` major to
    minor, then the first entry along every other axis."""
    names = list(mesh.axis_names)
    order = [names.index(a) for a in axes] + [i for i, a in enumerate(names) if a not in axes]
    n_shards = math.prod(int(mesh.shape[a]) for a in axes)
    return list(grid.transpose(order).reshape(n_shards, -1)[:, 0])


def lane_shard_devices(mesh, axes: Sequence[str]) -> list[torch.device]:
    """The device of each lane shard of ``mesh`` sharded over ``axes``, in
    shard order: ``axes`` major to minor, then the first device along every
    other axis."""
    return _shard_major(mesh, mesh.devices, axes)


def lane_shard_owners(mesh, axes: Sequence[str]) -> list[int]:
    """The rank that owns each lane shard's device, in shard order (as
    :func:`lane_shard_devices`)."""
    return [int(r) for r in _shard_major(mesh, mesh.owners, axes)]


def lane_split(
    decode: Callable[[torch.Tensor], torch.Tensor],
    blocks: torch.Tensor,
    devices: Sequence[torch.device],
    *,
    out_device: torch.device,
    n_real: int | None = None,
    owners: Sequence[int] | None = None,
    rows: int | None = None,
) -> torch.Tensor:
    """Decode ``(T, R, B)`` ``blocks`` in ``len(devices)`` equal lane slices.

    Slice ``i`` holds lanes ``[i·B/n, (i+1)·B/n)`` and is decoded by
    ``decode`` on ``devices[i]``; the ``(D, ·)`` results are joined on
    ``out_device``. ``B`` must divide into the slices. With ``n_real`` given,
    lanes from ``n_real`` on are padding: each slice is cut to its real
    lanes and a slice with none is not decoded, so the result has ``n_real``
    lanes; without it every lane of every slice is decoded and the result
    has ``B``.

    With ``owners`` (each slice's rank, on a mesh that spans processes) this
    process decodes only its own slices and every process gets the whole
    result, joined through the fleet's gloo group (module docstring);
    ``rows`` is then the decode's output rows ``D``, which a rank that holds
    no real lanes cannot read off a result of its own. The results must be
    bits (0 or 1): they cross as uint8.
    """
    n = len(devices)
    B = blocks.shape[2]
    if B % n:
        raise ValueError(f"lane axis {B} does not split into {n} equal slices")
    width = B // n
    real = B if n_real is None else n_real
    widths = [max(0, min((i + 1) * width, real) - i * width) for i in range(n)]
    me = None if owners is None else dist.get_rank()
    parts = []
    for i, dev in enumerate(devices):
        if not widths[i] or (owners is not None and owners[i] != me):
            continue
        lo = i * width
        part = blocks[:, :, lo : lo + widths[i]].contiguous().to(dev, non_blocking=True)
        bits = decode(part)
        parts.append(bits if owners is not None else bits.to(out_device, non_blocking=True))
    if owners is not None:
        return _gather_slices(parts, widths, owners, rows, out_device)
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _gather_slices(parts: list[torch.Tensor], widths: list[int], owners: Sequence[int],
                   rows: int, out_device: torch.device) -> torch.Tensor:
    """Join every rank's slices in slice order, on every rank.

    ``parts`` are this rank's decoded slices in slice order, ``widths`` every
    slice's lanes. Each rank sends one ``(rows, its lanes)`` uint8 block from
    the host, padded to the widest rank's, in one ``all_gather`` over
    :func:`~repro_torch.launch.mesh.fleet_group`; the joined bits come back
    to ``out_device`` as int32.
    """
    group = fleet_group()
    world = dist.get_world_size(group)
    lanes = [sum(w for w, r in zip(widths, owners) if r == rank) for rank in range(world)]
    mine = torch.zeros((rows, max(lanes)), dtype=torch.uint8)
    if parts:
        host = torch.cat([p.to(torch.uint8).cpu() for p in parts], dim=1)
        mine[:, : host.shape[1]] = host
    got = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(got, mine, group=group)
    cols, taken = [], [0] * world
    for w, r in zip(widths, owners):
        if w:
            cols.append(got[r][:, taken[r] : taken[r] + w])
            taken[r] += w
    return torch.cat(cols, dim=1).to(out_device).to(torch.int32)
