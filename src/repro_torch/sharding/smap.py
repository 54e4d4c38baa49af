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
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

__all__ = ["lane_shard_devices", "lane_split"]


def lane_shard_devices(mesh, axes: Sequence[str]) -> list[torch.device]:
    """The device of each lane shard of ``mesh`` sharded over ``axes``, in
    shard order: ``axes`` major to minor, then the first device along every
    other axis."""
    names = list(mesh.axis_names)
    order = [names.index(a) for a in axes] + [i for i, a in enumerate(names) if a not in axes]
    n_shards = math.prod(int(mesh.shape[a]) for a in axes)
    return list(mesh.devices.transpose(order).reshape(n_shards, -1)[:, 0])


def lane_split(
    decode: Callable[[torch.Tensor], torch.Tensor],
    blocks: torch.Tensor,
    devices: Sequence[torch.device],
    *,
    out_device: torch.device,
    n_real: int | None = None,
) -> torch.Tensor:
    """Decode ``(T, R, B)`` ``blocks`` in ``len(devices)`` equal lane slices.

    Slice ``i`` holds lanes ``[i·B/n, (i+1)·B/n)`` and is decoded by
    ``decode`` on ``devices[i]``; the ``(D, ·)`` results are joined on
    ``out_device``. ``B`` must divide into the slices. With ``n_real`` given,
    lanes from ``n_real`` on are padding: each slice is cut to its real
    lanes and a slice with none is not decoded, so the result has ``n_real``
    lanes; without it every lane of every slice is decoded and the result
    has ``B``.
    """
    n = len(devices)
    B = blocks.shape[2]
    if B % n:
        raise ValueError(f"lane axis {B} does not split into {n} equal slices")
    width = B // n
    real = B if n_real is None else n_real
    parts = []
    for i, dev in enumerate(devices):
        lo, hi = i * width, min((i + 1) * width, real)
        if hi <= lo:
            continue
        part = blocks[:, :, lo:hi].contiguous().to(dev, non_blocking=True)
        parts.append(decode(part).to(out_device, non_blocking=True))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
