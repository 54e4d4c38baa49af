"""Elastic rescale of a decode fleet after device loss, after
``repro.launch.elastic``.

A decode mesh shards only the lane axis, so a casualty shrinks the engine's
``block_axes`` (every other axis is launch geometry) and the engine is
rebuilt on the smaller mesh, or meshless when fewer than two devices would
remain. The decode is bit-exact either way: the mesh only places lanes.

`plan_rescale` computes the largest valid mesh after losing `lost_chips`
devices; `plan_decode_rescale` restricts it to the lane axes and
`rescale_decode_engine` builds the replacement engine. `reshard` moves an
LM's tree (parameters, optimizer state, caches) onto a new mesh with its
logical axes resolved again by the rules of that mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

__all__ = [
    "reshard",
    "plan_rescale",
    "plan_decode_rescale",
    "rescale_decode_engine",
    "RescalePlan",
]


@dataclasses.dataclass(frozen=True)
class RescalePlan:
    old_shape: tuple
    new_shape: tuple
    axis_names: tuple
    dropped_chips: int

    @property
    def new_chip_count(self) -> int:
        return int(np.prod(self.new_shape))


def plan_rescale(
    mesh,
    lost_chips: int,
    *,
    shrink_axes: tuple[str, ...] | None = None,
) -> RescalePlan:
    """Largest mesh obtainable by shrinking ``shrink_axes`` after losing
    ``lost_chips`` devices.

    ``mesh`` needs only ``axis_names`` and ``shape`` (name → size).
    ``shrink_axes`` defaults to every axis except ``model``; a decode fleet
    passes its engine's ``block_axes`` instead (see
    :func:`plan_decode_rescale`).

    The search maximizes the surviving chip count over ALL candidate
    shrink-axis shapes (a first fit in descending order is the maximum only
    when a single axis shrinks: with two 4-wide axes and 7 chips lost it
    would take 4×2 = 8 chips where 3×3 = 9 fit).
    """
    names = mesh.axis_names
    shape = dict(mesh.shape)
    total = int(np.prod(list(shape.values())))
    target = total - int(lost_chips)
    if shrink_axes is None:
        shrink_axes = tuple(n for n in names if n != "model")
    else:
        shrink_axes = tuple(shrink_axes)
        unknown = [a for a in shrink_axes if a not in shape]
        if unknown:
            raise ValueError(
                f"shrink_axes {unknown} not in mesh axes {tuple(names)}"
            )
    fixed = int(np.prod([shape[n] for n in names if n not in shrink_axes]))
    cur = [shape[n] for n in shrink_axes]
    best: tuple[int, ...] | None = None
    best_prod = 0

    def search(idx: int, acc: tuple[int, ...], prod: int) -> None:
        nonlocal best, best_prod
        # remaining axes contribute a factor >= 1 each, so prod*fixed is a
        # lower bound on the finished candidate — prune overshoots early
        if prod * fixed > target:
            return
        if idx == len(cur):
            if prod > best_prod:
                best, best_prod = acc, prod
            return
        for v in range(cur[idx], 0, -1):
            search(idx + 1, acc + (v,), prod * v)

    search(0, (), 1)
    if best is None:
        # even the all-ones shrink exceeds the survivors (fixed axes alone
        # are too big): report the degenerate minimum and let the caller
        # decide (the decode fleet drops to meshless dispatch)
        best = tuple(1 for _ in cur)
    new_shape = tuple(
        best[shrink_axes.index(n)] if n in shrink_axes else shape[n] for n in names
    )
    return RescalePlan(
        old_shape=tuple(shape[n] for n in names),
        new_shape=new_shape,
        axis_names=tuple(names),
        dropped_chips=total - int(np.prod(new_shape)),
    )


def plan_decode_rescale(
    mesh,
    block_axes: tuple[str, ...],
    lost_chips: int,
) -> RescalePlan | None:
    """Rescale plan for a decode-fleet mesh: only the engine's lane-carrying
    ``block_axes`` may shrink.

    Returns ``None`` when no valid smaller mesh exists — the survivors
    cannot host even the all-ones shrink — in which case the caller should
    drop to meshless dispatch (:func:`rescale_decode_engine` does).
    """
    plan = plan_rescale(mesh, lost_chips, shrink_axes=block_axes)
    total = int(np.prod(plan.old_shape))
    if plan.new_chip_count > total - int(lost_chips) or plan.new_chip_count < 1:
        return None
    return plan


def rescale_decode_engine(engine, lost_chips: int):
    """A replacement engine for ``engine`` after ``lost_chips`` devices died.

    Shrinks the mesh along the engine's ``block_axes`` per
    :func:`plan_decode_rescale` and rebuilds the engine on the smaller mesh
    (the first devices of the old one); when no useful mesh survives (no
    plan, or a single-chip remnant) the engine drops to meshless dispatch.
    ``cfg``, ``shard_dispatch`` and the engine's device are kept. Either way
    the decode is bit-exact to the original engine, so a serving layer can
    swap engines under live sessions and replay their ready-but-undecoded
    blocks from session state. A meshless engine is returned unchanged. A
    mesh that spans processes is refused with ``ValueError``: a lost rank
    ends the process group, so the mesh cannot shrink onto the survivors.
    """
    from repro_torch.core.engine import DecoderEngine
    from repro_torch.launch.mesh import shrink_mesh

    if engine.mesh is None:
        return engine
    if engine.mesh.spans_processes:
        raise ValueError(
            f"rescale_decode_engine: the engine's mesh spans "
            f"{engine.mesh.process_count} processes; a lost rank ends the process "
            f"group, so the mesh cannot shrink onto the survivors (restart the fleet "
            f"with fewer ranks)"
        )
    plan = plan_decode_rescale(engine.mesh, engine.block_axes, lost_chips)
    if plan is None or plan.new_chip_count < 2:
        return DecoderEngine(
            engine.cfg,
            device=engine.device,
            mesh=None,
            block_axes=("data",),
            shard_dispatch=engine.shard_dispatch,
        )
    return DecoderEngine(
        engine.cfg,
        device=engine.device,
        mesh=shrink_mesh(engine.mesh, plan.new_shape),
        block_axes=engine.block_axes,
        shard_dispatch=engine.shard_dispatch,
    )


def reshard(tree: Any, axes_tree: Any, new_mesh, rules_map=None) -> Any:
    """Move a tree onto ``new_mesh`` with its logical axes re-resolved: its
    leaves (tensors, numpy arrays or :class:`~repro_torch.sharding.place.Placed`)
    are gathered to the host and placed per ``tree_shardings`` under
    ``rules_map`` (``None``: the default rules for the mesh's axes)."""
    from repro_torch.sharding.place import gather_tree, place_tree
    from repro_torch.sharding.rules import (DEFAULT_RULES, SINGLE_POD_RULES, LogicalRules,
                                            tree_shardings)

    if rules_map is None:
        rules_map = DEFAULT_RULES if "pod" in new_mesh.axis_names else SINGLE_POD_RULES
    rules = LogicalRules(new_mesh, rules_map)
    host = gather_tree(tree, "cpu")
    return place_tree(host, tree_shardings(host, axes_tree, rules))
