"""Placement of tensors over a mesh by their :class:`~repro_torch.sharding.rules.NamedSharding`.

The counterpart of ``jax.device_put(x, sharding)`` and of gathering a
sharded array back, in one process over a device list: a
:class:`Placed` tensor holds one tile per mesh position, on that
position's device. Positions that differ only along mesh axes the spec
does not name hold the same slice (replicas). A list may name one device
more than once (``["cpu"] * 8``, ``[cuda:0] * 4``): the tiles are then
separate tensors on one device.

    shardings = tree_shardings(tree, axes_tree, LogicalRules(mesh, rules))
    placed = place_tree(tree, shardings)      # each device holds its tile
    back = gather_tree(placed, "cpu")         # == tree, bit for bit

Tensor parallelism over the ``model`` axis, one data shard at a time:
:func:`model_tile` is the slice of a parameter that a model position
computes with, on its device (a :class:`Placed` leaf's own tile, joined
along ``fsdp`` where that splits it too; a plain tensor's slice by the
rules); :func:`model_parts` runs a function at each model position of
each data shard and joins the parts; :func:`model_reduce` is the
reference's all-reduce over ``model``: the positions' partial sums (or
maxima) reduced on the data shard's first position in model order,
recorded by a work counter as
``"all-reduce"`` bytes at each position (the partial's, the operand size
the reference's HLO analyzer counts); :func:`model_parts` with ``then``
runs a layer in two passes over the positions, with one such sum between
them, handed to every position (Mamba's ``x_proj``, whose output
``dt_proj`` reads column-parallel).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.launch import cost as _cost
from .rules import (MODEL_AXIS, NamedSharding, _axes_of, _is_namedtuple, batch_shards,
                    current_rules, model_positions, model_slice, on_position)

__all__ = ["Placed", "place", "place_zeros", "place_tree", "gather_tree", "map_tree",
           "zip_tree", "model_tile", "model_reduce", "model_parts",
           "join_model_parts"]


class Placed:
    """A global tensor of ``shape`` laid over ``sharding.mesh``: ``tiles``
    is a numpy object array shaped like the mesh's device grid whose entry
    at each position is that position's tile, on its device."""

    def __init__(self, sharding: NamedSharding, shape, tiles: np.ndarray):
        self.sharding, self.shape, self.tiles = sharding, torch.Size(shape), tiles
        self._block_positions = None
        self._model_plans: dict = {}

    def __repr__(self) -> str:
        return f"Placed({tuple(self.shape)}, {self.dtype}, {self.sharding!r})"

    @property
    def dtype(self) -> torch.dtype:
        return self.tiles.flat[0].dtype

    @property
    def device(self) -> torch.device:
        """The first mesh position's device."""
        return self.tiles.flat[0].device

    @property
    def requires_grad(self) -> bool:
        """Whether a tile takes a gradient (the mesh train step's do)."""
        return any(t.requires_grad for t in self.tiles.flat)

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def positions(self):
        return itertools.product(*(range(n) for n in self.tiles.shape))

    def blocks(self) -> dict[tuple[int, ...], torch.Tensor]:
        """Each distinct tile once, keyed by its tile coordinates: the tile of
        the first mesh position that holds that slice."""
        return {coords: self.tiles[pos] for coords, pos in self.block_positions().items()}

    def block_positions(self) -> dict[tuple[int, ...], tuple[int, ...]]:
        """The first mesh position that holds each distinct tile, keyed by
        the tile's coordinates (a function of the sharding and the shape:
        worked out once)."""
        if self._block_positions is None:
            out: dict[tuple[int, ...], tuple[int, ...]] = {}
            for pos in self.positions():
                out.setdefault(self.sharding.block(pos, self.ndim), pos)
            self._block_positions = out
        return self._block_positions

    def block_slices(self, coords: tuple[int, ...]) -> tuple[slice, ...]:
        """The slices of the global tensor that the tile at ``coords`` holds."""
        shape = self.sharding.shard_shape(self.shape)
        return tuple(slice(c * n, (c + 1) * n) for c, n in zip(coords, shape))

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (``None``: the first position's),
        joined from the distinct tiles; differentiable, and the tile itself
        when there is one on that device."""
        device = self.device if device is None else torch.device(device)
        blocks = self.blocks()
        out = self._join(blocks, device, {})
        counter = _cost.active()
        if counter is not None:
            self._count_gather(counter, blocks, out)
        return out

    def _join(self, blocks: dict, device, fixed: dict[int, int]) -> torch.Tensor:
        """``blocks`` (tile coordinates → tile) joined on ``device``; a
        dimension in ``fixed`` takes only its tile coordinate there."""
        splits = self.sharding.splits(self.ndim)

        def join(prefix: tuple[int, ...]) -> torch.Tensor:
            dim = len(prefix)
            if dim == len(splits):
                return blocks[prefix].to(device)
            which = [fixed[dim]] if dim in fixed else range(splits[dim])
            parts = [join(prefix + (i,)) for i in which]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

        return join(())

    def model_tile(self, pos: tuple[int, ...]) -> torch.Tensor:
        """What mesh position ``pos`` computes with under tensor parallelism:
        the slice of the global tensor along the dimension that ``model``
        splits which ``pos`` holds, whole along every other dimension. That
        is ``pos``'s own tile, where no other mesh axis splits the tensor
        (the serving layout); else its tile joined with the other tiles of
        its model slice (``fsdp``'s), differentiable, the gather recorded
        as :meth:`full`'s is."""
        plan = self._model_plans.get(pos, False)
        if plan is False:
            plan = self._model_plans[pos] = self._model_plan(pos)
        if plan is None:
            return self.tiles[pos]
        here, fixed, members = plan
        blocks = {c: self.tiles[pos if c == here else at] for c, at in members}
        out = self._join(blocks, self.tiles[pos].device, fixed)
        counter = _cost.active()
        if counter is not None:
            with on_position(pos):
                self._count_gather(counter, blocks, out)
        return out

    def _model_plan(self, pos):
        """``None`` where ``pos``'s own tile is its model slice; else (its
        tile coordinates, the dimensions ``model`` fixes → their
        coordinate, [(coordinates, first holder) of the tiles it joins])."""
        parts = list(self.sharding.spec) + [None] * (self.ndim - len(self.sharding.spec))
        if all(not _axes_of(p) or MODEL_AXIS in _axes_of(p) for p in parts):
            return None
        here = self.sharding.block(pos, self.ndim)
        fixed = {i: here[i] for i, p in enumerate(parts) if MODEL_AXIS in _axes_of(p)}
        members = [(c, at) for c, at in self.block_positions().items()
                   if all(c[i] == v for i, v in fixed.items())]
        return here, fixed, members

    def _count_gather(self, counter, blocks: dict, out: torch.Tensor) -> None:
        """A work counter's record of :meth:`full` at the current position:
        the tiles other positions hold come in (``all-gather``) and, when
        ``out`` takes a gradient, go back in its backward
        (``reduce-scatter``)."""
        pos = counter.position()
        here = self.sharding.block(pos, self.ndim) if len(pos) == self.tiles.ndim else None
        nbytes = sum(t.numel() * t.element_size() for c, t in blocks.items() if c != here)
        if not nbytes:
            return
        counter.collective("all-gather", nbytes, pos)
        if out.requires_grad and out.grad_fn is not None:
            out.register_hook(lambda g: counter.collective("reduce-scatter", nbytes, pos))

    @torch.no_grad()
    def copy_(self, full: torch.Tensor) -> "Placed":
        """Write the global tensor ``full`` into every tile, in place."""
        for pos in self.positions():
            tile = self.tiles[pos]
            tile.copy_(full[self.sharding.indices(self.shape, pos)])
        return self


def place(t: torch.Tensor, sharding: NamedSharding, *, copy: bool = False) -> Placed:
    """Lay ``t`` over ``sharding.mesh``. A tile on ``t``'s own device is a
    view of ``t`` unless ``copy``; with ``copy`` every tile is a tensor of
    its own (so that tiles can be updated one by one)."""
    tiles = np.empty(sharding.mesh.devices.shape, dtype=object)
    for pos, (dev, sl) in sharding.devices_indices_map(t.shape).items():
        tile = t[sl].to(dev)
        tiles[pos] = tile.clone() if copy and tile.device == t.device else tile
    return Placed(sharding, t.shape, tiles)


def place_zeros(shape, dtype: torch.dtype, sharding: NamedSharding) -> Placed:
    """A zero tensor of ``shape`` laid over ``sharding.mesh``: each
    position's tile allocated on its device (no global buffer)."""
    tile_shape = sharding.shard_shape(shape)
    tiles = np.empty(sharding.mesh.devices.shape, dtype=object)
    for pos, (dev, _) in sharding.devices_indices_map(shape).items():
        tiles[pos] = torch.zeros(tile_shape, dtype=dtype, device=dev)
    return Placed(sharding, shape, tiles)


def map_tree(fn, tree):
    """``fn`` over the leaves of a tree of dicts, lists and named tuples
    (``None`` stays ``None``)."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_tree(fn, v) for v in tree))
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return None if tree is None else fn(tree)


def zip_tree(fn, tree, other):
    """``fn(leaf, other_leaf)`` over the leaves of ``tree`` and a tree
    ``other`` of the same structure (its leaves may be tuples)."""
    if isinstance(tree, dict):
        return {k: zip_tree(fn, v, other[k]) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(zip_tree(fn, v, o) for v, o in zip(tree, other)))
    if isinstance(tree, list):
        return [zip_tree(fn, v, o) for v, o in zip(tree, other)]
    return fn(tree, other)


def place_tree(tree, shardings):
    """:func:`place` every leaf of ``tree`` by the matching leaf of
    ``shardings`` (the structure :func:`~repro_torch.sharding.rules.tree_shardings`
    returns; a ``None`` sharding leaves its leaf as it is). Numpy leaves
    become CPU tensors first."""
    def one(leaf, sharding):
        if sharding is None or leaf is None:
            return leaf
        if isinstance(leaf, Placed):
            leaf = leaf.full()
        return place(torch.as_tensor(leaf), sharding)

    return zip_tree(one, tree, shardings)


def gather_tree(tree, device=None):
    """The inverse of :func:`place_tree`: every :class:`Placed` leaf joined
    into its global tensor on ``device`` (``None``: its first device)."""
    return map_tree(lambda leaf: leaf.full(device) if isinstance(leaf, Placed) else leaf, tree)


# ---- tensor parallelism over the ``model`` axis ------------------------------------------
def model_tile(leaf, logical_axes, m: int, coords=None) -> torch.Tensor:
    """The slice of the parameter ``leaf`` (logical axes ``logical_axes``)
    that model position ``m`` of the data shard at ``coords`` (default: the
    pinned or first one) computes with, on that position's device: a
    :class:`Placed` leaf's :meth:`Placed.model_tile` (no copy in the
    serving layout), a plain tensor's :func:`~repro_torch.sharding.rules.model_slice`."""
    pos = model_positions(coords)[m]
    if isinstance(leaf, Placed):
        return leaf.model_tile(pos)
    return leaf[model_slice(logical_axes, leaf.shape, m)].to(current_rules().mesh.devices[pos])


def model_reduce(parts: list[torch.Tensor], positions, op=torch.add) -> torch.Tensor:
    """``op`` over the model positions' ``parts`` in model order, on the
    first part's device, in the parts' dtype: the reference's all-reduce
    over ``model`` (``torch.add``: its sum of row-parallel partials;
    ``torch.maximum``: its max). A sum of bf16 partials accumulates in
    float32 and is rounded once, as one device's product accumulates its
    terms, so that the split adds only the partials' own rounding. A work
    counter records each part's bytes as ``"all-reduce"`` at its position."""
    out = parts[0].float() if op is torch.add else parts[0]
    for part in parts[1:]:
        out = op(out, part.to(out.device, out.dtype))
    out = out.to(parts[0].dtype)
    counter = _cost.active()
    if counter is not None and len(parts) > 1:
        for part, pos in zip(parts, positions):
            counter.collective("all-reduce", part.numel() * part.element_size(), pos)
    return out


def model_parts(x: torch.Tensor, fn, n: int, join=model_reduce, then=None):
    """Run ``fn(m, x_rows, coords)`` at model positions 0..n-1 of each data
    shard of ``x`` (its leading axis ``batch``: the rows of the shard, on
    the position's device, under ``on_position``) and join each shard's
    parts with ``join(parts, positions)`` on its first position; the
    shards' results are joined along the rows on x's device. ``n`` is 1
    where the rules leave the work whole: it runs once, on the first
    position. ``join=None`` returns the list of the n parts, each on its
    position's device (the shards' rows joined on the first shard's).

    With ``then`` the layer runs in two passes: ``fn`` gives (the
    position's partial, what it keeps for the second pass), the partials
    are reduced in model order on the shard's first position
    (:func:`model_reduce`, recorded as ``"all-reduce"`` at each position)
    and the sum handed to every position, where ``then(m, kept, total,
    coords)`` gives its part (Mamba's ``x_proj``, whose output ``dt_proj``
    reads column-parallel)."""
    mesh = current_rules().mesh
    outs = []
    for coords, rows in batch_shards(x.shape):
        positions = model_positions(coords)[:n]
        xs = x[rows]
        parts = []
        for m, pos in enumerate(positions):
            with on_position(pos):
                parts.append(fn(m, xs.to(mesh.devices[pos]), coords))
        if then is not None:
            kept = [k for _, k in parts]
            with on_position(positions[0]):
                total = parts[0][0] if n == 1 else model_reduce([p for p, _ in parts], positions)
            parts = []
            for m, pos in enumerate(positions):
                with on_position(pos):
                    parts.append(then(m, kept[m], total.to(mesh.devices[pos]), coords))
        if join is None:
            outs.append(parts)
            continue
        with on_position(positions[0]):
            y = parts[0] if n == 1 else join(parts, positions)
        outs.append(y.to(x.device))
    if join is None:
        if len(outs) == 1:
            return outs[0]
        return [torch.cat([o[m].to(outs[0][m].device) for o in outs], 0) for m in range(n)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, 0)


def join_model_parts(parts: list[torch.Tensor], dim: int = -1) -> torch.Tensor:
    """Column-parallel outputs (one per model position, in model order)
    joined along ``dim`` on the first part's device; a work counter records
    the others' bytes there as ``"all-gather"``."""
    if len(parts) == 1:
        return parts[0]
    dev = parts[0].device
    counter = _cost.active()
    if counter is not None:
        counter.collective("all-gather", sum(p.numel() * p.element_size() for p in parts[1:]))
    return torch.cat([p.to(dev) for p in parts], dim)
