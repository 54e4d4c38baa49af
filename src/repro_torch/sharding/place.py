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
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from repro_torch.launch import cost as _cost
from .rules import NamedSharding, _is_namedtuple

__all__ = ["Placed", "place", "place_zeros", "place_tree", "gather_tree", "map_tree",
           "zip_tree"]


class Placed:
    """A global tensor of ``shape`` laid over ``sharding.mesh``: ``tiles``
    is a numpy object array shaped like the mesh's device grid whose entry
    at each position is that position's tile, on its device."""

    def __init__(self, sharding: NamedSharding, shape, tiles: np.ndarray):
        self.sharding, self.shape, self.tiles = sharding, torch.Size(shape), tiles
        self._block_positions = None

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
        splits = self.sharding.splits(self.ndim)
        blocks = self.blocks()

        def join(prefix: tuple[int, ...]) -> torch.Tensor:
            dim = len(prefix)
            if dim == len(splits):
                return blocks[prefix].to(device)
            parts = [join(prefix + (i,)) for i in range(splits[dim])]
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

        out = join(())
        counter = _cost.active()
        if counter is not None:
            self._count_gather(counter, blocks, out)
        return out

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
