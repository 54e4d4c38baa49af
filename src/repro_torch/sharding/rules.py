"""Logical-axis sharding rules, after ``repro.sharding.rules``.

Model code names each array's axes logically (``("batch", "seq",
"embed")``); a rule set maps logical names to mesh axes. The rules are the
reference's, and so is :meth:`LogicalRules.spec`: the same mesh axes, the
same greedy divisibility fallback, the same dropping of rules that name an
axis the mesh lacks. A mesh is any object with ``axis_names`` and an
ordered ``shape`` mapping (a :class:`~repro_torch.launch.mesh.DecodeMesh`,
or a shape-only stand-in).

Default production mapping (see DESIGN.md §6):

  batch   → ("pod", "data")   activations data-parallel across pods × hosts
  fsdp    → "data"            parameters fully sharded over the data axis
  heads/kv/mlp/vocab/expert_mlp → "model"
  seq_ctx → "model"           context parallelism for long-sequence decode

The port runs in one process over explicit device lists, so a rule context
changes no value by itself: :func:`shard` returns its input, kept at every
place the reference annotates. The code that has its own arithmetic or its
own memory per device reads the rules: the tensor-parallel layers (each
``model`` position of a data shard computes with the slice
:func:`model_split` and :func:`model_slice` give it, at the grid index
:func:`model_positions` gives it), MoE's expert-parallel path, the
context-parallel cache, the mesh train step and the placement of a tree
(:func:`tree_shardings` → :class:`NamedSharding`, placed by
``sharding.place.place_tree``).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import threading
from typing import Mapping, Sequence

__all__ = [
    "PartitionSpec",
    "NamedSharding",
    "LogicalRules",
    "axis_rules",
    "current_rules",
    "shard",
    "logical_to_spec",
    "named_sharding",
    "tree_shardings",
    "on_shard",
    "shard_position",
    "on_position",
    "current_position",
    "mesh_position",
    "batch_shards",
    "context_state",
    "restored_context",
    "block_mesh_axes",
    "MODEL_AXIS",
    "model_size",
    "model_split",
    "model_slice",
    "model_positions",
    "DEFAULT_RULES",
    "SINGLE_POD_RULES",
]

# logical axis name → mesh axis (or tuple of mesh axes), None → replicated
DEFAULT_RULES: dict[str, str | tuple[str, ...] | None] = {
    "batch": ("pod", "data"),
    "fsdp": "data",
    "embed": None,
    "seq": None,
    "seq_ctx": "model",  # context-parallel KV for long decode
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    # `experts` is listed before `expert_mlp` in every MoE axes tuple: when
    # n_experts divides the model axis the experts shard and the hidden dim
    # replicates; when it does not, the divisibility fallback drops
    # `experts` and the hidden dim takes the model axis instead.
    "experts": "model",
    "expert_mlp": "model",
    "conv": None,
    "state": None,
    "blocks": ("pod", "data"),  # PBVD parallel blocks
}

SINGLE_POD_RULES = dict(DEFAULT_RULES, batch="data", blocks="data")

#: the mesh axis whose positions split a layer's computation (tensor parallelism)
MODEL_AXIS = "model"

_local = threading.local()


class PartitionSpec(tuple):
    """One entry per array dimension: a mesh axis name, a tuple of names
    (the dimension split over their product, major first) or ``None``
    (replicated). The stand-in for ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


def _axes_of(part) -> tuple[str, ...]:
    return () if part is None else (part,) if isinstance(part, str) else tuple(part)


class NamedSharding:
    """A :class:`PartitionSpec` over a mesh. Each mesh position holds the
    tile of the global array that :meth:`indices` gives it; positions that
    differ only along axes the spec does not name hold the same tile."""

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, PartitionSpec(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({dict(self.mesh.shape)}, {self.spec!r})"

    def splits(self, ndim: int) -> list[int]:
        """How many tiles each of ``ndim`` dimensions is cut into."""
        parts = list(self.spec) + [None] * (ndim - len(self.spec))
        return [math.prod(int(self.mesh.shape[a]) for a in _axes_of(p)) for p in parts]

    def shard_shape(self, global_shape: Sequence[int]) -> tuple[int, ...]:
        """One tile's shape; a dimension its split does not divide raises."""
        out = []
        for dim, n in zip(global_shape, self.splits(len(global_shape))):
            if dim % n:
                raise ValueError(f"dimension {dim} of {tuple(global_shape)} does not split "
                                 f"{n} ways under {self.spec!r}")
            out.append(dim // n)
        return tuple(out)

    def block(self, position: Sequence[int], ndim: int) -> tuple[int, ...]:
        """The tile coordinates (one per dimension) of the mesh position
        ``position`` (one index per mesh axis): along each dimension, the
        row-major index over the dimension's mesh axes."""
        where = dict(zip(self.mesh.axis_names, position))
        parts = list(self.spec) + [None] * (ndim - len(self.spec))
        coords = []
        for p in parts:
            c = 0
            for a in _axes_of(p):
                c = c * int(self.mesh.shape[a]) + int(where[a])
            coords.append(c)
        return tuple(coords)

    def indices(self, global_shape: Sequence[int], position: Sequence[int]) -> tuple[slice, ...]:
        """The slices of the global array that mesh position ``position`` holds."""
        shape = self.shard_shape(global_shape)
        return tuple(slice(c * n, (c + 1) * n)
                     for c, n in zip(self.block(position, len(shape)), shape))

    def devices_indices_map(self, global_shape: Sequence[int]) -> dict:
        """Every mesh position (a grid index; a device list may repeat a
        device) → (its device, the slices of the global array it holds)."""
        grid = self.mesh.devices
        return {pos: (grid[pos], self.indices(global_shape, pos))
                for pos in itertools.product(*(range(n) for n in grid.shape))}


class LogicalRules:
    def __init__(self, mesh, rules: Mapping[str, str | tuple[str, ...] | None]):
        if getattr(mesh, "spans_processes", False):
            raise ValueError(
                "the LM's logical rules run in one process over a device list; this "
                "mesh spans processes (only the decoder's lane split crosses them)"
            )
        self.mesh = mesh
        self.rules = dict(rules)
        # drop mappings that reference axes the mesh doesn't have
        for k, v in list(self.rules.items()):
            axes = (v,) if isinstance(v, str) else (v or ())
            if any(a not in mesh.axis_names for a in axes):
                self.rules[k] = None

    def spec(self, logical_axes: Sequence[str | None],
             shape: Sequence[int] | None = None) -> PartitionSpec:
        """Map logical axes to a PartitionSpec. With ``shape`` given, mesh
        axes that do not divide the corresponding dimension are dropped
        greedily (e.g. GQA kv=8 on a 16-way model axis falls back to
        replicated KV); a mesh axis is used by one dimension at most.
        Worked out once per (axes, shape)."""
        key = (tuple(logical_axes), None if shape is None else tuple(shape))
        memo = self.__dict__.setdefault("_specs", {})
        if key not in memo:
            memo[key] = self._spec(*key)
        return memo[key]

    def _spec(self, logical_axes, shape) -> PartitionSpec:
        parts = []
        used: set[str] = set()
        for i, ax in enumerate(logical_axes):
            m = None if ax is None else self.rules.get(ax)
            if m is None:
                parts.append(None)
                continue
            maxes = (m,) if isinstance(m, str) else tuple(m)
            maxes = tuple(a for a in maxes if a not in used)
            if shape is not None:
                dim = shape[i]
                while maxes:
                    prod = math.prod(int(self.mesh.shape[a]) for a in maxes)
                    if prod and dim % prod == 0:
                        break
                    maxes = maxes[:-1]
            used.update(maxes)
            if not maxes:
                parts.append(None)
            elif len(maxes) == 1:
                parts.append(maxes[0])
            else:
                parts.append(maxes)
        return PartitionSpec(*parts)


def current_rules() -> LogicalRules | None:
    return getattr(_local, "rules", None)


@contextlib.contextmanager
def axis_rules(mesh, rules: Mapping[str, str | tuple[str, ...] | None] | None = None):
    """Activate a logical→mesh rule set for the enclosed code (this thread)."""
    prev = getattr(_local, "rules", None)
    if rules is None:
        rules = DEFAULT_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES
    _local.rules = LogicalRules(mesh, rules)
    try:
        yield _local.rules
    finally:
        _local.rules = prev


def shard_position() -> dict[str, int] | None:
    """The mesh coordinates (axis → index) the enclosing :func:`on_shard`
    confines the computation to, else ``None``."""
    return getattr(_local, "position", None)


@contextlib.contextmanager
def on_shard(position: Mapping[str, int]):
    """Run the enclosed code as the computation of one data shard: its
    arrays are already that shard's slice (the mesh train step runs each
    data shard's forward so), and code that splits over the mesh (MoE's
    expert-parallel path) splits only along the other axes."""
    prev = getattr(_local, "position", None)
    _local.position = dict(position)
    try:
        yield
    finally:
        _local.position = prev


@contextlib.contextmanager
def on_position(position: Sequence[int]):
    """Name the mesh position (grid index) the enclosed code computes on:
    code that runs per position in turn (the per-tile AdamW update, MoE's
    expert-parallel shards) says so for the work counter
    (``launch/cost.py``); no value changes."""
    prev = getattr(_local, "mesh_pos", None)
    _local.mesh_pos = tuple(position)
    try:
        yield
    finally:
        _local.mesh_pos = prev


def current_position() -> tuple[int, ...] | None:
    """The grid index of the mesh position the current computation runs on:
    the one :func:`on_position` names, else the first position of the data
    shard :func:`on_shard` pins, else the mesh's first position under a rule
    context; ``None`` without one."""
    pos = getattr(_local, "mesh_pos", None)
    if pos is not None:
        return pos
    rules = getattr(_local, "rules", None)
    if rules is None:
        return None
    coords = getattr(_local, "position", None) or {}
    key = (tuple(rules.mesh.axis_names), tuple(coords.items()))
    pos = _POSITIONS.get(key)
    if pos is None:
        pos = _POSITIONS[key] = mesh_position(rules.mesh, coords)
    return pos


_POSITIONS: dict = {}  # (mesh axes, shard coordinates) → grid index


def mesh_position(mesh, coords: Mapping[str, int]) -> tuple[int, ...]:
    """The grid index of the mesh position at ``coords`` (axes not named: 0)."""
    return tuple(int(coords.get(a, 0)) for a in mesh.axis_names)


def model_size() -> int:
    """The size of the active rules' ``model`` mesh axis: 1 without rules or
    without that axis."""
    rules = current_rules()
    if rules is None or MODEL_AXIS not in rules.mesh.axis_names:
        return 1
    return int(rules.mesh.shape[MODEL_AXIS])


def model_split(logical_axes: Sequence[str | None], shape: Sequence[int]) -> tuple[int | None, int]:
    """(the dimension that the ``model`` axis splits, into how many slices)
    for a leaf of these logical axes and shape under the active rules, by
    :meth:`LogicalRules.spec` with ``shape=``: its greedy divisibility
    fallback leaves e.g. ``kv_heads`` = 2 whole on a 4-way axis. ``(None,
    1)`` where the rules leave every dimension whole along ``model``."""
    if model_size() == 1:
        return None, 1
    spec = current_rules().spec(logical_axes, shape=tuple(shape))
    for i, part in enumerate(spec):
        if part == MODEL_AXIS:
            return i, model_size()
    return None, 1


def model_slice(logical_axes: Sequence[str | None], shape: Sequence[int],
                m: int) -> tuple[slice, ...]:
    """The slices of a leaf (logical axes, shape) that model position ``m``
    holds under the active rules: all of it where :func:`model_split` says
    the leaf is whole."""
    dim, n = model_split(logical_axes, shape)
    out = [slice(None)] * len(shape)
    if dim is not None:
        size = shape[dim] // n
        out[dim] = slice(m * size, (m + 1) * size)
    return tuple(out)


def model_positions(coords: Mapping[str, int] | None = None) -> list[tuple[int, ...]]:
    """The grid index of each ``model`` position of a data shard, in model
    order. ``coords`` are the data shard's mesh coordinates (default: the
    shard :func:`on_shard` pins, else the first)."""
    rules = current_rules()
    if coords is None:
        coords = shard_position() or {}
    key = (id(rules), tuple(coords.items()))
    out = _MODEL_POSITIONS.get(key)
    if out is None or out[0] is not rules:
        out = _MODEL_POSITIONS[key] = (rules, [
            mesh_position(rules.mesh, {**coords, MODEL_AXIS: m}) for m in range(model_size())])
    return out[1]


_MODEL_POSITIONS: dict = {}  # (rules, shard coordinates) → the model positions


def batch_shards(shape: Sequence[int]) -> list[tuple[dict[str, int], slice]]:
    """The data shards of an array whose leading axis is ``batch``:
    ``[(mesh coordinates, rows)]``, the rows cut along the mesh axes of the
    batch's spec at this shape (the reference's ``x_spec``), row-major.
    Under :func:`on_shard` the array is that shard's already: one entry,
    all rows."""
    pinned = shard_position()
    if pinned is not None:
        return [(pinned, slice(None))]
    rules = current_rules()
    axes = _axes_of(rules.spec(("batch",), shape=(shape[0],))[0])
    sizes = [int(rules.mesh.shape[a]) for a in axes]
    n = math.prod(sizes)
    rows = shape[0] // n
    out = []
    for b in range(n):
        coords, rest = {}, b
        for a, size in reversed(list(zip(axes, sizes))):
            coords[a], rest = rest % size, rest // size
        out.append((coords, slice(b * rows, (b + 1) * rows)))
    return out


def context_state():
    """This thread's rule context and shard position, for :func:`restored_context`."""
    return current_rules(), shard_position()


@contextlib.contextmanager
def restored_context(state):
    """Re-enter a :func:`context_state` (e.g. in the autograd engine's
    thread, where a checkpointed layer is recomputed)."""
    prev = context_state()
    _local.rules, _local.position = state
    try:
        yield
    finally:
        _local.rules, _local.position = prev


def logical_to_spec(logical_axes: Sequence[str | None]) -> PartitionSpec:
    r = current_rules()
    if r is None:
        return PartitionSpec()
    return r.spec(logical_axes)


def named_sharding(logical_axes: Sequence[str | None]) -> NamedSharding | None:
    r = current_rules()
    if r is None:
        return None
    return NamedSharding(r.mesh, r.spec(logical_axes))


def shard(x, logical_axes: Sequence[str | None]):
    """The reference's sharding annotation: ``x`` itself, in a rule context
    or not (in one process the code that computes per position splits its
    work itself)."""
    return x


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_shardings(tree, axes_tree, rules: LogicalRules):
    """Shape-aware :class:`NamedSharding` for every leaf of ``tree``.

    ``axes_tree`` mirrors ``tree`` (dicts, lists and named tuples) with
    logical-axis tuples as leaves; a leaf of ``tree`` is anything with a
    ``shape`` (a tensor, a placed tensor, a numpy array). Returns the
    structure of ``tree`` with a sharding per leaf."""
    if isinstance(tree, dict):
        if set(tree) != set(axes_tree):
            raise ValueError(f"tree keys {sorted(tree)} differ from axes keys {sorted(axes_tree)}")
        return {k: tree_shardings(v, axes_tree[k], rules) for k, v in tree.items()}
    if _is_namedtuple(tree) or isinstance(tree, list):
        if len(tree) != len(axes_tree):
            raise ValueError(f"tree has {len(tree)} entries but axes tree has {len(axes_tree)}")
        out = [tree_shardings(v, a, rules) for v, a in zip(tree, axes_tree)]
        return type(tree)(*out) if _is_namedtuple(tree) else out
    if tree is None:
        return None
    if type(axes_tree) is not tuple:
        raise ValueError(f"leaf of shape {tuple(tree.shape)} has axes {axes_tree!r}")
    return NamedSharding(rules.mesh, rules.spec(axes_tree, shape=tuple(tree.shape)))


def block_mesh_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the PBVD ``blocks`` logical axis maps to on ``mesh``.

    Resolves the ``"blocks"`` rule (``("pod", "data")`` multi-pod,
    ``"data"`` single-pod) and drops axes the mesh does not have — the
    engine's default ``block_axes`` when bound to a mesh without an explicit
    override (``DecoderEngine(cfg, mesh=m, block_axes=None)``).
    """
    rules = DEFAULT_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES
    m = rules["blocks"]
    axes = (m,) if isinstance(m, str) else tuple(m or ())
    resolved = tuple(a for a in axes if a in mesh.axis_names)
    if not resolved:
        raise ValueError(
            f"no 'blocks' rule axis {axes} exists on mesh axes "
            f"{tuple(mesh.axis_names)}; pass block_axes explicitly"
        )
    return resolved
