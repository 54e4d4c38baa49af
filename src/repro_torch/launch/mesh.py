"""Device meshes over device lists: the port's stand-in for ``jax.sharding.Mesh``.

A mesh is a named grid of ``torch.device`` objects, driven by one process,
or for the decoder by every process of a process group (below). The
decoder shards nothing but its lane axis (the flattened frames ×
parallel-blocks axis), and parallel blocks never interact, so for it a mesh
is only a placement over which :func:`repro_torch.sharding.smap.lane_split`
cuts the lanes. The LM uses the same :class:`DecodeMesh` under
``sharding.rules.axis_rules``: parameters and optimizer state placed per
the logical rules, MoE's experts split over ``model``, the context-parallel
cache's sequence tiles, the data-parallel train step and the pipeline's
stages, always in one process. The counterpart of ``repro.launch.mesh``: the production shapes
(:func:`make_production_mesh`), the local test meshes and the decode
fleet's, and :func:`maybe_init_distributed` for a multi-process start under
``torchrun``.

A device list may name one device more than once: ``["cpu"] * 8`` rehearses
an 8-way split on the CPU, and ``[torch.device("cuda", 0)] * 4`` splits the
lanes four ways on one card (four launches of each kernel, one after the
other on that card's stream). ``devices=None`` means every CUDA device torch
finds.

    mesh = make_decode_mesh("data=4", devices=["cpu"] * 4)
    engine = DecoderEngine(cfg, mesh=mesh)          # engine.device == cpu
    bits = engine.decode(y, n_bits)                 # == the meshless decode

**The decode fleet across processes.** Under an initialised process group,
:func:`make_decode_mesh` and :func:`make_local_mesh` lay the mesh over the
global device list: every rank's local devices (``devices``, or every CUDA
device torch finds on its host), in rank order, as ``jax.devices()`` orders
them across processes. The mesh records the rank that owns each position
(``owners``). Every rank runs the same command on the same streams; each
decodes the lane slices its own devices hold, and every rank ends with the
whole result, joined over the gloo group of :func:`fleet_group`:

    # per host i of N (same command everywhere, torchrun sets RANK):
    torchrun --nnodes N --nproc-per-node 1 --node-rank i \\
        --master-addr host0 --master-port 29500 \\
        -m repro_torch.launch.serve_decoder --mesh data=N --streams 64

    # two ranks on one card (or on the CPU with --device cpu):
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve_decoder \\
        --mesh data=2 --streams 64
"""

from __future__ import annotations

import collections
import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = [
    "DecodeMesh",
    "canonical_device",
    "fleet_group",
    "make_decode_mesh",
    "make_local_mesh",
    "make_production_mesh",
    "maybe_init_distributed",
    "parse_mesh_spec",
    "shrink_mesh",
]


def canonical_device(device, user: str = "DecodeMesh") -> torch.device:
    """``device`` through :func:`resolve_device` (a CUDA device torch cannot
    find raises :class:`~repro_torch.device.DeviceUnavailableError`), with a
    bare ``"cuda"`` pinned to the current CUDA device's index, so that
    ``"cuda"`` and ``"cuda:0"`` compare equal where they are one card."""
    dev = resolve_device(device, user=user)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _world() -> tuple[int, int]:
    """(this process's rank, the number of processes) of the default
    process group; ``(0, 1)`` when none is initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


_FLEET: dict = {}


def fleet_group():
    """The gloo group over every process of the default group: it carries
    the decode fleet's host traffic, the ranks' device lists when a mesh is
    built and the decoded bits at every join.

    Gloo whatever backend the default group took: NCCL refuses two ranks on
    one card, and the bits are read on the host in any case (the reference
    fetches them there too). The decoder never touches the default group's
    own backend. Made once per default group, at its first use; every rank
    must reach that use in the same order (``new_group`` is collective),
    which building a mesh in every rank does.
    """
    world = dist.group.WORLD
    if _FLEET.get("world") is not world:
        _FLEET["group"] = dist.new_group(backend="gloo")
        _FLEET["world"] = world
    return _FLEET["group"]


class DecodeMesh:
    """A named grid of devices: ``axis_names`` (a tuple), ``shape`` (an
    ordered name → size mapping, as ``jax.sharding.Mesh.shape``),
    ``devices`` (a numpy object array of ``torch.device`` shaped by the
    sizes) and ``size``.

    ``devices`` is a flat sequence of exactly ``prod(shape)`` devices laid
    out row-major. Every device must be of one type: a mesh that mixes CPU
    and CUDA devices is refused with ``ValueError``.

    ``owners`` gives the rank of the process that owns each position (a
    ``torch.device`` names no owner); ``None`` makes every position this
    process's. A mesh with owners spans the processes of the default group
    when it has more than one (``spans_processes``, ``process_count``);
    ``is_local`` marks this process's positions and ``local_devices`` lists
    them row-major. Only this process's devices are checked against what
    torch finds here.
    """

    def __init__(self, devices: Sequence, shape: Sequence[int], axis_names: Sequence[str],
                 *, owners: Sequence[int] | None = None):
        shape = tuple(int(n) for n in shape)
        axis_names = tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(
                f"mesh shape {shape} has {len(shape)} axes, axis_names has "
                f"{len(axis_names)} ({axis_names})"
            )
        rank, world = _world()
        devices = list(devices)
        ranks = [rank] * len(devices) if owners is None else [int(r) for r in owners]
        if len(ranks) != len(devices):
            raise ValueError(f"{len(ranks)} owners for {len(devices)} devices")
        devs = [canonical_device(d) if r == rank else torch.device(d)
                for d, r in zip(devices, ranks)]
        if len(devs) != math.prod(shape):
            raise ValueError(
                f"mesh shape {shape} needs {math.prod(shape)} devices, got {len(devs)}"
            )
        types = sorted({d.type for d in devs})
        if len(types) > 1:
            raise ValueError(
                f"mesh devices must be of one type, got {types} "
                f"({', '.join(str(d) for d in devs)})"
            )
        grid = np.empty(len(devs), dtype=object)
        grid[:] = devs
        self.devices = grid.reshape(shape)
        self.owners = np.asarray(ranks, dtype=np.int64).reshape(shape)
        self.process_index = rank
        self.process_count = world if owners is not None else 1
        self.axis_names = axis_names
        self.shape = collections.OrderedDict(zip(axis_names, shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def spans_processes(self) -> bool:
        return self.process_count > 1

    @property
    def is_local(self) -> np.ndarray:
        return self.owners == self.process_index

    @property
    def local_devices(self) -> list[torch.device]:
        return list(self.devices[self.is_local])


def _available_devices() -> list[torch.device]:
    """Every CUDA device torch finds; none raises DeviceUnavailableError."""
    resolve_device(None, user="make_decode_mesh")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _fleet_devices(devices, user: str) -> tuple[list, list[int]]:
    """The device list a mesh is laid over, and each entry's owning rank.

    In one process: ``devices`` (``None``: every CUDA device torch finds),
    all owned by it. Under a process group of more than one process: every
    rank's list, in rank order, exchanged over :func:`fleet_group`, so
    every rank must call this in the same order.
    """
    local = _available_devices() if devices is None else list(devices)
    rank, world = _world()
    if world == 1:
        return local, [rank] * len(local)
    lists = [None] * world
    dist.all_gather_object(lists, [str(canonical_device(d, user)) for d in local],
                           group=fleet_group())
    return ([torch.device(d) for names in lists for d in names],
            [r for r, names in enumerate(lists) for _ in names])


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> DecodeMesh:
    """The production mesh: ``(16, 16)`` over ``("data", "model")``, or
    ``(2, 16, 16)`` over ``("pod", "data", "model")`` with ``multi_pod``,
    laid over the first 256 or 512 entries of ``devices`` (``None``: every
    CUDA device torch finds). Too few devices raise ``ValueError`` naming
    the count."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    devs = _available_devices() if devices is None else list(devices)
    need = math.prod(shape)
    if len(devs) < need:
        raise ValueError(f"the production mesh {shape} over {axes} needs {need} devices, "
                         f"only {len(devs)} available")
    return DecodeMesh(devs[:need], shape, axes)


def maybe_init_distributed() -> bool:
    """Start the default ``torch.distributed`` process group from torchrun's
    environment, if configured.

    Returns True when ``init_process_group`` was called (``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK`` all set; ``MASTER_PORT`` defaults to
    29500), False for single-process runs and where a default group is up
    already (it is left as it is). The backend is NCCL when torch finds a
    CUDA device and gloo otherwise; the decode fleet's traffic goes over
    :func:`fleet_group` in either case. Call it before building a mesh: the
    recipe at the top of this module.
    """
    addr = os.environ.get("MASTER_ADDR")
    num = os.environ.get("WORLD_SIZE")
    rank = os.environ.get("RANK")
    if not (addr and num and rank) or dist.is_initialized():
        return False
    port = os.environ.get("MASTER_PORT", "29500")
    dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                            init_method=f"tcp://{addr}:{port}", world_size=int(num),
                            rank=int(rank))
    return True


def make_local_mesh(data: int | None = None, model: int = 1, *, devices=None) -> DecodeMesh:
    """Small ``(data, model)`` mesh over the first devices of ``devices``
    (tests and examples; ``None``: every CUDA device torch finds).

    Every invalid shape fails HERE with a clear ``ValueError`` — notably
    ``model`` not dividing the device count. Under a process group the
    devices are every rank's (module docstring).
    """
    devs, owners = _fleet_devices(devices, "make_local_mesh")
    n = len(devs)
    if model < 1:
        raise ValueError(f"model axis size must be >= 1, got {model}")
    if data is None:
        if n % model:
            raise ValueError(
                f"model={model} does not divide the {n} available device(s); "
                f"pick a divisor of {n} or pass data= explicitly"
            )
        data = n // model
    if data < 1:
        raise ValueError(f"data axis size must be >= 1, got {data}")
    if data * model > n:
        raise ValueError(
            f"mesh shape ({data}, {model}) needs {data * model} devices, "
            f"only {n} available"
        )
    return DecodeMesh(devs[: data * model], (data, model), ("data", "model"),
                      owners=owners[: data * model])


def parse_mesh_spec(spec: str) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """Parse ``"data=8"`` / ``"pod=2,data=4"`` → (axis names, axis sizes)."""
    names, sizes = [], []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, eq, size = part.partition("=")
        name = name.strip()
        try:
            n = int(size) if eq else -1
        except ValueError:
            n = -1
        if not name or n < 1:
            raise ValueError(
                f"bad mesh spec {spec!r}: expected AXIS=N[,AXIS=N...] with "
                f"positive integer sizes, got segment {part!r}"
            )
        if name in names:
            raise ValueError(f"bad mesh spec {spec!r}: axis {name!r} repeated")
        names.append(name)
        sizes.append(n)
    if not names:
        raise ValueError(f"bad mesh spec {spec!r}: no axes")
    return tuple(names), tuple(sizes)


def make_decode_mesh(spec: str, *, devices=None) -> DecodeMesh:
    """Build the decode-fleet mesh from a ``--mesh`` spec string.

    ``spec`` is ``"data=N"`` (or multi-axis ``"pod=2,data=8"``); the mesh is
    laid over the first ``prod(sizes)`` entries of ``devices`` (``None``:
    every CUDA device torch finds), so a sub-mesh of the available fleet is
    legal. A list may name one device more than once. Under a process group
    the list is every rank's, in rank order (module docstring).
    """
    names, sizes = parse_mesh_spec(spec)
    devs, owners = _fleet_devices(devices, "make_decode_mesh")
    need = math.prod(sizes)
    if need > len(devs):
        raise ValueError(
            f"mesh spec {spec!r} needs {need} devices, only {len(devs)} available"
        )
    return DecodeMesh(devs[:need], sizes, names, owners=owners[:need])


def shrink_mesh(mesh: DecodeMesh, new_shape, *, devices=None) -> DecodeMesh:
    """Rebuild ``mesh`` at ``new_shape`` (same axis names) over surviving
    devices — the mesh-loss fallback of
    :func:`repro_torch.launch.elastic.rescale_decode_engine`.

    ``devices`` lists the survivors explicitly; by default the first
    ``prod(new_shape)`` devices of the old mesh are kept. Device choice never
    affects decoded bits: the decode mesh only places independent lanes.
    """
    new_shape = tuple(int(n) for n in new_shape)
    if len(new_shape) != len(mesh.axis_names):
        raise ValueError(
            f"new_shape {new_shape} has {len(new_shape)} axes, mesh has "
            f"{len(mesh.axis_names)} ({tuple(mesh.axis_names)})"
        )
    need = 1
    for n in new_shape:
        if n < 1:
            raise ValueError(f"new_shape {new_shape} has a non-positive axis")
        need *= n
    devs = list(mesh.devices.flat) if devices is None else list(devices)
    if need > len(devs):
        raise ValueError(
            f"new_shape {new_shape} needs {need} devices, only {len(devs)} survive"
        )
    owners = list(mesh.owners.flat)[:need] if devices is None and mesh.spans_processes else None
    return DecodeMesh(devs[:need], new_shape, tuple(mesh.axis_names), owners=owners)
