"""The work a step does: FLOPs, bytes and collective bytes per mesh position.

The port's replacement for ``repro.launch.hlo_analysis`` (replaced, not
ported). That module parses XLA's optimized HLO because XLA's
``cost_analysis`` counts a ``while`` body once whatever its trip count.
Eager torch has no HLO, and a counter that sees every dispatched op sees
every iteration of a Python loop, so there is no trip count to recover.

:class:`WorkCounter` is a ``TorchDispatchMode``. Inside it every aten op
records, at the mesh position it runs on:

* FLOPs, from torch's flop registry (``mm``, ``addmm``, ``bmm``,
  convolutions, SDPA: the products, as the reference counts ``dot`` and
  ``convolution``), split by the compute dtype of the operands: ``bf16``
  (bf16 and f16, the tensor cores), ``f32`` and ``int``;
* bytes: its tensor operands plus its outputs, the reference's
  per-top-level-op HBM model (``hlo_analysis.py:17-22``), except that views
  and allocations move nothing, a write into a slice (``copy_`` into a
  view) moves the slice twice, a scatter (``index_put_``) moves its update
  twice (the reference's dynamic-update-slice rule) and a gather
  (``index``, ``index_select``, ``embedding``) reads what it returns.

The hand-written kernels are not aten ops. On a meta tensor each wrapper
(``kernels.acs.acs_forward``, ``kernels.traceback.traceback`` and
``traceback_prefix``, ``kernels.fused.pbvd_fused``,
``_unused.flash_attention.flash_attention``) launches nothing, returns
meta outputs of the kernel's shapes and dtypes and reports the kernel's
(bytes, operations) through :func:`kernel`, from the formulas below, which
``chip_smoke.py``'s bounds use too. Collective bytes come from
``sharding.place.Placed.full``: gathering a leaf onto a position records
the bytes of the tiles other positions hold (``all-gather``), and the
backward of that gather sends their gradients back (``reduce-scatter``).

**Positions.** An op runs at ``sharding.rules.current_position()``: the
position the code that computes per position names (the per-tile AdamW
update, MoE's expert-parallel shards), else the first position of the data
shard that ``on_shard`` pins (the mesh train step), else the mesh's first
position. On meta, and on one card named n times, every position is the
same ``torch.device``, so the count is by position, never by device. A
backward op runs at the position current when the backward runs (in the
mesh train step, the data shard's first): the backward of MoE's expert
shards is counted there, not on the shards.

**The card's branches.** The counter has a target device (``"cuda"``):
inside it a meta tensor stands for that device in the port's dispatch
decisions (``device.dispatch_type``), so a counted prefill counts the flash
kernel's band and not the plain streaming softmax's products.

Many ops on meta go through torch's Python reference implementations
(~0.1-0.2 ms each). An op on meta tensors is a function of its inputs'
shapes, strides and dtypes alone, and so is its count, so inside the
counter an op that returns new tensors runs and is counted once per such
signature; later calls get empty meta tensors of the recorded outputs'
shapes, strides and dtypes, and the recorded FLOPs and bytes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch import device as _device
from repro_torch.sharding import rules as _rules

__all__ = [
    "WorkCounter",
    "active",
    "kernel",
    "HBM_BYTES_PER_S",
    "INT32_OPS_PER_S",
    "BF16_FLOPS_PER_S",
    "F32_FLOPS_PER_S",
    "PEAKS",
    "k1_cost",
    "k2_cost",
    "k2_staged_bytes",
    "fused_cost",
    "k1_matrix_cost",
    "acs_work",
    "fused_work",
    "prefix_geometry",
    "k2_prefix_cost",
    "flash_cost",
    "bound",
]

# ---- the H100 SXM's peaks (NVIDIA data sheet; the full 700 W limit) ------------------
# 3.35 TB/s HBM3. 67 TFLOP/s float32 outside the tensor cores, i.e. 132 SMs × 128
# lanes × 2 (FMA) × 1.98 GHz; a Hopper SM has 64 INT32 lanes, so the 32-bit integer
# ALU peak is 132 × 64 × 1.98e9 op/s (only the INT32 pipe: IMAD and DPX may issue
# beside it, so a share of such a bound above 1 means a wrong count or peak, never
# the timing). 989 TFLOP/s is the dense bf16 tensor-core peak.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
#: the peak of each compute dtype a count is split by
PEAKS = {"bf16": BF16_FLOPS_PER_S, "f32": F32_FLOPS_PER_S, "int": INT32_OPS_PER_S}


# ---- the kernels' (bytes, operations) ----------------------------------------------------
def k1_cost(code, T: int, B: int, sym_bytes: int) -> tuple[float, float]:
    """(bytes, operations) K1 must move and do: symbols in, survivor words and
    final metrics out; per stage and block 2^(R-1)·(R-1) folded-metric adds
    and, per state, two adds, a compare and a select."""
    W = -(-code.n_states // 32)
    nbytes = T * code.R * B * sym_bytes + T * W * B * 4 + code.n_states * B * 4
    ops = T * B * (4 * code.n_states + code.n_folded * (code.R - 1))
    return float(nbytes), float(ops)


def k2_cost(T: int, B: int, decode_start: int, n_decode: int) -> tuple[float, float]:
    """(bytes, operations) of the serial walk: one start state and one word per
    walked stage in, one bit word per decoded stage out; about six integer
    operations per walked stage."""
    walked = T - 1 - decode_start
    nbytes = B * 4 + B * walked * 4 + n_decode * B * 4
    ops = B * (T - decode_start) * 6
    return float(nbytes), float(ops)


def k2_staged_bytes(T: int, B: int, decode_start: int, n_decode: int, W: int) -> float:
    """Bytes of the staged walk, not a bound of the function (K2's is): all
    W words of every walked stage and the start states in, the bits out."""
    return float(B * 4 + B * (T - 1 - decode_start) * W * 4 + n_decode * B * 4)


def fused_cost(code, T: int, B: int, sym_bytes: int, decode_start: int,
               n_decode: int) -> tuple[float, float]:
    """(bytes, operations) of the fused kernel: symbols and start states in,
    packed bit words out; K1's operations plus the walk's."""
    n_words = -(-n_decode // 32)
    nbytes = T * code.R * B * sym_bytes + B * 4 + n_words * B * 4
    ops = k1_cost(code, T, B, sym_bytes)[1] + B * (T - decode_start) * 6
    return float(nbytes), float(ops)


def k1_matrix_cost(code, T: int, B: int, sym_bytes: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of the matrix algorithm, not a bound of the
    function (K1's is): K1's bytes; per k-step and target 2^k adds and
    2^k - 1 compare-selects (two operations each), plus kR - 1 adds per
    folded combined row and block; the T mod k trailing stages as K1's."""
    nbytes = k1_cost(code, T, B, sym_bytes)[0]
    nk, nb = 1 << k, k * code.R
    per_step = code.n_states * (nk + 2 * (nk - 1)) + (1 << (nb - 1)) * (nb - 1)
    per_stage = 4 * code.n_states + code.n_folded * (code.R - 1)
    return float(nbytes), float(B * ((T // k) * per_step + (T % k) * per_stage))


def prefix_geometry(T: int, decode_start: int, n_decode: int, tb_chunk: int):
    """(n_act, nc_e, C, first stage read) of the prefix walk."""
    from repro_torch.kernels.ref import prefix_chunk_geometry

    C, P, n_chunks, c_lo, c_hi = prefix_chunk_geometry(T, decode_start, n_decode, tb_chunk)
    return n_chunks - c_lo, c_hi - c_lo + 1, C, max(0, c_lo * C - P)


def k2_prefix_cost(code, T: int, B: int, decode_start: int, n_decode: int,
                   tb_chunk: int) -> tuple[float, float]:
    """(bytes, operations) of the prefix algorithm, not a bound of the
    function (K2's is): the start states and the survivor words of the
    stages the active chunks hold in, the bits out; about six integer
    operations per composed (chunk, state, stage), per walked map and per
    expanded stage."""
    n_act, nc_e, C, first = prefix_geometry(T, decode_start, n_decode, tb_chunk)
    W = -(-code.n_states // 32)
    nbytes = B * 4 + (T - first) * W * B * 4 + n_decode * B * 4
    ops = B * 6 * (n_act * C * code.n_states + n_act + nc_e * C)
    return float(nbytes), float(ops)


@functools.lru_cache(maxsize=256)
def _band_keys(S: int, T: int, causal: bool, window: int | None) -> int:
    """The (query position, key) pairs of the band, summed over S positions."""
    p = np.arange(S, dtype=np.int64)
    lo = np.maximum(0, p - window + 1) if window else np.zeros_like(p)
    hi = np.minimum(T, p + 1) if causal else np.full_like(p, T)
    return int(np.maximum(0, hi - lo).sum())


def flash_cost(B: int, S: int, T: int, Hkv: int, G: int, dh: int, causal: bool,
               window: int | None, elem_bytes: int) -> tuple[float, float]:
    """(bytes, FLOP) of band attention: q, k, v read once and o written once;
    4·dh FLOP (two products) per (query head, valid key) pair of the band."""
    keys = _band_keys(S, T, bool(causal), window)
    nbytes = elem_bytes * (2 * B * S * Hkv * G * dh + 2 * B * T * Hkv * dh)
    return float(nbytes), float(4 * dh * B * Hkv * G * keys)


def acs_work(code, T: int, B: int, sym_bytes: int, impl: str, k: int) -> tuple[float, float]:
    """What K1 (``impl="butterfly"``) or K1-matrix does: :func:`k1_cost` or
    :func:`k1_matrix_cost`."""
    if impl == "matrix":
        return k1_matrix_cost(code, T, B, sym_bytes, k)
    return k1_cost(code, T, B, sym_bytes)


def fused_work(code, T: int, B: int, sym_bytes: int, decode_start: int, n_decode: int,
               impl: str, k: int, tb_mode: str, tb_chunk: int) -> tuple[float, float]:
    """What the fused kernel does: :func:`fused_cost`'s bytes; the chosen
    forward's operations (:func:`acs_work`) and the chosen walk's (six a
    walked stage, or :func:`k2_prefix_cost`'s)."""
    nbytes = fused_cost(code, T, B, sym_bytes, decode_start, n_decode)[0]
    ops = acs_work(code, T, B, sym_bytes, impl, k)[1]
    if tb_mode == "prefix":
        ops += k2_prefix_cost(code, T, B, decode_start, min(n_decode, T - decode_start),
                              tb_chunk)[1]
    else:
        ops += B * (T - decode_start) * 6
    return nbytes, float(ops)


def bound(nbytes: float, ops: float, op_rate: float) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the larger of the bytes over HBM's
    rate and the operations over ``op_rate``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / op_rate
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


# ---- the counter --------------------------------------------------------------------------
aten = torch.ops.aten

#: ops that move no data: views and allocations
_FREE = {aten.detach.default, aten.alias.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.empty.memory_format, aten.empty_strided.default,
         aten.new_empty.default, aten.new_empty_strided.default, aten.empty_like.default,
         aten._to_copy.default}  # _to_copy is counted below when it changes dtype
#: ops that only write their output (nothing read)
_WRITE_ONLY = {aten.zeros.default, aten.ones.default, aten.full.default, aten.zeros_like.default,
               aten.ones_like.default, aten.full_like.default, aten.new_zeros.default,
               aten.new_ones.default, aten.new_full.default, aten.fill_.Scalar,
               aten.zero_.default, aten.arange.default, aten.arange.start,
               aten.arange.start_step, aten.scalar_tensor.default}
#: scatters: the update (and its indices) read, the updated region written
_SCATTER = {aten.index_put_.default: 2, aten.index_put.default: 2,
            aten._index_put_impl_.default: 2, aten.scatter.src: 3, aten.scatter_.src: 3,
            aten.scatter_add.default: 3, aten.scatter_add_.default: 3,
            aten.index_copy.default: 3, aten.index_copy_.default: 3,
            aten.index_add.default: 3, aten.index_add_.default: 3}
#: gathers: the indices and the gathered rows read, the rows written
_GATHER = {aten.index.Tensor, aten.index_select.default, aten.embedding.default,
           aten.gather.default}


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from (y for y in x if isinstance(y, torch.Tensor))


def _kind(dtype: torch.dtype) -> str:
    if dtype in (torch.bfloat16, torch.float16):
        return "bf16"
    return "f32" if dtype.is_floating_point else "int"


def _key(xs) -> tuple:
    """A hashable stand-in for an op's arguments: a tensor by its device,
    shape, strides, dtype and offset, a list by its items; ``TypeError`` for
    anything else unhashable and for a tensor off meta with more than one
    value (an index or a mask whose values may shape the output)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            if x.device.type != "meta" and x.dim():
                raise TypeError
            out.append((x.device, x.shape, x.stride(), x.dtype, x.storage_offset()))
        elif isinstance(x, (list, tuple)):
            out.append(_key(x))
        else:
            hash(x)
            out.append(x)
    return tuple(out)


def _fresh(func) -> bool:
    """Whether ``func`` returns new tensors only: no view, no in-place or
    ``out=`` write, no aliased return."""
    schema = func._schema
    return not (func.is_view or schema.is_mutable
                or any(r.alias_info is not None for r in schema.returns))


_FRESH: dict = {}


@dataclasses.dataclass
class Tally:
    """What one mesh position did."""

    flops: dict = dataclasses.field(default_factory=lambda: collections.defaultdict(float))
    bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    collective_counts: dict = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    kernels: dict = dataclasses.field(default_factory=dict)

    def bound_s(self) -> float:
        """The position's least time: its operations over each dtype's peak
        against its bytes over HBM's rate."""
        compute = sum(v / PEAKS[k] for k, v in self.flops.items())
        return max(compute, self.bytes / HBM_BYTES_PER_S)

    def add(self, other: "Tally") -> None:
        """Add ``other``'s work to this tally."""
        for k, v in other.flops.items():
            self.flops[k] += v
        self.bytes += other.bytes
        for k, v in other.collective_bytes.items():
            self.collective_bytes[k] += v
        for k, v in other.collective_counts.items():
            self.collective_counts[k] += v
        for name, kv in other.kernels.items():
            acc = self.kernels.setdefault(name, {"launches": 0, "bytes": 0.0, "ops": 0.0,
                                                 "kind": kv["kind"]})
            for key in ("launches", "bytes", "ops"):
                acc[key] += kv[key]

    def as_dict(self) -> dict:
        return {"flops": float(sum(self.flops.values())),
                "flops_by_dtype": {k: float(v) for k, v in sorted(self.flops.items())},
                "bytes": float(self.bytes),
                "collective_bytes": {k: float(v) for k, v in sorted(self.collective_bytes.items())},
                "collective_counts": dict(sorted(self.collective_counts.items())),
                "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())}}


_STACK: list["WorkCounter"] = []


def active() -> "WorkCounter | None":
    """The innermost counter that is counting, else ``None``."""
    return _STACK[-1] if _STACK else None


def kernel(name: str, nbytes: float, ops: float, kind: str) -> None:
    """A hand-written kernel's work on a meta tensor: ``ops`` operations of
    compute dtype ``kind`` (``"bf16"``, ``"f32"`` or ``"int"``) and ``nbytes``
    bytes, one launch, at the current position of the active counter (if
    any)."""
    c = active()
    if c is not None:
        c._kernel(name, nbytes, ops, kind)


class WorkCounter(TorchDispatchMode):
    """Count what the enclosed code does, per mesh position (module
    docstring). ``target`` is the device type a meta tensor stands for in
    the port's dispatch decisions while the counter is active."""

    def __init__(self, target: str = "cuda"):
        super().__init__()
        self.target = target
        self.tallies: dict[tuple, Tally] = collections.defaultdict(Tally)
        self._memo: dict = {}
        self._prev_target = None

    # -- entering and leaving
    def __enter__(self):
        _STACK.append(self)
        self._prev_target = _device._META_STANDS_FOR[0]
        _device._META_STANDS_FOR[0] = self.target
        return super().__enter__()

    def __exit__(self, *exc):
        _device._META_STANDS_FOR[0] = self._prev_target
        _STACK.remove(self)
        return super().__exit__(*exc)

    # -- where
    def position(self) -> tuple:
        return _rules.current_position() or ()

    def _tally(self) -> Tally:
        return self.tallies[self.position()]

    # -- what
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        fresh = _FRESH.get(func)
        if fresh is None:
            fresh = _FRESH[func] = _fresh(func)
        key = None
        if fresh:
            try:
                key = (func, _key(args), _key(sorted(kwargs.items())))
            except TypeError:
                pass
            hit = self._memo.get(key) if key is not None else None
            if hit is not None:  # the same op on the same metadata: its outputs and its work
                single, metas, kind, flops, nbytes = hit
                outs = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
                        for shape, stride, dtype in metas]
                self._record(kind, flops, nbytes)
                return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        kind, flops = None, 0.0
        packet = func._overloadpacket
        if packet in flop_registry:
            kind = _kind(next(t.dtype for t in _tensors(args)))
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        nbytes = self._bytes(func, args, out)
        self._record(kind, flops, nbytes)
        if key is not None:
            single = isinstance(out, torch.Tensor)
            outs = [out] if single else list(out) if isinstance(out, (list, tuple)) else []
            if outs and all(isinstance(o, torch.Tensor) and o.device.type == "meta"
                            for o in outs):
                self._memo[key] = (single, [(o.shape, o.stride(), o.dtype) for o in outs],
                                   kind, flops, nbytes)
        return out

    def _record(self, kind, flops: float, nbytes: float) -> None:
        tally = self._tally()
        if kind is not None:
            tally.flops[kind] += flops
        tally.bytes += nbytes

    @staticmethod
    def _bytes(func, args, out) -> float:
        if func in _FREE:
            if func is aten._to_copy.default and out.dtype != args[0].dtype:
                return float(_nbytes(args[0]) + _nbytes(out))
            return 0.0
        if func.is_view:
            return 0.0
        outs = list(_tensors(out if isinstance(out, (list, tuple)) else [out]))
        if func in _WRITE_ONLY:
            return float(sum(map(_nbytes, outs)))
        if func is aten.copy_.default:
            return 2.0 * _nbytes(args[1])
        if func in _SCATTER:
            update = args[_SCATTER[func]]
            index = sum(map(_nbytes, _tensors(args[1:_SCATTER[func]])))
            return 2.0 * _nbytes(update) + index
        if func in _GATHER:
            index = sum(map(_nbytes, _tensors(args[1:])))
            return 2.0 * sum(map(_nbytes, outs)) + index
        read = sum(map(_nbytes, _tensors(args)))
        if func._schema.is_mutable:  # in place: the mutated operand is also written
            return float(read + _nbytes(args[0]))
        return float(read + sum(map(_nbytes, outs)))

    def _kernel(self, name: str, nbytes: float, ops: float, kind: str) -> None:
        tally = self._tally()
        tally.flops[kind] += ops
        tally.bytes += nbytes
        k = tally.kernels.setdefault(name, {"launches": 0, "bytes": 0.0, "ops": 0.0,
                                            "kind": kind})
        k["launches"] += 1
        k["bytes"] += nbytes
        k["ops"] += ops

    def collective(self, kind: str, nbytes: float, position: tuple | None = None) -> None:
        """``nbytes`` received at ``position`` (default: the current one) by a
        collective of ``kind`` (``"all-gather"``, ``"reduce-scatter"``)."""
        tally = self.tallies[self.position() if position is None else position]
        tally.collective_bytes[kind] += nbytes
        tally.collective_counts[kind] += 1

    # -- results
    def busiest(self) -> tuple[tuple, Tally]:
        """The position with the largest :meth:`Tally.bound_s` (the first of
        equals), and its tally."""
        if not self.tallies:
            return (), Tally()
        pos = max(self.tallies, key=lambda p: self.tallies[p].bound_s())
        return pos, self.tallies[pos]

    def total(self) -> Tally:
        """Every position's work added up."""
        out = Tally()
        for t in self.tallies.values():
            out.add(t)
        return out

    # -- counting a piece of work once and adding it again
    @contextlib.contextmanager
    def apart(self):
        """Count the enclosed code into tallies of its own (position →
        :class:`Tally`, yielded), added to the counter's when it ends: the
        count of a piece of work that :meth:`add_tallies` may add again at
        other positions."""
        saved, own = self.tallies, collections.defaultdict(Tally)
        self.tallies = own
        try:
            yield own
        finally:
            self.tallies = saved
            self.add_tallies(own)

    def add_tallies(self, tallies: dict, where=None) -> None:
        """Add ``tallies`` (position → :class:`Tally`), each at
        ``where(position)`` (default: the same position)."""
        for pos, t in tallies.items():
            self.tallies[pos if where is None else where(pos)].add(t)

    @property
    def flops(self) -> float:
        """All positions' FLOPs (and kernel operations), every dtype."""
        return float(sum(self.total().flops.values()))

    @property
    def bytes(self) -> float:
        return float(self.total().bytes)
