"""The decode path of the port: ``DecoderEngine`` and streaming sessions.

The counterpart of ``repro.core.engine``:

* **codes** come from a :class:`~repro_torch.core.codespec.CodeSpec` —
  punctured streams are depunctured with BM-neutral zeros first;
* **backends** are looked up in the port's kernel registry through
  :func:`~repro_torch.kernels.ops.pbvd_decode_blocks`: ``"cuda"`` (K1 then
  K2), ``"fused"`` (one kernel) and ``"ref"`` (plain PyTorch);
* **metric modes** ``"f32"``/``"i16"``/``"i8"``: float symbols are
  quantized by ``cfg.quantize`` (``effective_q`` bits; the coarse i8
  scale) before framing, so the narrow pipelines never saturate;
* **batching across streams** is :meth:`DecoderEngine.decode_batch`: the
  framed blocks of many streams are concatenated along the lane axis and
  decoded in ONE launch of each kernel (one fused launch on ``"fused"``).
  The kernels mask the ragged lane edge, so no lanes are padded;
  per-stream bits equal sequential :meth:`DecoderEngine.decode` calls
  because parallel blocks never interact;
* **sharding** is a constructor argument (``mesh`` + ``block_axes`` +
  ``shard_dispatch``): the lane axis is cut into equal slices, one per lane
  shard of a :class:`~repro_torch.launch.mesh.DecodeMesh`, each decoded on
  its shard's device (:func:`~repro_torch.sharding.smap.lane_split`) with
  no communication between shards, and joined on the engine's device. A
  mesh that spans processes has each rank launch only the shards its own
  devices hold, and every rank end with the whole result;
* **streaming** is :meth:`DecoderEngine.session`: a
  :class:`DecoderSession` carries the inter-block overlap tail (host-side,
  in an :class:`ArraySessionStore`) and the puncture phase across
  ``decode()`` calls, so an unbounded stream decodes chunk by chunk, bit
  for bit as the one-shot decode. Each launch holds exactly the ready
  blocks, so the kernels see 0, 1 or a few blocks per chunk.

The engine runs on the GPU unless the caller asks for the CPU: ``device``
defaults to ``"cuda"``, and with no CUDA device the engine refuses to start
(:class:`DeviceUnavailableError`) instead of carrying on on the CPU. A
mesh-bound engine's device is its mesh's first device of this process.
Inputs (numpy arrays or tensors) are moved to the engine's device; outputs
are int32 tensors there.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import DeviceUnavailableError, resolve_device
from repro_torch.kernels.ops import check_mesh_launch, pbvd_decode_blocks
from repro_torch.launch.faults import SymbolError, check_finite_symbols
from repro_torch.launch.mesh import canonical_device
from repro_torch.sharding.rules import block_mesh_axes
from repro_torch.sharding.smap import lane_shard_devices, lane_shard_owners, lane_split

from .codespec import CodeSpec
from .pbvd import PBVDConfig, frame_stream

__all__ = [
    "ArraySessionStore",
    "DecoderEngine",
    "DecoderSession",
    "DeviceUnavailableError",
    "resolve_device",
]


class ArraySessionStore:
    """Default storage for a session's buffered soft symbols: one contiguous
    per-session float32 ndarray on the host.

    A *session store* is the seam that lets a serving layer swap the
    per-session buffer for shared, slab-allocated pages without the session
    noticing: :class:`DecoderSession` only ever touches its buffer through
    this interface. The contract (all stage indices are LOCAL, i.e. relative
    to the store's first held stage):

    * ``len(store)`` — stages currently held;
    * ``append(rows)`` — append ``(n, R)`` float-convertible symbol rows;
    * ``grow(n)`` — append ``n`` all-zero stages (punctured ingest scatters
      into them afterwards);
    * ``scatter(stage_idx, sym_idx, values)`` — elementwise write;
    * ``read(lo, n)`` — up to ``n`` rows from ``lo`` (short at the tail,
      never padded: framing owns the zero-padding);
    * ``drop_prefix(n)`` — discard the first ``n`` stages (committed blocks);
    * ``close()`` — release backing storage (idempotent);
    * ``snapshot()`` — a picklable dict of the held rows (logical content
      only, numpy, independent of any device);
    * ``restore(snap)`` — load a snapshot into an EMPTY store.

    The snapshot format is the reference's, so a snapshot taken on either
    side restores on the other.
    """

    def __init__(self, R: int):
        self._a = np.zeros((0, R), np.float32)

    def __len__(self) -> int:
        return len(self._a)

    def append(self, rows: np.ndarray) -> None:
        self._a = np.concatenate([self._a, rows.astype(np.float32)])

    def grow(self, n: int) -> None:
        if n > 0:
            self._a = np.concatenate(
                [self._a, np.zeros((n, self._a.shape[1]), np.float32)]
            )

    def scatter(self, stage_idx, sym_idx, values) -> None:
        self._a[stage_idx, sym_idx] = values

    def read(self, lo: int, n: int) -> np.ndarray:
        return self._a[lo : lo + n]

    def drop_prefix(self, n: int) -> None:
        if n > 0:
            self._a = self._a[n:]

    def close(self) -> None:
        self._a = np.zeros((0, self._a.shape[1]), np.float32)

    def snapshot(self) -> dict:
        return {"rows": self._a.copy()}

    def restore(self, snap: dict) -> None:
        if len(self._a):
            raise ValueError("restore() target store is not empty")
        self._a = np.asarray(snap["rows"], np.float32).copy()


class DecoderEngine:
    """Single entry point for PBVD decoding.

    Parameters
    ----------
    cfg: PBVDConfig — decode geometry (D, L), quantization, backend, code/spec.
    device: where the engine decodes; ``None`` means ``"cuda"``, or the
        mesh's first device of this process when a mesh is bound (another
        device is refused).
    mesh: optional :class:`~repro_torch.launch.mesh.DecodeMesh`; when given,
        the lane (flattened frames × blocks) axis of every decode is split
        over ``block_axes``, one equal slice per lane shard, each decoded on
        its shard's device. Blocks never interact, so the split needs no
        communication and the bits equal the meshless decode. On a mesh
        that spans processes every rank feeds the same streams, launches
        the shards it holds and gets the whole result (sessions too, when
        every rank feeds the same chunks in the same order).
    block_axes: mesh axes carrying the lane axis. ``None`` resolves the
        ``"blocks"`` rule of :mod:`repro_torch.sharding.rules` against the
        mesh (``("pod", "data")`` on a mesh with a ``pod`` axis, ``("data",)``
        otherwise).
    shard_dispatch: ``"constraint"`` (default) launches each shard with only
        its real lanes; ``"shard_map"`` decodes every lane of every slice and
        trims the pad lanes after the join (see
        :data:`~repro_torch.kernels.ops.SHARD_DISPATCH`). Both are bit-exact;
        validated at construction (:func:`~repro_torch.kernels.ops.check_mesh_launch`).
    """

    def __init__(
        self,
        cfg: PBVDConfig | None = None,
        *,
        device=None,
        mesh=None,
        block_axes: tuple[str, ...] | None = ("data",),
        shard_dispatch: str = "constraint",
    ):
        self.cfg = cfg if cfg is not None else PBVDConfig()
        self.spec: CodeSpec = self.cfg.codespec
        self.mesh = mesh
        if block_axes is None:
            block_axes = ("data",) if mesh is None else block_mesh_axes(mesh)
        self.block_axes = tuple(block_axes)
        self.shard_dispatch = shard_dispatch
        if mesh is None:
            self.device = resolve_device(device)
            self.n_shards = 1
            return
        # eager: a bad mesh binding fails when the engine is BUILT, with a
        # clear error naming the axis/backend — never inside a pooled launch
        self.n_shards = check_mesh_launch(
            mesh, self.block_axes, self.cfg.backend, dispatch=shard_dispatch
        )
        self.device = mesh.local_devices[0]
        if device is not None and canonical_device(device, "DecoderEngine") != self.device:
            raise ValueError(
                f"DecoderEngine: device={str(device)!r} is not the mesh's first "
                f"device {str(self.device)!r}; a mesh-bound engine decodes there"
            )
        self._shard_devices = lane_shard_devices(mesh, self.block_axes)
        self._shard_owners = (
            lane_shard_owners(mesh, self.block_axes) if mesh.spans_processes else None
        )

    # ------------------------------------------------------------------ one-shot
    def decode(self, y, n_bits: int | None = None) -> torch.Tensor:
        """Decode a soft-symbol stream → (n_bits,) int32 bits.

        ``y`` is either a (n_stages, R) full-rate stream or, for a punctured
        spec, a 1-D stream of received (punctured) symbols, which is
        depunctured with BM-neutral zeros first. ``n_bits`` defaults to the
        number of full-rate stages in the stream.
        """
        blocks, n_blocks, n_bits = self._frame_one(y, n_bits)
        blocks = self._pad_lanes(blocks)
        bits = self._decode_blocks(blocks, (n_blocks,))  # (D, n_blocks)
        return bits.t().reshape(-1)[:n_bits]

    # ------------------------------------------------------------------ batched
    def decode_batch(self, ys, n_bits_list=None) -> list[torch.Tensor]:
        """Decode many independent streams in ONE launch of each kernel.

        ``ys`` is a sequence of streams, each in any form :meth:`decode`
        accepts; ``n_bits_list`` gives each stream's payload length (or
        ``None`` entries / ``None`` for the stage-count default). Returns a
        list of (n_bits_i,) int32 tensors, bit-identical per stream to
        sequential ``decode()`` calls.
        """
        ys = [self._to_device(y) for y in ys]
        if not ys:
            return []
        if n_bits_list is None:
            n_bits_list = [None] * len(ys)
        if len(n_bits_list) != len(ys):
            raise ValueError(
                f"n_bits_list has {len(n_bits_list)} entries for {len(ys)} streams"
            )
        uniform = self._frame_uniform(ys, n_bits_list)
        if uniform is not None:
            packed, frame_counts, bit_counts = uniform
        else:
            framed = [self._frame_one(y, nb) for y, nb in zip(ys, n_bits_list)]
            frame_counts = tuple(k for _, k, _ in framed)
            bit_counts = tuple(nb for _, _, nb in framed)
            packed = torch.cat([b for b, _, _ in framed], dim=2)
        packed = self._pad_lanes(packed)
        bits = self._decode_blocks(packed, frame_counts)  # (D, total)
        if uniform is not None:  # equal frames: one reshape, not S slices
            S, k, n_bits = len(ys), frame_counts[0], bit_counts[0]
            rows = bits.reshape(-1, S, k).permute(1, 2, 0).reshape(S, -1)
            return list(rows[:, :n_bits])
        out, lo = [], 0
        for k, n_bits in zip(frame_counts, bit_counts):
            out.append(bits[:, lo : lo + k].t().reshape(-1)[:n_bits])
            lo += k
        return out

    # ------------------------------------------------------------------ streaming
    def session(self, *, store=None) -> "DecoderSession":
        """Open a stateful streaming session (see :class:`DecoderSession`).

        ``store`` swaps the session's symbol buffer for another
        :class:`ArraySessionStore`-shaped backend.
        """
        return DecoderSession(self, store=store)

    # ------------------------------------------------------------------ internals
    def _lane_budget(self, n: int) -> int:
        """Lanes a launch of ``n`` real lanes takes: the smallest multiple of
        ``n_shards`` that is at least ``n``, so the lanes split into equal
        slices. Without a mesh this is ``n``: the kernels mask the ragged
        lane edge, so the port keeps no power-of-two shape budget."""
        s = self.n_shards
        return -(-n // s) * s

    def _pad_lanes(self, blocks: torch.Tensor) -> torch.Tensor:
        """Pad the lane axis to :meth:`_lane_budget` with zero-symbol blocks."""
        total = blocks.shape[2]
        budget = self._lane_budget(total)
        if budget > total:
            blocks = F.pad(blocks, (0, budget - total))
        return blocks

    def _to_device(self, y) -> torch.Tensor:
        """Symbols as a tensor on the engine's device: floats as float32,
        integers other than int8/int16/int32 as int32 (the reference's
        array conversion)."""
        t = torch.as_tensor(y)
        if t.is_floating_point():
            t = t.to(torch.float32)
        elif t.dtype not in (torch.int8, torch.int16, torch.int32):
            t = t.to(torch.int32)
        return t.to(self.device)

    def _frame_one(self, y, n_bits: int | None):
        """Depuncture, quantize and frame one stream → (blocks, n_blocks, n_bits)."""
        y = self._to_full_rate(self._to_device(y))
        # reject NaN/Inf before framing: a non-finite symbol would corrupt
        # the path metrics of every lane coalesced into the launch
        check_finite_symbols(y, "DecoderEngine.decode")
        if n_bits is None:
            n_bits = int(y.shape[0])
        cfg = self.cfg
        n_blocks = -(-n_bits // cfg.D)
        if y.is_floating_point():
            y = cfg.quantize(y)  # already-integer inputs are pre-quantized
        return frame_stream(y, cfg.D, cfg.L, n_blocks), n_blocks, n_bits

    def _frame_uniform(self, ys: list[torch.Tensor], n_bits_list):
        """Fast path for same-shape stream fleets (the serving common case).

        Stacks the streams, quantizes once and frames all of them in one
        call. Returns ``None`` when streams differ in shape/dtype/length.
        """
        if len(ys) < 2:
            return None
        shapes = {tuple(y.shape) for y in ys}
        dtypes = {y.dtype for y in ys}
        if len(shapes) != 1 or len(dtypes) != 1 or len(set(n_bits_list)) != 1:
            return None
        for i, y in enumerate(ys):
            check_finite_symbols(y, f"DecoderEngine.decode_batch (stream {i})")
        y0 = torch.stack([self._to_full_rate(y) for y in ys])  # (S, n, R)
        S, n_sym, R = y0.shape
        n_bits = n_bits_list[0] if n_bits_list[0] is not None else n_sym
        cfg = self.cfg
        k = -(-n_bits // cfg.D)
        if y0.is_floating_point():
            y0 = cfg.quantize(y0)
        blocks = frame_stream(y0, cfg.D, cfg.L, k)  # (S, T, R, k)
        packed = blocks.permute(1, 2, 0, 3).reshape(cfg.T, R, S * k)
        return packed, (k,) * S, (n_bits,) * S

    def _to_full_rate(self, y: torch.Tensor) -> torch.Tensor:
        if y.dim() == 1:
            if not self.spec.is_punctured:
                raise SymbolError(
                    "1-D symbol stream given but the code spec is unpunctured; "
                    "pass (n_stages, R) soft symbols"
                )
            return self.spec.depuncture_stream(y)
        if y.shape[-1] != self.spec.code.R:
            raise SymbolError(f"stream rank {y.shape[-1]} != code R {self.spec.code.R}")
        return y

    def _decode_blocks(self, blocks: torch.Tensor, frame_counts: tuple[int, ...]):
        """(T, R, B) framed symbols → (D, sum(frame_counts)) bits.

        ``frame_counts`` is the per-frame real-block layout along the lane
        axis; lanes beyond the real blocks are padding. With a mesh bound,
        the lane axis arrives padded to :meth:`_lane_budget` (every caller
        rounds once, before launch) and is split over the lane shards by
        the configured dispatch.
        """
        cfg = self.cfg
        launch = functools.partial(
            pbvd_decode_blocks,
            code=self.spec.code,
            decode_start=cfg.L,
            n_decode=cfg.D,
            start_policy=cfg.start_policy,
            backend=cfg.backend,
            metric_mode=cfg.metric_mode,
            tb_mode=cfg.tb_mode,
            tb_chunk=cfg.tb_chunk,
            acs_radix=cfg.acs_radix,
            acs_impl=cfg.acs_impl,
            acs_k=cfg.acs_k,
        )
        if self.mesh is None:
            return launch(blocks, frame_counts=frame_counts)
        n_real = sum(frame_counts)
        split = functools.partial(lane_split, launch, blocks, self._shard_devices,
                                  out_device=self.device, owners=self._shard_owners,
                                  rows=cfg.D)
        if self.shard_dispatch == "shard_map":
            # every lane of every slice, pad lanes included; the trim
            # happens once, on the joined result
            return split()[:, :n_real]
        return split(n_real=n_real)


def _host_symbols(chunk) -> np.ndarray:
    """A chunk as a host numpy array: a tensor (on any device) is copied to
    the host once, floats as float32."""
    if isinstance(chunk, torch.Tensor):
        t = chunk.detach()
        if t.is_floating_point():
            t = t.to(torch.float32)
        return t.cpu().numpy()
    return np.asarray(chunk)


class DecoderSession:
    """Chunk-by-chunk decoding of an unbounded stream.

    The session buffers received symbols on the host (depuncturing
    incrementally for punctured specs) and decodes a parallel block as soon
    as its full window ``[bD - L, bD + D + L)`` is available — exactly the
    window the one-shot framing would build, so the concatenation of all
    ``decode()`` outputs plus ``finish()`` is bit-identical to
    ``engine.decode`` on the whole stream.

    The carried state between calls is the overlap tail (at most ``D + L``
    stages of soft symbols), the puncture phase, and the block counter.

    Internally the launch is split into three phases so a
    :class:`~repro_torch.launch.serve_decoder.SessionPool` can pack the ready
    blocks of many sessions into one launch: :meth:`ready_blocks` (how far
    the stream can decode), :meth:`_frame_ready` (build the framed window on
    the engine's device, no launch), and :meth:`_commit` (advance the block
    counter, trim the buffer). ``decode()``/``finish()`` compose them with a
    solo launch of exactly the ready blocks. Outputs are int32 tensors on
    the engine's device.
    """

    def __init__(self, engine: DecoderEngine, *, store=None):
        self.engine = engine
        self.cfg = engine.cfg
        self.spec = engine.spec
        # the buffered-symbol storage backend (see ArraySessionStore for the
        # contract); a serving layer passes a slab-paged store instead
        self._store = store if store is not None else ArraySessionStore(self.spec.code.R)
        self._base = 0  # global stage index of the store's first held stage
        self._blocks_done = 0
        self._kept_seen = 0  # punctured symbols consumed (puncture phase)
        self._int_dtype = None  # numpy dtype of pre-quantized (integer) chunks
        self._started = False
        self.bits_emitted = 0

    # ---- public API ----------------------------------------------------------------
    def decode(self, chunk) -> torch.Tensor:
        """Feed a chunk of received symbols; return newly decodable bits.

        ``chunk`` (numpy or a tensor on any device) is (n, R) full-rate soft
        symbols for unpunctured specs, or a 1-D punctured symbol stream for
        punctured specs (the wire format — full-rate chunks would
        desynchronize the carried puncture phase). Integer chunks are
        treated as pre-quantized (like ``engine.decode``) and must not be
        mixed with float chunks. Returns an int32 tensor on the engine's
        device (possibly empty): ``D`` bits per parallel block whose window
        is now complete.
        """
        self.ingest(chunk)
        out = self._decode_upto(self.ready_blocks())
        self.bits_emitted += out.shape[0]
        return out

    def finish(self, n_bits: int | None = None) -> torch.Tensor:
        """Flush the stream: decode the remaining blocks (zero-padded tail).

        ``n_bits`` is the total payload length of the stream (defaults to the
        number of full-rate stages received); the returned tail makes the
        session's concatenated output equal ``engine.decode(y, n_bits)``.
        """
        n_bits, n_blocks, prior = self._finish_plan(n_bits)
        out = self._decode_upto(n_blocks)
        out = out[: max(0, n_bits - prior)]
        self.bits_emitted += out.shape[0]
        return out

    def close(self) -> None:
        """Release the session's buffered-symbol storage (idempotent)."""
        self._store.close()

    def ingest(self, chunk) -> None:
        """Buffer a chunk without decoding (used by pooled sessions)."""
        self._ingest(_host_symbols(chunk))

    def snapshot(self) -> dict:
        """Picklable session state: the buffered-symbol window plus the
        scalars that position it in the stream (overlap base, block counter,
        puncture phase, quantization dtype as a numpy dtype string).
        Restoring it into a fresh session continues the stream bit-exact;
        the format is the reference's, so snapshots cross between the two
        packages."""
        return dict(
            store=self._store.snapshot(),
            base=self._base,
            blocks_done=self._blocks_done,
            kept_seen=self._kept_seen,
            int_dtype=(
                np.dtype(self._int_dtype).str if self._int_dtype is not None else None
            ),
            started=self._started,
            bits_emitted=self.bits_emitted,
        )

    def restore(self, snap: dict) -> None:
        """Load a :meth:`snapshot` into this (freshly created) session."""
        self._store.restore(snap["store"])
        self._base = int(snap["base"])
        self._blocks_done = int(snap["blocks_done"])
        self._kept_seen = int(snap["kept_seen"])
        self._int_dtype = (
            np.dtype(snap["int_dtype"]) if snap["int_dtype"] is not None else None
        )
        self._started = bool(snap["started"])
        self.bits_emitted = int(snap["bits_emitted"])

    def ready_blocks(self) -> int:
        """Highest block index b1 such that blocks [0, b1) are decodable now."""
        D, L = self.cfg.D, self.cfg.L
        return max(self._blocks_done, (self._stages_complete() - L) // D)

    # ---- internals -----------------------------------------------------------------
    def _finish_plan(self, n_bits: int | None) -> tuple[int, int, int]:
        """The flush arithmetic shared by every finish path.

        Returns ``(n_bits, n_blocks, prior)``: the resolved payload length,
        the total block count to decode, and the bits already covered by
        committed blocks. :meth:`finish` and ``PooledSession.finish`` both
        trim their flush launch with exactly this plan, so the solo and
        pooled tails are bit-identical for every non-block-aligned
        ``n_bits``.
        """
        D = self.cfg.D
        if n_bits is None:
            n_bits = self._base + len(self._store)
        return n_bits, -(-n_bits // D), self._blocks_done * D

    def _stages_complete(self) -> int:
        """Stages for which every (unpunctured) symbol has been received."""
        if not self.spec.is_punctured:
            return self._base + len(self._store)
        next_slot = int(self.spec.kept_slot_indices(self._kept_seen, 1)[0])
        return next_slot // self.spec.code.R

    def _ingest(self, chunk: np.ndarray) -> None:
        R = self.spec.code.R
        if chunk.size:
            # validate BEFORE buffering: a rejected chunk must leave the
            # session state untouched so the stream (or its quarantine) never
            # sees a half-ingested chunk
            check_finite_symbols(chunk, "session send()")
            # pre-quantized (integer) streams skip the session's quantization,
            # mirroring engine.decode; mixing dtypes would corrupt the buffer
            is_int = np.issubdtype(chunk.dtype, np.integer)
            if not self._started:
                self._int_dtype = chunk.dtype if is_int else None
                self._started = True
            elif is_int != (self._int_dtype is not None):
                raise SymbolError(
                    "cannot mix integer (pre-quantized) and float chunks "
                    "within one session"
                )
        if self.spec.is_punctured:
            if chunk.ndim != 1:
                # a punctured wire format is the 1-D kept-symbol stream; a
                # full-rate chunk would desynchronize the puncture phase
                raise SymbolError(
                    f"punctured sessions take 1-D punctured symbol chunks, "
                    f"got shape {chunk.shape}"
                )
            n = len(chunk)
            if n == 0:
                return
            slots = self.spec.kept_slot_indices(self._kept_seen, n)
            need_stages = int(slots[-1]) // R + 1
            grow = need_stages - (self._base + len(self._store))
            if grow > 0:
                self._store.grow(grow)
            local = slots - self._base * R
            self._store.scatter(local // R, local % R, chunk)
            self._kept_seen += n
        elif chunk.ndim == 2 and chunk.shape[1] == R:
            self._store.append(chunk)
        else:
            raise SymbolError(
                f"chunk shape {chunk.shape} invalid for code R={R} "
                f"(punctured={self.spec.is_punctured})"
            )

    def _frame_ready(self, b1: int) -> torch.Tensor:
        """Frame blocks [blocks_done, b1) → (T, R, b1 - blocks_done) quantized
        symbols on the engine's device, zero-padding the first block's left
        edge and the partial last block past the buffered tail.

        Only the buffered rows of the window cross to the device; the zero
        pads are added there after quantization (a zero symbol quantizes to
        zero), and the quantizer is elementwise, so the symbols equal the
        one-shot path's. Does NOT advance the session (see :meth:`_commit`).
        """
        b0 = self._blocks_done
        k = b1 - b0
        cfg = self.cfg
        D, L = cfg.D, cfg.L
        T = D + 2 * L
        lo = b0 * D - L  # global first stage of the combined window
        hi_pad = b1 * D + L  # exclusive global end incl. padding
        left_pad = max(0, -lo)  # only the very first block reaches stage -L
        need = hi_pad - max(lo, 0)
        window = self._store.read(max(lo, 0) - self._base, need)
        if self._int_dtype is not None:  # pre-quantized stream: exact passthrough
            y = self.engine._to_device(window.astype(self._int_dtype))
        else:
            y = torch.from_numpy(np.ascontiguousarray(window)).to(self.engine.device)
            y = cfg.quantize(y)
        y = F.pad(y, (0, 0, left_pad, need - len(window)))  # (k·D + 2L, R)
        idx = torch.arange(T, device=y.device)[:, None] + torch.arange(k, device=y.device) * D
        return y[idx].permute(0, 2, 1).contiguous()  # (T, R, k)

    def _commit(self, b1: int) -> None:
        """Advance past blocks [blocks_done, b1); trim the consumed buffer."""
        D, L = self.cfg.D, self.cfg.L
        self._blocks_done = b1
        new_base = max(0, b1 * D - L)
        drop = new_base - self._base
        if drop > 0:
            self._store.drop_prefix(min(drop, len(self._store)))
            self._base = new_base

    def _decode_upto(self, b1: int) -> torch.Tensor:
        """Decode blocks [blocks_done, b1) in one solo launch; advance."""
        k = b1 - self._blocks_done
        if k <= 0:
            return torch.zeros((0,), dtype=torch.int32, device=self.engine.device)
        # the lane budget of the engine (a multiple of its shard count), the
        # same padding the pooled launch uses, so a solo and a pooled flush
        # build identical launches lane for lane
        blocks = self.engine._pad_lanes(self._frame_ready(b1))
        bits = self.engine._decode_blocks(blocks, (k,))  # (D, k)
        out = bits.t().reshape(-1)
        self._commit(b1)
        return out
