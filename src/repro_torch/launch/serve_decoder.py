"""Serving entry point: streaming decode through the DecoderEngine + SessionPool.

    # one stream, one session:
    PYTHONPATH=src python -m repro_torch.launch.serve_decoder --code ccsds-3/4 \\
        --chunk-bits 4096 --n-chunks 100 --ebn0 4.0

    # many concurrent streams coalesced into batched launches:
    PYTHONPATH=src python -m repro_torch.launch.serve_decoder --streams 16 \\
        --chunk-bits 1024 --n-chunks 50

    # the asyncio service under a Poisson arrival trace:
    PYTHONPATH=src python -m repro_torch.launch.serve_decoder --serve-async \\
        --streams 64 --chunk-bits 4096 --n-chunks 16 --rate-chunks-per-s 25

    # crash drill: journal, SIGKILL at the 3rd dispatch, then recover:
    PYTHONPATH=src python -m repro_torch.launch.serve_decoder --serve-async \\
        --journal-dir /tmp/j --streams 4 --n-chunks 8 --kill-at 3
    PYTHONPATH=src python -m repro_torch.launch.serve_decoder --serve-async \\
        --journal-dir /tmp/j --streams 4 --n-chunks 8 --recover

    # the lane axis split over a mesh of every CUDA device torch finds:
    PYTHONPATH=src python -m repro_torch.launch.serve_decoder --mesh data=1 \\
        --shard-dispatch shard_map --streams 4

    # the decode fleet across processes, one per host (torchrun sets RANK;
    # two ranks on one card: --nproc-per-node 2 and --mesh data=2):
    PYTHONPATH=src torchrun --nnodes N --nproc-per-node 1 --node-rank i \\
        --master-addr host0 --master-port 29500 \\
        -m repro_torch.launch.serve_decoder --mesh data=N --streams 64

The counterpart of ``repro.launch.serve_decoder``. A long-lived session
object carries the decoder state (the inter-block overlap tail + puncture
phase) across chunks, so an unbounded symbol stream decodes chunk by chunk —
the serving shape of the paper's multi-stream pipelining (§IV-D). It runs on
the card (``--device cuda``, the default, with ``--backend cuda``);
``--device cpu`` is a rehearsal with the kernels' plain versions, whose
times are the CPU's. ``--mesh`` builds its mesh over every CUDA device torch
finds (over the CPU with ``--device cpu``), so on one card it takes
``--mesh data=1``. Under ``--mesh`` the CLI first starts the process group
that torchrun's environment describes
(:func:`~repro_torch.launch.mesh.maybe_init_distributed`), as the
reference does; the mesh then spans every rank's devices, each rank
launches the lane shards it holds, and every rank prints the whole run's
result. The async modes refuse such a mesh.

The :class:`SessionPool` is the multi-tenant layer on top: many concurrent
:class:`~repro_torch.core.engine.DecoderSession`\\ s register with the pool,
chunks are *fed* (buffered) per session, and :meth:`SessionPool.step`
coalesces every session's ready blocks — grouped by launch compatibility —
into ONE ``pbvd_decode_blocks`` launch per group (one launch of each kernel
the backend runs). Each session keeps its own overlap tail and puncture
phase; only the launch is shared, so per-session bits stay bit-exact to a
solo session.
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import numpy as np
import torch

from repro_torch.core.channel import transmit
from repro_torch.core.codespec import available_code_specs, get_code_spec
from repro_torch.core.encoder import encode, terminate
from repro_torch.core.engine import DecoderEngine, DecoderSession
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import (
    DEFAULT_TB_CHUNK,
    available_backends,
    backend_tb_chunk_sensitive,
)
from repro_torch.kernels.registry import resolve_tb_mode
from repro_torch.launch.faults import StreamError
from repro_torch.launch.mesh import make_decode_mesh, maybe_init_distributed

__all__ = ["SessionPool", "PooledSession", "main"]


def _no_bits(device) -> torch.Tensor:
    return torch.zeros((0,), dtype=torch.int32, device=device)


class PooledSession:
    """One stream's handle inside a :class:`SessionPool`.

    ``feed`` buffers a chunk (no launch); decoded bits arrive on the next
    :meth:`SessionPool.step` and are drained with :meth:`take`. ``finish``
    flushes the zero-padded tail exactly like ``DecoderSession.finish``.
    """

    def __init__(self, pool: "SessionPool", session: DecoderSession):
        self._pool = pool
        self._session = session
        self._queue: list[torch.Tensor] = []
        self.bits_emitted = 0

    def feed(self, chunk) -> None:
        """Buffer a chunk of received symbols (same wire formats as
        ``DecoderSession.decode``); decoding happens at ``pool.step()``."""
        self._session.ingest(chunk)

    def take(self) -> torch.Tensor:
        """Drain every decoded bit delivered by pool steps so far."""
        if not self._queue:
            return _no_bits(self._session.engine.device)
        out = torch.cat(self._queue)
        self._queue.clear()
        return out

    def finish(self, n_bits: int | None = None) -> torch.Tensor:
        """Flush the stream: any undrained step() output first, then the
        remaining blocks (zero-padded tail), trimmed so the session's total
        delivery is ``n_bits``.

        Undelivered step() output is folded into the return value (an
        implicit :meth:`take`), so ``finish`` alone accounts for every
        decoded bit. The flush launch is framed and trimmed by the same
        ``DecoderSession._finish_plan`` / ``_frame_ready`` path as
        ``DecoderSession.finish``, so pooled and solo tails are
        bit-identical for every non-block-aligned ``n_bits``.
        """
        s = self._session
        n_bits, n_blocks, prior = s._finish_plan(n_bits)
        if n_blocks > s._blocks_done:
            # launch BEFORE draining the queue: a failed flush launch then
            # leaves the handle exactly as it was (the launch commits nothing
            # on failure), so the caller can retry finish() without losing
            # the undrained step() output
            tail = self._pool._launch([(self, n_blocks)])[0]
        else:
            tail = _no_bits(s.engine.device)
        head = self.take()
        tail = tail[: max(0, n_bits - prior)]
        self.bits_emitted += tail.shape[0]
        return torch.cat([head, tail]) if head.shape[0] else tail

    def _deliver(self, bits: torch.Tensor) -> None:
        self._queue.append(bits)
        self.bits_emitted += bits.shape[0]


class SessionPool:
    """Coalesce the ready blocks of many concurrent sessions into batched
    kernel launches.

    Sessions are grouped by *launch compatibility* — the key is
    ``(mother code, D, L, backend, start_policy, metric_mode, acs_impl,
    radix under butterfly, k under matrix, resolved tb_mode, tb_chunk where
    it matters, window dtype, engine device or mesh identity)``: everything
    that shapes or parameterizes the launch. The mesh identity is
    content-based — axis names, shape, devices as (owning rank, type,
    index), the engine's ``block_axes`` and shard dispatch — never
    ``id(mesh)``; the rank keeps two hosts' ``cuda:0`` apart. Code
    specs that share a mother code but differ in puncturing land in the
    same group (puncturing only affects ingest), as do sessions with
    different payload lengths or chunk cadences; a CPU engine and a CUDA
    engine never share a launch.

    One :meth:`step` builds, per group, a single frames × blocks lane axis
    from each member's ready window (``frame_counts`` records the
    per-session block counts), pads it to the lead engine's lane budget
    (nothing without a mesh: the kernels mask the ragged lane edge; a
    multiple of the shard count with one), launches once, and hands the
    per-frame bits back to each session, which then advances its own
    overlap tail exactly as a solo launch would have. On a mesh that spans
    processes every rank opens, feeds and steps the same sessions in the
    same order, so each step makes the same groups in the same order on
    every rank, and each group's launch joins every rank's shards.
    """

    def __init__(self):
        self._members: list[PooledSession] = []
        # strong refs to each pooled engine's mesh for the membership's
        # lifetime: the group key describes the mesh by CONTENT, and pinning
        # the object here guarantees no two live members' meshes can alias.
        # Keyed by the PooledSession OBJECT (identity hash): an ``id(ps)``
        # key could alias a closed-and-collected member's reused id onto a
        # new member, dropping or double-releasing the wrong mesh pin
        self._mesh_refs: dict[PooledSession, object] = {}
        self.launches = 0  # batched launches issued (for reporting/tests)
        # fault-tolerance hooks: ``fault_hook(entries, isolating)`` is
        # consulted before every launch (the injection point for a fault
        # injector); quarantined members land in ``quarantined`` as
        # (session, StreamError) pairs for the serving layer to drain
        self.fault_hook = None
        self.quarantined: list[tuple[PooledSession, StreamError]] = []

    # ---- membership ----------------------------------------------------------------
    def open(self, engine: DecoderEngine, *, store=None) -> PooledSession:
        """Open a pooled streaming session on ``engine``; ``store`` is
        forwarded to :meth:`DecoderEngine.session`. Pool state is mutated
        atomically: a partially failed open leaves neither a membership
        entry nor a mesh pin behind."""
        ps = PooledSession(self, engine.session(store=store))
        try:
            self._members.append(ps)
            if engine.mesh is not None:
                self._mesh_refs[ps] = engine.mesh
        except BaseException:
            if ps in self._members:
                self._members.remove(ps)
            self._mesh_refs.pop(ps, None)
            raise
        return ps

    def close(self, ps: PooledSession) -> None:
        """Remove a session from the pool (it keeps its buffered state).
        Idempotent: closing a closed (or never-opened) member is a no-op,
        and the member's mesh pin is released exactly once."""
        if ps in self._members:
            self._members.remove(ps)
        self._mesh_refs.pop(ps, None)

    def __len__(self) -> int:
        return len(self._members)

    # ---- scheduling ----------------------------------------------------------------
    def pending_blocks(self) -> int:
        """Blocks decodable right now across every member."""
        return sum(
            ps._session.ready_blocks() - ps._session._blocks_done
            for ps in self._members
        )

    def step(self, *, isolate: bool = False) -> int:
        """Decode every ready block in the pool; returns the block count.

        Sessions with no complete window are skipped; compatible sessions
        share one launch per group. A failed launch commits nothing —
        sessions only advance after their bits exist — so a plain ``step``
        that raises is safely retryable as-is.

        ``isolate=True`` switches to the quarantine protocol: a group whose
        launch raises is bisected until the culprit member(s) are isolated,
        each culprit is removed from the pool with a typed
        :class:`~repro_torch.launch.faults.StreamError` recorded in
        ``self.quarantined``, and every healthy member's relaunch delivers
        bits identical to an undisturbed step (PBVD blocks are mutually
        independent, so batch composition never changes per-stream bits).
        """
        groups: dict[tuple, list[tuple[PooledSession, int]]] = defaultdict(list)
        for ps in self._members:
            s = ps._session
            b1 = s.ready_blocks()
            if b1 > s._blocks_done:
                groups[self._group_key(s)].append((ps, b1))
        total = 0
        for entries in groups.values():
            if isolate:
                delivered = self._launch_isolated(entries)
            else:
                delivered = list(zip(entries, self._launch(entries)))
            for (ps, _), bits in delivered:
                ps._deliver(bits)
                total += bits.shape[0] // ps._session.cfg.D
        return total

    # ---- internals -----------------------------------------------------------------
    @staticmethod
    def _group_key(s: DecoderSession) -> tuple:
        cfg = s.cfg
        q = cfg.effective_q  # narrow metric modes force/cap the quantizer
        if s._int_dtype is not None:
            dt = np.dtype(s._int_dtype).str
        elif q is not None:
            dt = "int8" if q <= 8 else "int16"
        else:
            dt = "float32"
        # the mesh enters the key by CONTENT plus the engine's lane-axis
        # binding: two engines on the same mesh but different block_axes (or
        # dispatch) split the lanes differently and must not coalesce, while
        # equal meshes built twice must
        eng = s.engine
        if eng.mesh is None:
            placement = eng.device
        else:
            placement = (
                tuple(eng.mesh.axis_names),
                tuple((a, int(n)) for a, n in eng.mesh.shape.items()),
                tuple((int(r), d.type, d.index)
                      for r, d in zip(eng.mesh.owners.flat, eng.mesh.devices.flat)),
                eng.block_axes,
                eng.shard_dispatch,
            )
        # key on the RESOLVED tb mode so an "auto" session coalesces with
        # one that spelled the backend's preferred mode out explicitly
        tb_mode = resolve_tb_mode(cfg.backend, cfg.tb_mode)
        return (
            cfg.code,
            cfg.D,
            cfg.L,
            cfg.backend,
            cfg.start_policy,
            cfg.metric_mode,
            # each acs_impl's inert knob is dropped from the key, so e.g.
            # matrix sessions coalesce regardless of their butterfly radix
            cfg.acs_impl,
            cfg.acs_radix if cfg.acs_impl == "butterfly" else None,
            cfg.acs_k if cfg.acs_impl == "matrix" else None,
            tb_mode,
            # tb_chunk only parameterizes chunk-sensitive prefix launches
            cfg.tb_chunk
            if tb_mode == "prefix" and backend_tb_chunk_sensitive(cfg.backend)
            else None,
            dt,
            placement,
        )

    def _launch(
        self,
        entries: list[tuple[PooledSession, int]],
        *,
        isolating: bool = False,
    ) -> list[torch.Tensor]:
        """One batched launch for ``entries`` = [(session, decode-up-to-b1)].

        Returns each entry's decoded bits (whole blocks, forward order) and
        commits each session's overlap tail past the decoded blocks. An
        exception (from the hook or the kernel) commits NOTHING, so the
        identical launch can be rebuilt from session state.
        """
        if self.fault_hook is not None:
            self.fault_hook(entries, isolating)
        frames, counts = [], []
        for ps, b1 in entries:
            s = ps._session
            frames.append(s._frame_ready(b1))
            counts.append(b1 - s._blocks_done)
        packed = torch.cat(frames, dim=2) if len(frames) > 1 else frames[0]
        lead = entries[0][0]._session
        # the lead engine's lane budget — identical for every member, since
        # the group key includes the full mesh identity + block_axes
        packed = lead.engine._pad_lanes(packed)
        bits = lead.engine._decode_blocks(packed, tuple(counts))  # (D, sum(counts))
        self.launches += 1
        outs, lo = [], 0
        for (ps, b1), k in zip(entries, counts):
            outs.append(bits[:, lo : lo + k].t().reshape(-1))
            ps._session._commit(b1)
            lo += k
        return outs

    # ---- quarantine ----------------------------------------------------------------
    def _launch_isolated(
        self, entries: list[tuple[PooledSession, int]]
    ) -> list[tuple[tuple[PooledSession, int], torch.Tensor]]:
        """Launch ``entries``, bisecting on failure to isolate culprits.

        Healthy members decode bit-exact to the full coalesced launch (block
        independence); members whose single-member launch still fails are
        quarantined via :meth:`_quarantine` and excluded from the result.
        Worst case this costs O(f·log n) launches for f culprits among n
        members.
        """
        try:
            outs = self._launch(entries, isolating=True)
            return list(zip(entries, outs))
        except Exception as exc:  # noqa: BLE001 - classify, don't mask
            if len(entries) == 1:
                ps = entries[0][0]
                err = (
                    exc
                    if isinstance(exc, StreamError)
                    else StreamError(
                        f"stream quarantined: its lane-group reproducibly "
                        f"fails the launch ({exc!r})",
                        stream=ps,
                    )
                )
                if err.__cause__ is None and err is not exc:
                    err.__cause__ = exc
                self._quarantine(ps, err)
                return []
            mid = len(entries) // 2
            return self._launch_isolated(entries[:mid]) + self._launch_isolated(
                entries[mid:]
            )

    def _quarantine(self, ps: PooledSession, err: StreamError) -> None:
        """Remove ``ps`` from the pool and record its typed failure; the
        member's buffered session state is left intact."""
        self.close(ps)
        self.quarantined.append((ps, err))

    def drain_quarantined(self) -> list[tuple[PooledSession, StreamError]]:
        """Hand the accumulated quarantine records to the caller (and reset)."""
        out, self.quarantined = self.quarantined, []
        return out

    def repoint_engine(self, old: DecoderEngine, new: DecoderEngine) -> int:
        """Swap every member bound to engine ``old`` onto ``new`` (mesh-loss
        rescale), moving its mesh pin. Members' ready-but-undecoded blocks
        replay on the new engine at the next step, bit-exact to the
        uninterrupted run (block content is host-side session state and the
        mesh only places lanes). Returns the number of members repointed.
        """
        n = 0
        for ps in self._members:
            s = ps._session
            if s.engine is old:
                s.engine = new
                if new.mesh is not None:
                    self._mesh_refs[ps] = new.mesh
                else:
                    self._mesh_refs.pop(ps, None)
                n += 1
        return n


# ---------------------------------------------------------------------------
# Command line
# ---------------------------------------------------------------------------
def _make_stream(spec, n_bits: int, ebn0: float, seed: int, device):
    """A seeded transmission: the payload (numpy) and the received symbols,
    made on ``device`` and handed over as host numpy, as a receiver's
    front end would deliver them."""
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 2, n_bits)
    coded = encode(torch.as_tensor(terminate(payload, spec.code), device=device), spec.code)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    gen = torch.Generator(device=device).manual_seed(seed)
    return payload, transmit(gen, tx, ebn0, spec.rate).cpu().numpy()


def _latency_summary(lat_ms) -> str:
    """p50/p99 of a latency sample, guarded for tiny sample counts —
    ``np.percentile`` on an empty array raises, and a p99 quoted from a
    handful of chunks is noise dressed as a tail, so say so."""
    lat = np.asarray(lat_ms, np.float64)
    if lat.size == 0:
        return "no latency samples"
    out = f"p50={np.percentile(lat, 50):.1f} ms p99={np.percentile(lat, 99):.1f} ms"
    if lat.size < 20:  # p99 interpolated from < 20 samples ≈ the max
        out += f" (n={lat.size}: p99≈max)"
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve_single(engine, spec, cfg, args) -> None:
    n_bits = args.chunk_bits * args.n_chunks
    payload, y = _make_stream(spec, n_bits, args.ebn0, args.seed, engine.device)
    sess = engine.session()
    bounds = np.linspace(0, len(y), args.n_chunks + 1).astype(int)
    decoded, lat_ms = [], []
    t0 = time.perf_counter()
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        t1 = time.perf_counter()
        decoded.append(sess.decode(y[lo:hi]))
        _sync(engine.device)  # a chunk's latency ends when its bits exist
        lat_ms.append((time.perf_counter() - t1) * 1e3)
    # the finish flush decodes the final (often largest) window
    t1 = time.perf_counter()
    decoded.append(sess.finish(n_bits))
    _sync(engine.device)
    lat_ms.append((time.perf_counter() - t1) * 1e3)
    dt = time.perf_counter() - t0

    bits = torch.cat(decoded).cpu().numpy()
    errors = int(np.sum(bits != payload))
    print(
        f"[serve_decoder] {n_bits} bits in {dt*1e3:.0f} ms → {n_bits/dt/1e6:.2f} Mbps; "
        f"chunk latency {_latency_summary(lat_ms)}"
    )
    print(f"[serve_decoder] BER = {errors / n_bits:.2e} ({errors} errors)")


def _serve_pooled(engine, spec, cfg, args) -> None:
    n_bits = args.chunk_bits * args.n_chunks
    streams = [
        _make_stream(spec, n_bits, args.ebn0, args.seed + i, engine.device)
        for i in range(args.streams)
    ]
    pool = SessionPool()
    handles = [pool.open(engine) for _ in streams]
    bounds = np.linspace(0, len(streams[0][1]), args.n_chunks + 1).astype(int)
    outs = [[] for _ in streams]
    step_ms = []
    t0 = time.perf_counter()
    for lo, hi in zip(bounds[:-1], bounds[1:]):  # one ingest round, one step
        for (_, y), h in zip(streams, handles):
            h.feed(y[lo:hi])
        t1 = time.perf_counter()
        pool.step()
        _sync(engine.device)
        step_ms.append((time.perf_counter() - t1) * 1e3)
        for i, h in enumerate(handles):
            outs[i].append(h.take())
    for i, h in enumerate(handles):
        outs[i].append(h.finish(n_bits))
    _sync(engine.device)
    dt = time.perf_counter() - t0

    total_bits = n_bits * args.streams
    errors = sum(
        int(np.sum(torch.cat(o).cpu().numpy() != p)) for o, (p, _) in zip(outs, streams)
    )
    print(
        f"[serve_decoder] {args.streams} streams × {n_bits} bits in {dt*1e3:.0f} ms "
        f"→ aggregate {total_bits/dt/1e6:.2f} Mbps; "
        f"{pool.launches} batched launches "
        f"({args.n_chunks * args.streams} chunks fed); "
        f"step latency {_latency_summary(step_ms)}"
    )
    print(
        f"[serve_decoder] BER = {errors/total_bits:.2e} ({errors} errors "
        f"over {total_bits} bits)"
    )


def _serve_async_durable(engine, spec, cfg, args) -> int:
    """Durable serving drill: journaled admissions, client-side delivered-bit
    persistence, optional mid-trace SIGKILL, and ``recover()`` restart.

    The client protocol per stream ``i``:

    * deliveries are drained with ``take(ack=False)``, appended to
      ``{journal_dir}/delivered-{i}.bits`` (one uint8 byte per bit),
      fsync'd, and only THEN acked — so the service's ack watermark never
      runs ahead of the durable file;
    * sending resumes from ``stream.chunks_admitted`` (the WAL-derived
      cursor), so a chunk lost in the crash gap between ``send()`` and its
      admit record is simply re-sent;
    * on ``--recover``, each file is truncated back to the recovered ack
      watermark — bytes persisted after the last durable ack are exactly
      the bits recovery will redeliver (the no-duplicate invariant).

    Returns a process exit code: 0 = every stream's delivered bits match
    the one-shot decode on the engine's device, 1 = mismatch, 3 =
    ``--kill-at`` was set but the trace completed without reaching it.
    """
    import asyncio
    import os
    import signal

    from repro_torch.launch.journal import ChunkJournal
    from repro_torch.launch.serve_async import AsyncDecodeService
    from repro_torch.launch.slab import SymbolSlab

    n_bits = args.chunk_bits * args.n_chunks
    streams = [
        _make_stream(spec, n_bits, args.ebn0, args.seed + i, engine.device)
        for i in range(args.streams)
    ]
    cs = max(1, len(streams[0][1]) // args.n_chunks)
    chunk_lists = [
        [y[k * cs : (k + 1) * cs] for k in range(-(-len(y) // cs))]
        for _, y in streams
    ]
    slab = SymbolSlab(
        n_pages=args.slab_pages, page_stages=cfg.D + 2 * cfg.L, R=spec.code.R
    )
    journal = ChunkJournal(args.journal_dir)
    service_kwargs = dict(
        max_batch_blocks=args.max_batch_blocks,
        deadline_ms=args.deadline_ms,
        slab=slab,
        journal=journal,
        integrity_rate=args.integrity_rate,
    )
    if args.kill_at is not None:

        def _kill_hook(svc):
            if svc.dispatches >= args.kill_at:
                os.kill(os.getpid(), signal.SIGKILL)  # no cleanup: a real crash

        service_kwargs["on_dispatch"] = _kill_hook

    async def _client(i, stream):
        path = os.path.join(args.journal_dir, f"delivered-{i}.bits")
        if stream is None:  # finished before the crash; its file is complete
            return
        mode = "r+b" if args.recover and os.path.exists(path) else "wb"
        with open(path, mode) as f:
            if mode == "r+b":
                f.seek(0, os.SEEK_END)
                if f.tell() < stream.acked_bits:
                    raise RuntimeError(
                        f"stream {i}: durable file shorter than ack watermark "
                        f"({f.tell()} < {stream.acked_bits})"
                    )
                f.truncate(stream.acked_bits)  # un-acked tail gets redelivered
                f.seek(0, os.SEEK_END)

            def persist(bits):
                if bits.shape[0]:
                    f.write(bits.to(torch.uint8).cpu().numpy().tobytes())
                    f.flush()
                    os.fsync(f.fileno())
                stream.ack()

            chunks = chunk_lists[i]
            # paced sends (deterministic spacing, not Poisson): the deadline
            # dispatcher must run between arrivals, or the whole trace would
            # flush inside finish() and no --kill-at boundary would be crossed
            gap_s = 1.0 / args.rate_chunks_per_s if args.rate_chunks_per_s else 0.0
            for k in range(stream.chunks_admitted, len(chunks)):
                await stream.send(chunks[k])
                await asyncio.sleep(gap_s)
                persist(stream.take(ack=False))
            persist(await stream.finish(n_bits))

    async def drive():
        if args.recover:
            kw = {k: v for k, v in service_kwargs.items() if k != "journal"}
            svc = AsyncDecodeService.recover(journal, engine, **kw)
        else:
            svc = AsyncDecodeService(**service_kwargs)
        async with svc:
            # sid == stream index by construction: streams open in index
            # order on the fresh run, and sids are stable across recovery
            if args.recover:
                handles = [svc.recovered_streams.get(i) for i in range(args.streams)]
            else:
                handles = [svc.open(engine) for _ in range(args.streams)]
            await asyncio.gather(*(_client(i, h) for i, h in enumerate(handles)))
            return svc.metrics()

    t0 = time.perf_counter()
    m = asyncio.run(drive())
    dt = time.perf_counter() - t0
    journal.close()
    if args.kill_at is not None:
        print(
            f"[serve_decoder] --kill-at {args.kill_at} never reached "
            f"({m['dispatches']} dispatches total)"
        )
        return 3

    bad = 0
    for i, (_, y) in enumerate(streams):
        path = os.path.join(args.journal_dir, f"delivered-{i}.bits")
        with open(path, "rb") as f:
            got = np.frombuffer(f.read(), np.uint8)
        ref = engine.decode(y, n_bits).cpu().numpy()
        if len(got) != n_bits or np.any(got != ref):
            bad += 1
            print(f"[serve_decoder] stream {i}: delivered bits != reference")
    print(
        f"[serve_decoder] durable: {args.streams} streams × {n_bits} bits in "
        f"{dt*1e3:.0f} ms ({m['dispatches']} dispatches, "
        f"{m['checkpoints']} checkpoints, journal seq {m['journal_seq']}, "
        f"integrity {m['integrity_flagged']}/{m['integrity_checked']} flagged); "
        f"{'all streams bit-exact vs reference' if not bad else f'{bad} stream(s) MISMATCHED'}"
    )
    return 0 if bad == 0 else 1


def _serve_async(engine, spec, cfg, args) -> None:
    """Drive the asyncio service under a Poisson arrival trace (the
    serving-layer shape: admission → paged slabs → deadline dispatch)."""
    import asyncio

    from repro_torch.launch.serve_async import run_poisson_trace
    from repro_torch.launch.slab import SymbolSlab

    n_bits = args.chunk_bits * args.n_chunks
    streams = [
        _make_stream(spec, n_bits, args.ebn0, args.seed + i, engine.device)
        for i in range(args.streams)
    ]
    ys = [y for _, y in streams]
    chunk_symbols = max(1, len(ys[0]) // args.n_chunks)
    slab = SymbolSlab(
        n_pages=args.slab_pages,
        page_stages=cfg.D + 2 * cfg.L,
        R=spec.code.R,
    )
    t0 = time.perf_counter()
    bits, report = asyncio.run(
        run_poisson_trace(
            engine,
            ys,
            [n_bits] * len(ys),
            chunk_symbols=chunk_symbols,
            rate_chunks_per_s=args.rate_chunks_per_s,
            seed=args.seed,
            slab=slab,
            service_kwargs=dict(
                max_batch_blocks=args.max_batch_blocks,
                deadline_ms=args.deadline_ms,
            ),
        )
    )
    dt = time.perf_counter() - t0
    total_bits = n_bits * args.streams
    errors = sum(
        int(np.sum(b.cpu().numpy() != p)) for b, (p, _) in zip(bits, streams)
    )
    mbps = report["sustained_mbps"]
    print(
        f"[serve_decoder] async: {args.streams} streams × {n_bits} bits in "
        f"{dt*1e3:.0f} ms → sustained "
        f"{mbps if mbps is not None else float('nan'):.2f} Mbps "
        f"({report['dispatches']} dispatches, {report['launches']} launches, "
        f"slab high-water {report['slab_pages_high_water']} pages); "
        f"chunk latency p50={report['p50_ms']:.1f} ms p99={report['p99_ms']:.1f} ms"
    )
    print(
        f"[serve_decoder] BER = {errors/total_bits:.2e} ({errors} errors "
        f"over {total_bits} bits)"
    )


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--code", default="ccsds", choices=available_code_specs())
    ap.add_argument("--backend", default="cuda", choices=available_backends())
    ap.add_argument(
        "--device", default=None, help="cuda (the default) or cpu for a rehearsal"
    )
    ap.add_argument("--d", type=int, default=512, help="decode block length D")
    ap.add_argument("--l", type=int, default=42, help="traceback depth L")
    ap.add_argument("--q", type=int, default=8, help="quantization bits (0 = float32)")
    ap.add_argument(
        "--metric-mode",
        default="f32",
        choices=["f32", "i16", "i8"],
        help="path-metric pipeline (narrow modes re-cap q to the saturation budget)",
    )
    ap.add_argument(
        "--tb-mode",
        default="auto",
        choices=["auto", "serial", "prefix"],
        help="traceback algorithm (auto = the backend's declared mode; "
        "prefix = chunked survivor-map composition)",
    )
    ap.add_argument(
        "--tb-chunk",
        type=int,
        default=DEFAULT_TB_CHUNK,
        help="prefix traceback chunk size (stages composed per chunk map)",
    )
    ap.add_argument(
        "--acs-radix",
        type=int,
        default=2,
        choices=[2, 4],
        help="forward-ACS radix (4 = stage-fused two-stage steps, bit-exact)",
    )
    ap.add_argument(
        "--acs-impl",
        default="butterfly",
        choices=["butterfly", "matrix"],
        help="forward-pass formulation (matrix = k-stage (min,+) steps, bit-exact)",
    )
    ap.add_argument(
        "--acs-k",
        type=int,
        default=2,
        help="matrix-ACS fusion depth k (stages per (min,+) step)",
    )
    ap.add_argument(
        "--mesh",
        default=None,
        metavar="AXIS=N[,AXIS=N]",
        help="split the lane (parallel-block) axis over a mesh of every CUDA "
        "device torch finds (of the CPU with --device cpu), e.g. data=1 on "
        "one card; under torchrun, of every rank's; see repro_torch.launch.mesh",
    )
    ap.add_argument(
        "--shard-dispatch",
        default="constraint",
        choices=["constraint", "shard_map"],
        help="mesh dispatch: each shard's real lanes only, or every lane of "
        "equal slices with the pad lanes trimmed after the join (bit-identical)",
    )
    ap.add_argument("--chunk-bits", type=int, default=4096, help="payload bits per chunk")
    ap.add_argument("--n-chunks", type=int, default=100)
    ap.add_argument(
        "--streams",
        type=int,
        default=1,
        help="concurrent streams; >1 coalesces sessions through a SessionPool",
    )
    ap.add_argument("--ebn0", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--serve-async",
        action="store_true",
        help="drive the asyncio serving layer (repro_torch.launch.serve_async) "
        "under a Poisson arrival trace instead of the synchronous loop",
    )
    ap.add_argument(
        "--deadline-ms",
        type=float,
        default=5.0,
        help="async dispatch deadline: max age of the oldest undispatched "
        "chunk before a coalesced step fires anyway",
    )
    ap.add_argument(
        "--max-batch-blocks",
        type=int,
        default=32,
        help="async dispatch size trigger: ready blocks that fire a step",
    )
    ap.add_argument(
        "--slab-pages",
        type=int,
        default=1024,
        help="session-state slab capacity (pages of D+2L stages each)",
    )
    ap.add_argument(
        "--rate-chunks-per-s",
        type=float,
        default=1000.0,
        help="per-stream Poisson chunk arrival rate for --serve-async",
    )
    ap.add_argument(
        "--journal-dir",
        default=None,
        help="with --serve-async: write-ahead journal admitted chunks + "
        "checkpoint session state under this directory, and persist each "
        "stream's delivered bits to delivered-<i>.bits (crash-safe serving)",
    )
    ap.add_argument(
        "--integrity-rate",
        type=float,
        default=0.0,
        help="fraction of deliveries screened by the re-encode integrity "
        "sentinel (0 = off; 1 = every delivery); flagged streams quarantine "
        "with IntegrityError",
    )
    ap.add_argument(
        "--kill-at",
        type=int,
        default=None,
        help="with --journal-dir: SIGKILL this process the moment the "
        "dispatch counter reaches N (crash drill; exit 3 if never reached)",
    )
    ap.add_argument(
        "--recover",
        action="store_true",
        help="with --journal-dir: rebuild the service from the journal "
        "(checkpoint + replay) instead of starting fresh, resume the trace, "
        "and verify delivered bits against the one-shot decode",
    )
    args = ap.parse_args(argv)
    if (args.kill_at is not None or args.recover) and args.journal_dir is None:
        ap.error("--kill-at/--recover require --journal-dir")
    if args.journal_dir is not None and not args.serve_async:
        ap.error("--journal-dir requires --serve-async")

    device = resolve_device(args.device, user="serve_decoder")
    spec = get_code_spec(args.code)
    cfg = PBVDConfig(
        spec=spec,
        D=args.d,
        L=args.l,
        q=args.q or None,
        backend=args.backend,
        metric_mode=args.metric_mode,
        tb_mode=args.tb_mode,
        tb_chunk=args.tb_chunk,
        acs_radix=args.acs_radix,
        acs_impl=args.acs_impl,
        acs_k=args.acs_k,
    )
    # under --mesh, torchrun's environment starts the process group first (a
    # no-op without it); a group started here is destroyed here
    started = bool(args.mesh) and maybe_init_distributed()
    try:
        mesh = None
        if args.mesh:
            mesh = make_decode_mesh(args.mesh,
                                    devices=None if device.type == "cuda" else [device])
        _serve(cfg, spec, device, mesh, args)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _serve(cfg, spec, device, mesh, args) -> None:
    engine = DecoderEngine(
        cfg,
        device=device,
        mesh=mesh,
        block_axes=None if mesh is not None else ("data",),
        shard_dispatch=args.shard_dispatch,
    )
    if mesh is not None:
        ranks = (
            f" of ranks {mesh.owners.flatten().tolist()} (this is rank "
            f"{mesh.process_index} of {mesh.process_count})"
            if mesh.spans_processes
            else ""
        )
        print(
            f"[serve_decoder] mesh {dict(mesh.shape)} over {mesh.size} device(s) "
            f"[{', '.join(str(d) for d in mesh.devices.flat)}]{ranks}; lane axis on "
            f"{engine.block_axes} ({engine.n_shards} shards, "
            f"dispatch={engine.shard_dispatch})"
        )
    where = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    print(
        f"[serve_decoder] {spec.name} on {where}: K={spec.code.K}, rate={spec.rate:.3f}, "
        f"D={cfg.D}, L={cfg.L}, q={cfg.effective_q}, backend={cfg.backend}, "
        f"metric_mode={cfg.metric_mode}, tb_mode={cfg.tb_mode} "
        f"(→ {resolve_tb_mode(cfg.backend, cfg.tb_mode)}), "
        f"acs_impl={cfg.acs_impl}"
        f"{f' (k={cfg.acs_k})' if cfg.acs_impl == 'matrix' else f', acs_radix={cfg.acs_radix}'}; "
        f"{args.streams} stream(s) × {args.chunk_bits * args.n_chunks} payload bits "
        f"in {args.n_chunks} chunks at Eb/N0={args.ebn0} dB"
    )
    if args.serve_async and args.journal_dir is not None:
        raise SystemExit(_serve_async_durable(engine, spec, cfg, args))
    elif args.serve_async:
        _serve_async(engine, spec, cfg, args)
    elif args.streams > 1:
        _serve_pooled(engine, spec, cfg, args)
    else:
        _serve_single(engine, spec, cfg, args)


if __name__ == "__main__":
    main()
