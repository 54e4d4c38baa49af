"""Async decode serving: admission → paged slabs → deadline dispatch → delivery.

The counterpart of ``repro.launch.serve_async``. The kernels turn coalesced
blocks into throughput; what they cannot do is absorb the arrival jitter of
real traffic — a synchronous serve loop either launches tiny batches or
stalls streams waiting for a full one. This module is that layer, four
stages deep:

* **admission** — :meth:`AsyncStream.send` buffers a chunk into the
  stream's session state. Admission is bounded two ways: a cap on pool-wide
  ready-but-undecoded blocks (``max_pending_blocks``) and the symbol slab's
  fixed page budget (:class:`~repro_torch.launch.slab.SymbolSlab`). Hitting
  either applies backpressure — the send awaits the next dispatch — or
  raises :class:`Backpressure` when the service is configured non-blocking.
* **paging** — per-stream symbol state (the overlap tail + puncture phase)
  lives in host slab pages drawn from a shared free-list.
* **deadline dispatch** — a :class:`DeadlineBatcher` fires
  ``SessionPool.step()`` when the pool has ``max_batch_blocks`` ready
  blocks OR the oldest undispatched chunk has waited ``deadline_ms``,
  whichever comes first. The batcher is a pure function of an injectable
  clock, so trigger behaviour is testable under a fake clock.
* **delivery** — decoded bits land per stream as int32 tensors on the
  engine's device (:meth:`AsyncStream.take` / :meth:`AsyncStream.finish`),
  and every admitted chunk's latency (admission → the dispatch whose bits
  hold its last symbol's decision, taken once those bits exist on the
  device) feeds the p50/p99 and sustained-Mb/s accounting of
  :meth:`AsyncDecodeService.metrics`.

Every decode goes through the same ``SessionPool`` launches as the
synchronous serve loop, so service output is bit-exact to per-stream one-shot
``engine.decode`` — the async layer only decides WHEN ``step()`` runs.

The service's own host bookkeeping (the encoder state the integrity
sentinel tracks, the sentinel's re-encode, a checkpoint's unacked bits)
reads delivered bits through at most one device→host copy per dispatch,
gathered over all streams; that copy is also where a dispatch's completion
time is taken.

    async with AsyncDecodeService(slab=SymbolSlab(256, 596, 2)) as svc:
        stream = svc.open(engine)
        await stream.send(chunk)            # backpressure-aware
        ...
        bits = await stream.finish(n_bits)  # take() fold + flushed tail

Failure behaviour: per-stream causes quarantine ONLY that stream (its
waiters get a typed :class:`~repro_torch.launch.faults.StreamError`,
everyone else completes bit-exact); transient dispatch failures retry under
a bounded :class:`~repro_torch.launch.faults.RetryPolicy`; device loss
(:class:`~repro_torch.launch.faults.MeshLost`) rebuilds every mesh-bound
engine on a smaller mesh (or meshless) via
:func:`~repro_torch.launch.elastic.rescale_decode_engine` and replays the
ready blocks from session state (a meshless engine only replays); capacity
exhaustion past ``shed_deadline_ms`` sheds the admission; and a dispatcher
death propagates to every parked sender/finisher and resurfaces from
:meth:`AsyncDecodeService.aclose` — nothing hangs.

The service runs in one process: an engine whose mesh spans processes is
refused at :meth:`AsyncDecodeService.open` and :meth:`~AsyncDecodeService.recover`
with ``ValueError``. Its deadline trigger reads each process's own clock,
so the ranks would fire different steps and wait in each other's joins; a
fleet across processes serves through ``SessionPool.step``.
"""

from __future__ import annotations

import asyncio
import copy
import time
from collections import Counter, defaultdict, deque

import numpy as np
import torch

from repro_torch.core.encoder import encoder_state
from repro_torch.core.engine import _host_symbols
from repro_torch.launch.faults import (
    CapacityError,
    DecodeError,
    DispatchError,
    FaultInjector,
    MeshLost,
    RetryPolicy,
    ShedError,
    StreamError,
    nonfinite_error,
)
from repro_torch.launch.journal import ChunkJournal, IntegritySentinel, check_journal_engine
from repro_torch.launch.serve_decoder import SessionPool
from repro_torch.launch.slab import SlabExhausted, SymbolSlab

__all__ = [
    "Backpressure",
    "DeadlineBatcher",
    "AsyncStream",
    "AsyncDecodeService",
    "run_poisson_trace",
]


def _host_bits(tensors: list[torch.Tensor]) -> list[np.ndarray]:
    """Int32 bit tensors → host int32 arrays through one device→host copy
    per device (one ``cat`` there, one transfer, split on the host). The
    copy waits for the launches that produced the bits."""
    out: list[np.ndarray | None] = [None] * len(tensors)
    by_device: dict[torch.device, list[int]] = defaultdict(list)
    for i, t in enumerate(tensors):
        by_device[t.device].append(i)
    for idx in by_device.values():
        flat = torch.cat([tensors[i] for i in idx]).cpu().numpy()
        cuts = np.cumsum([tensors[i].shape[0] for i in idx])[:-1]
        for i, a in zip(idx, np.split(flat, cuts)):
            out[i] = a
    return out


def _wait_for(bits: torch.Tensor) -> None:
    """Block until the launches that produced ``bits`` are done: a chunk's
    latency ends when its bits exist, not when the launch returns."""
    if bits.is_cuda:
        torch.cuda.current_stream(bits.device).synchronize()


class Backpressure(CapacityError):
    """Admission refused: the service is at capacity (non-blocking mode)."""


class DeadlineBatcher:
    """The deadline-or-batch-size dispatch trigger, as a pure clocked object.

    ``note_feed()`` marks the arrival of the oldest currently-undispatched
    chunk; ``due(pending_blocks)`` answers "fire now?"; ``fired()`` resets
    the deadline arm after a dispatch. All time comes from the injected
    ``clock``, so a fake clock makes every trigger decision deterministic.

    Fire iff at least one block is ready AND (ready blocks ≥
    ``max_batch_blocks`` OR the oldest undispatched chunk is ≥
    ``deadline_s`` old). A dispatch clears the arm; chunks that were
    buffered but did not complete a block re-arm it on their stream's next
    feed.
    """

    def __init__(
        self,
        max_batch_blocks: int,
        deadline_s: float,
        *,
        clock=time.monotonic,
    ):
        if max_batch_blocks < 1:
            raise ValueError(f"max_batch_blocks must be ≥ 1, got {max_batch_blocks}")
        if deadline_s < 0:
            raise ValueError(f"deadline_s must be ≥ 0, got {deadline_s}")
        self.max_batch_blocks = max_batch_blocks
        self.deadline_s = deadline_s
        self._clock = clock
        self._oldest: float | None = None

    def note_feed(self) -> None:
        if self._oldest is None:
            self._oldest = self._clock()

    def due(self, pending_blocks: int) -> bool:
        if pending_blocks <= 0:
            return False
        if pending_blocks >= self.max_batch_blocks:
            return True
        return (
            self._oldest is not None
            and self._clock() - self._oldest >= self.deadline_s
        )

    def timeout(self) -> float | None:
        """Seconds until the deadline would fire (None = nothing armed)."""
        if self._oldest is None:
            return None
        return max(0.0, self.deadline_s - (self._clock() - self._oldest))

    def fired(self) -> None:
        self._oldest = None


class AsyncStream:
    """One stream's handle on an :class:`AsyncDecodeService`.

    Wraps a pooled session; decoded bits (int32 tensors on the engine's
    device) are drained with :meth:`take` or folded into :meth:`finish`,
    the ``PooledSession`` contract. Tracks the admission time and
    buffered-stage watermark of every in-flight chunk for the service's
    latency accounting.
    """

    def __init__(self, service: "AsyncDecodeService", handle):
        self._service = service
        self._handle = handle
        self._inflight: deque[tuple[float, int]] = deque()  # (t_admit, watermark)
        self.finished = False
        self.failed: StreamError | None = None  # set when quarantined
        # ---- durability state ----
        self.sid = -1  # journal stream id (assigned by the service's open())
        self.chunks_admitted = 0  # admitted chunks ever (resume cursor)
        self.bits_taken = 0  # client-visible bits returned by take()/finish()
        self.acked_bits = 0  # durable client watermark (journal "ack" records)
        self._retained: list[torch.Tensor] = []  # taken-but-unacked (redeliverable)
        self._suppress = 0  # post-recovery bits the client already holds
        self._enc_state = 0  # encoder state after all delivered bits (sentinel)

    async def send(self, chunk) -> None:
        """Admit one chunk (numpy or a tensor on any device; backpressure-aware).

        Raises this stream's :class:`StreamError` if it was quarantined, the
        service-wide failure if the dispatcher died, :class:`Backpressure` /
        :class:`ShedError` when capacity admission gives up.
        """
        await self._service._admit(self, chunk)

    def take(self, *, ack: bool = True) -> torch.Tensor:
        """Drain every decoded bit delivered by dispatches so far.

        ``ack=True`` (default) also marks the bits as durably held by the
        client — the journal may forget them and recovery will not
        redeliver. A client that persists bits itself takes with
        ``ack=False``, persists, then calls :meth:`ack`: bits taken but
        unacked are retained service-side and redelivered after a crash.
        """
        if self.failed is not None:
            raise self.failed
        out = self._consume(self._handle.take())
        if ack:
            self.ack()
        elif out.shape[0]:
            self._retained.append(out)
        return out

    def ack(self) -> None:
        """Durably acknowledge every bit taken so far (journal watermark)."""
        self._retained.clear()
        if self.acked_bits != self.bits_taken:
            self.acked_bits = self.bits_taken
            self._service._journal_ack(self)

    def _consume(self, raw: torch.Tensor) -> torch.Tensor:
        """Client-position bookkeeping: swallow the post-recovery overlap
        (bits the client durably acked before the crash), then advance."""
        if self._suppress:
            cut = min(self._suppress, raw.shape[0])
            raw = raw[cut:]
            self._suppress -= cut
        self.bits_taken += raw.shape[0]
        return raw

    async def finish(self, n_bits: int | None = None) -> torch.Tensor:
        """Flush the stream and release its slab pages; returns undrained
        delivery plus the tail, totalling ``n_bits`` with prior takes."""
        return await self._service._finish(self, n_bits)

    @property
    def bits_emitted(self) -> int:
        return self._handle.bits_emitted

    # ---- service internals ---------------------------------------------------------
    def _note_admitted(self, t: float) -> None:
        s = self._handle._session
        self._inflight.append((t, s._base + len(s._store)))

    def _complete_upto(self, now: float) -> None:
        """Resolve chunks whose every buffered stage is now decoded."""
        s = self._handle._session
        done_stages = s._blocks_done * s.cfg.D
        lats = self._service._latencies_s
        while self._inflight and self._inflight[0][1] <= done_stages:
            t, _ = self._inflight.popleft()
            lats.append(now - t)

    def _drain_inflight(self, now: float) -> None:
        lats = self._service._latencies_s
        while self._inflight:
            t, _ = self._inflight.popleft()
            lats.append(now - t)


class AsyncDecodeService:
    """The asyncio front-end over a :class:`SessionPool` (module docstring).

    Parameters
    ----------
    max_batch_blocks: ready blocks that trigger an immediate dispatch.
    deadline_ms: max age of the oldest undispatched chunk before a dispatch
        fires anyway (the tail-latency knob).
    max_pending_blocks: admission cap on pool-wide ready-but-undecoded
        blocks (default ``4 × max_batch_blocks``); senders beyond it wait.
    slab: shared :class:`SymbolSlab` for paged session state (None = each
        session keeps the default per-session array store).
    clock: time source for the batcher, latency accounting, retry backoff
        and the shed deadline. With a fake clock, drive dispatch
        synchronously via :meth:`poll` — the background task's waits use
        real event-loop time.
    block_on_backpressure: False turns waiting senders into
        :class:`Backpressure` raises (admission-control mode).
    retry: :class:`~repro_torch.launch.faults.RetryPolicy` bounding dispatch
        retries; backoff is armed against ``clock`` (no real sleeping).
    shed_deadline_ms: a sender whose capacity wait (pending-block cap or
        slab pages) spans this long sheds with
        :class:`~repro_torch.launch.faults.ShedError` instead of parking
        forever. None (default) parks indefinitely.
    fault_injector: a :class:`~repro_torch.launch.faults.FaultInjector`
        consulted at the admission / slab / dispatch / mesh / open /
        decode_corrupt boundaries. None injects nothing.
    journal: a :class:`~repro_torch.launch.journal.ChunkJournal` making the
        service crash-safe: admitted chunks, delivered-bit acks and dispatch
        commits are write-ahead logged, and per-stream session state
        checkpoints every ``checkpoint_every`` dispatches. After a crash,
        :meth:`recover` rebuilds the service bit-exact. None serves
        ephemerally.
    checkpoint_every: dispatches between periodic checkpoints (with a
        journal); each checkpoint truncates the superseded log. 0/None
        disables periodic checkpoints (the journal alone still recovers).
    integrity_rate: probability that a delivered block span is screened by
        the re-encode integrity sentinel (0.0 = off; 1.0 = every delivery).
        A flagged stream quarantines with a typed
        :class:`~repro_torch.launch.faults.IntegrityError`.
    integrity_min_agreement: the sentinel's re-encode agreement bound.
    integrity_seed: seed for the sentinel's sampling rng.
    on_dispatch: optional callback ``on_dispatch(service)`` invoked after
        every completed dispatch (the crash-drill kill hook).
    """

    def __init__(
        self,
        *,
        max_batch_blocks: int = 32,
        deadline_ms: float = 5.0,
        max_pending_blocks: int | None = None,
        slab: SymbolSlab | None = None,
        clock=time.monotonic,
        block_on_backpressure: bool = True,
        retry: RetryPolicy | None = None,
        shed_deadline_ms: float | None = None,
        fault_injector: FaultInjector | None = None,
        journal: ChunkJournal | None = None,
        checkpoint_every: int | None = 16,
        integrity_rate: float = 0.0,
        integrity_min_agreement: float = 0.85,
        integrity_seed: int = 0,
        on_dispatch=None,
    ):
        self._pool = SessionPool()
        self._slab = slab
        self._clock = clock
        self._batcher = DeadlineBatcher(
            max_batch_blocks, deadline_ms / 1e3, clock=clock
        )
        self.max_pending_blocks = (
            max_pending_blocks if max_pending_blocks is not None else 4 * max_batch_blocks
        )
        if self.max_pending_blocks < 1:
            raise ValueError(
                f"max_pending_blocks must be ≥ 1, got {self.max_pending_blocks}"
            )
        self.block_on_backpressure = block_on_backpressure
        self.retry = retry if retry is not None else RetryPolicy()
        self.shed_deadline_ms = shed_deadline_ms
        self._injector = fault_injector
        if fault_injector is not None:
            self._pool.fault_hook = self._fault_hook
        self._streams: list[AsyncStream] = []
        self._by_handle: dict[object, AsyncStream] = {}
        self._poisoned: set = set()  # handles marked by the stream_poison site
        self._latencies_s: list[float] = []
        self._work = asyncio.Event()  # a chunk was admitted
        self._space = asyncio.Event()  # a dispatch freed capacity/pages
        self._task: asyncio.Task | None = None
        self._closing = False
        self.dispatches = 0
        self._t_first: float | None = None
        self._t_last: float | None = None
        self._bits_delivered = 0
        # ---- failure-model state ----
        self._failure: DecodeError | None = None  # service-fatal, surfaced everywhere
        self._retry_at: float | None = None  # clock time before which poll() waits
        self._attempts = 0  # consecutive failed dispatch attempts
        self._errors_by_class: Counter[str] = Counter()
        self.retries = 0
        self.shed_blocks = 0
        self.quarantined_streams = 0
        # ---- durability + integrity state ----
        self._journal = journal
        self.checkpoint_every = checkpoint_every
        self._sentinel = (
            IntegritySentinel(
                rate=integrity_rate,
                min_agreement=integrity_min_agreement,
                seed=integrity_seed,
            )
            if integrity_rate > 0.0
            else None
        )
        self.on_dispatch = on_dispatch
        self._by_sid: dict[int, AsyncStream] = {}
        self._next_sid = 0
        self._recovering = False  # replay in progress: suppress re-journaling
        self.checkpoints_written = 0
        self.recovered_streams: dict[int, AsyncStream] = {}

    # ---- lifecycle -----------------------------------------------------------------
    async def __aenter__(self) -> "AsyncDecodeService":
        self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    def start(self) -> None:
        """Start the background dispatcher task (idempotent; must be called
        from inside a running event loop — fake-clock tests skip it and
        drive :meth:`poll` directly)."""
        if self._task is None:
            self._task = asyncio.get_running_loop().create_task(self._run())

    async def aclose(self) -> None:
        """Stop dispatching; flush nothing (streams own their finish).

        If the dispatcher died with a service-fatal error, it re-raises here
        — a crashed service never closes silently.
        """
        self._closing = True
        self._space.set()  # wake blocked senders so they observe the close
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        if self._failure is not None:
            raise self._failure

    def open(self, engine) -> AsyncStream:
        """Admit a new stream; its session state pages out of the slab."""
        if self._failure is not None:
            raise self._failure
        if self._closing:
            raise RuntimeError("service is closing")
        self._check_engine(engine)
        store = self._slab.open_store() if self._slab is not None else None
        handle = self._pool.open(engine, store=store)
        stream = AsyncStream(self, handle)
        stream.sid = self._next_sid
        self._next_sid += 1
        self._streams.append(stream)
        self._by_handle[handle] = stream
        self._by_sid[stream.sid] = stream
        if self._journal is not None and not self._recovering:
            self._journal.append("open", stream.sid)
        if self._injector is not None and self._injector.fire("stream_poison"):
            # this stream's symbols will reproducibly kill any launch that
            # contains them (the bisection protocol isolates it)
            self._poisoned.add(handle)
        return stream

    def _check_engine(self, engine) -> None:
        """Refuse an engine whose mesh spans processes (module docstring)."""
        if self._journal is not None:
            check_journal_engine(engine)
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and mesh.spans_processes:
            raise ValueError(
                f"AsyncDecodeService: the engine's mesh spans {mesh.process_count} "
                f"processes; the deadline trigger reads each process's own wall clock, "
                f"so the ranks would dispatch different steps and wait in each other's "
                f"joins; drive such a fleet through SessionPool.step, which every rank "
                f"calls in the same order"
            )

    # ---- dispatch ------------------------------------------------------------------
    def poll(self) -> bool:
        """Fire one coalesced dispatch if the trigger is due; returns whether
        it fired. The background task calls this; fake-clock tests drive it
        directly for deterministic trigger sequences.

        A failed dispatch arms ``_retry_at`` (retry backoff on the injected
        clock); until the clock passes it no new dispatch fires, and once it
        does the retry fires regardless of the batcher — the pending blocks
        that triggered the original dispatch are still there.
        """
        if self._failure is not None:
            return False
        if self._retry_at is not None:
            if self._clock() < self._retry_at:
                return False
            self._retry_at = None
            self._dispatch()
            return True
        if not self._batcher.due(self._pool.pending_blocks()):
            return False
        self._dispatch()
        return True

    def _dispatch(self) -> None:
        """One coalesced step under the failure model.

        Success resets the retry state. A transient failure arms a bounded
        exponential-backoff retry; retries exhausted (or a typed
        :class:`StreamError`) escalate to the pool's bisection protocol,
        which quarantines culprit streams while the rest deliver bit-exact.
        :class:`MeshLost` rebuilds the fleet's meshed engines on a smaller
        mesh (or meshless) and replays the ready blocks on the next poll. An
        exception escaping even the isolation step is service-fatal and
        propagates (the background task turns it into ``_fail_service``).
        """
        self.dispatches += 1
        self._batcher.fired()
        checks = (
            self._sentinel_capture()
            if self._sentinel is not None and not self._recovering
            else []
        )
        before = {id(st): st._handle.bits_emitted for st in self._streams}
        qmarks = {id(st): len(st._handle._queue) for st in self._streams}
        try:
            self._pool.step()
        except MeshLost as exc:
            # meshed engines are rebuilt on the survivors; the retried
            # dispatch replays the ready blocks from session state
            self._count_error(exc)
            self._handle_mesh_loss(exc)
            self.retries += 1
            self._retry_at = self._clock()  # replay on the next poll
            return
        except StreamError as exc:
            # a typed per-stream fault: retrying the same batch would fail
            # the same way, so go straight to isolation
            self._count_error(exc)
            self._pool.step(isolate=True)
            self._attempts = 0
        except Exception as exc:  # noqa: BLE001 - classify, don't mask
            self._count_error(exc)
            if self._attempts < self.retry.max_retries:
                self._attempts += 1
                self.retries += 1
                self._retry_at = self._clock() + self.retry.delay_s(self._attempts - 1)
                return
            # retries exhausted: a deterministic fault — bisect it out; if
            # even single-member launches fail, every member quarantines and
            # the pool drains rather than wedging the service
            self._attempts = 0
            self._pool.step(isolate=True)
        else:
            self._attempts = 0
        self._retry_at = None
        # ---- end-to-end integrity pipeline: the decode_corrupt fault site
        # mutates freshly delivered bits, the sentinel screens them against
        # the pre-step soft symbols, and the per-stream encoder state folds
        # forward over whatever was (really) delivered
        new_bits = self._collect_new_bits(qmarks)
        checkpoint = (
            self._journal is not None
            and not self._recovering
            and bool(self.checkpoint_every)
            and self.dispatches % self.checkpoint_every == 0
        )
        queues = self._host_queues() if checkpoint else None
        host_new = self._host_new_bits(new_bits, qmarks, {id(st) for st, *_ in checks}, queues)
        now = self._clock()  # after the copy: the dispatch's bits exist
        delivered = sum(
            st._handle.bits_emitted - before[id(st)]
            for st in self._streams
            if id(st) in before
        )
        if delivered:
            self._bits_delivered += delivered
            self._t_last = now
        for st, window, code, state0 in checks:
            bits = host_new.get(id(st))
            if st.failed is not None or bits is None:
                continue
            err = self._sentinel.check(bits, window, code, state0, stream=st._handle)
            if err is not None:
                self._count_error(err)
                self._fail_stream(st, err)
        for st in self._streams:
            bits = host_new.get(id(st))
            if bits is not None and len(bits):
                st._enc_state = encoder_state(
                    bits, st._handle._session.spec.code, st._enc_state
                )
        for stream in self._streams:
            stream._complete_upto(now)
        for ps, err in self._pool.drain_quarantined():
            st = self._by_handle.get(ps)
            if st is not None:
                self._fail_stream(st, err)
        if self._journal is not None and not self._recovering:
            self._journal.append("commit", self.dispatches)
            if checkpoint:
                self._checkpoint(queues)
        self._space.set()  # decoded blocks dropped pages + pending count
        if self.on_dispatch is not None and not self._recovering:
            self.on_dispatch(self)

    async def _run(self) -> None:
        try:
            while True:
                self._work.clear()
                timeout = self._next_timeout()
                if timeout is None:
                    await self._work.wait()
                else:
                    try:
                        await asyncio.wait_for(self._work.wait(), timeout)
                    except asyncio.TimeoutError:
                        pass
                self.poll()
                # yield so delivery consumers run between dispatches
                await asyncio.sleep(0)
        except Exception as exc:  # noqa: BLE001 - the stranded-waiter fix
            # the dispatcher must never die silently: senders parked in
            # _wait_for_space and finishers would hang forever. Record the
            # failure, wake every waiter (they re-check and raise), and let
            # aclose() re-raise it to the caller.
            self._fail_service(exc)

    def _next_timeout(self) -> float | None:
        """Sleep bound for the dispatcher: deadline arm and/or retry backoff."""
        t = self._batcher.timeout() if self._pool.pending_blocks() > 0 else None
        if self._retry_at is not None:
            r = max(0.0, self._retry_at - self._clock())
            t = r if t is None else min(t, r)
        return t

    # ---- failure handling ----------------------------------------------------------
    def _count_error(self, exc: BaseException) -> None:
        self._errors_by_class[type(exc).__name__] += 1

    def _fault_hook(self, entries, isolating: bool) -> None:
        """The pool's pre-launch injection point (``FaultInjector`` wiring).

        Transient dispatch/mesh faults are suppressed while the pool is
        bisecting — they model launch-level weather, and firing them
        mid-isolation would quarantine innocent streams. Poisoned-stream
        faults fire always: they model symbols that reproducibly kill any
        launch containing them, which is exactly what bisection isolates.
        """
        inj = self._injector
        if inj is None:
            return
        if not isolating:
            if inj.fire("mesh"):
                raise MeshLost(
                    "injected: device loss during dispatch",
                    lost_chips=inj.mesh_lost_chips,
                )
            if inj.fire("dispatch"):
                raise DispatchError("injected: transient launch failure")
        for ps, _ in entries:
            if ps in self._poisoned:
                raise StreamError(
                    "injected: poisoned stream symbols in the coalesced batch",
                    stream=ps,
                )

    def _handle_mesh_loss(self, exc: MeshLost) -> None:
        """Rebuild every meshed engine in the fleet on a post-loss mesh.

        Uses :func:`repro_torch.launch.elastic.rescale_decode_engine`: shrink
        the engine's ``block_axes``, or drop to meshless dispatch when
        nothing useful survives. Sessions are repointed in place; their
        ready-but-undecoded blocks replay on the retried dispatch, bit-exact
        to the uninterrupted run (the mesh only places independent lanes).
        Meshless engines are left as they are.
        """
        from repro_torch.launch.elastic import rescale_decode_engine

        engines, seen = [], set()
        for st in self._streams:
            eng = st._handle._session.engine
            if eng.mesh is not None and id(eng) not in seen:
                seen.add(id(eng))
                engines.append(eng)
        for eng in engines:
            self._pool.repoint_engine(eng, rescale_decode_engine(eng, exc.lost_chips))

    def _fail_stream(self, stream: AsyncStream, err: StreamError) -> None:
        """Quarantine one stream: typed failure to its waiters, pages freed.

        Idempotent. The slab pages are released (and zeroed, per the slab
        contract) so capacity poisoned streams held flows back to healthy
        admissions — hence the final ``_space.set()``.
        """
        if stream.failed is not None:
            return
        stream.failed = err
        stream.finished = True
        stream._inflight.clear()  # failed chunks are not latency samples
        self._pool.close(stream._handle)
        self._poisoned.discard(stream._handle)
        stream._handle._session.close()  # slab pages → free-list (zeroed)
        if stream in self._streams:
            self._streams.remove(stream)
        self._by_handle.pop(stream._handle, None)
        self._by_sid.pop(stream.sid, None)
        self.quarantined_streams += 1
        if self._journal is not None and not self._recovering:
            # replay drops the stream instead of re-feeding a known-bad one
            self._journal.append("fail", stream.sid, str(err))
        self._space.set()  # freed pages may unblock parked senders

    def _fail_service(self, exc: BaseException) -> None:
        """Mark the whole service failed; every waiter observes it."""
        if self._failure is not None:
            return
        if isinstance(exc, DecodeError):
            err = exc
        else:
            err = DispatchError(f"decode service dispatcher died: {exc!r}")
            err.__cause__ = exc
        self._failure = err
        self._count_error(err)
        self._space.set()  # parked senders wake → _check_live raises
        self._work.set()

    # ---- durability + integrity ----------------------------------------------------
    def _journal_ack(self, stream: AsyncStream) -> None:
        if self._journal is not None and not self._recovering:
            self._journal.append("ack", stream.sid, stream.acked_bits)

    def _host_queues(self) -> dict[int, list[np.ndarray]]:
        """Every live stream's UNACKED delivery — taken-but-unacked, then
        queued — as host int32 arrays, through one device→host copy."""
        entries = [
            (id(st), t) for st in self._streams for t in (*st._retained, *st._handle._queue)
        ]
        out: dict[int, list[np.ndarray]] = {id(st): [] for st in self._streams}
        for (key, _), a in zip(entries, _host_bits([t for _, t in entries])):
            out[key].append(a)
        return out

    def _host_new_bits(
        self,
        new_bits: dict[int, torch.Tensor],
        qmarks: dict,
        checked: set[int],
        queues: dict[int, list[np.ndarray]] | None,
    ) -> dict[int, np.ndarray]:
        """The host's view of this dispatch's deliveries: the whole span of
        each stream the sentinel screens, the last ``v`` bits (all the
        encoder state depends on) of every other. With ``queues`` (a
        checkpoint's copy, which already holds every undrained bit) nothing
        more crosses; otherwise one gathered copy does."""
        out = {}
        if queues is not None:
            for st in self._streams:
                if id(st) in new_bits:
                    skip = len(st._retained) + qmarks[id(st)]
                    out[id(st)] = np.concatenate(queues[id(st)][skip:])
            return out
        keys, wanted = [], []
        for st in self._streams:
            bits = new_bits.get(id(st))
            if bits is None:
                continue
            keys.append(id(st))
            v = st._handle._session.spec.code.v
            wanted.append(bits if id(st) in checked else bits[-v:])
        return dict(zip(keys, _host_bits(wanted)))

    def _checkpoint(self, queues: dict[int, list[np.ndarray]] | None = None) -> None:
        """Atomically persist every live stream's session state + the
        unacked delivery tail (host numpy, the reference's format);
        truncates the superseded journal log. ``queues`` is a
        :meth:`_host_queues` copy already made by the caller."""
        if self._journal is None:
            return
        if queues is None:
            queues = self._host_queues()
        streams = {}
        for st in self._streams:
            s = st._handle._session
            streams[st.sid] = dict(
                session=s.snapshot(),
                # the UNACKED tail: taken-but-unacked bits rejoin the queue
                # so recovery redelivers everything past the ack watermark
                queue=queues[id(st)],
                handle_bits=st._handle.bits_emitted,
                acked=st.acked_bits,
                enc_state=st._enc_state,
                chunks_admitted=st.chunks_admitted,
            )
        self._journal.write_checkpoint(
            dict(dispatches=self.dispatches, streams=streams)
        )
        self.checkpoints_written += 1

    def _sentinel_capture(self) -> list[tuple]:
        """Pre-step capture for the re-encode sentinel: each sampled
        stream's about-to-decode soft-symbol span (the commit will drop it
        from the store) plus its encoder state at the span's first stage."""
        checks = []
        for st in self._streams:
            s = st._handle._session
            b1 = s.ready_blocks()
            if b1 <= s._blocks_done or not self._sentinel.sample():
                continue
            D = s.cfg.D
            lo = s._blocks_done * D - s._base  # = min(blocks_done·D, L) ≥ 0
            window = np.array(
                s._store.read(lo, (b1 - s._blocks_done) * D), np.float32
            )
            checks.append((st, window, s.spec.code, st._enc_state))
        return checks

    def _collect_new_bits(self, qmarks: dict) -> dict[int, torch.Tensor]:
        """Bits THIS dispatch delivered per stream (delivery-queue growth
        past the pre-step mark), with the ``decode_corrupt`` fault site
        applied — silent corruption strikes after the kernel."""
        out = {}
        for st in list(self._streams):
            k = qmarks.get(id(st))
            if k is None:
                continue
            new = st._handle._queue[k:]
            if not new:
                continue
            if self._injector is not None and self._injector.fire("decode_corrupt"):
                # one delivered payload bit flips, silently, in the QUEUE
                # itself (the client takes the corrupt bit; only the
                # sentinel can notice), via a copy of the device tensor
                first = new[0].clone()
                first[:1] ^= 1
                new[0] = st._handle._queue[k] = first
            out[id(st)] = torch.cat(new) if len(new) > 1 else new[0]
        return out

    @classmethod
    def recover(
        cls,
        journal: ChunkJournal,
        engine,
        **service_kwargs,
    ) -> "AsyncDecodeService":
        """Rebuild a service from ``journal`` after a crash.

        Restores every checkpointed stream's session into fresh (slab)
        stores, then replays the unapplied journal records in admission
        order — re-feeding unacked chunks, re-applying ack watermarks, and
        dropping finished/quarantined streams. Block independence makes
        the continuation bit-exact: recovered streams deliver exactly the
        bits past each client's ack watermark that the uninterrupted run
        would have delivered. The journal may have been written by either
        package.

        ``engine`` is the decode engine for every recovered stream (engines
        are not serializable; a restarted process rebuilds them the same way
        it did originally). Recovered streams are exposed in
        :attr:`recovered_streams` keyed by their stable ``sid`` — assigned in
        ``open()`` order. Ends with a fresh checkpoint, so a crash during a
        long replay never compounds.
        """
        svc = cls(journal=journal, **service_kwargs)
        svc._check_engine(engine)
        svc._recovering = True
        try:
            ckpt, records = journal.load()
            if ckpt is not None:
                svc.dispatches = int(ckpt.get("dispatches", 0))
                for sid in sorted(ckpt["streams"]):
                    svc._restore_stream(int(sid), engine, ckpt["streams"][sid])
            for rec in records:
                svc._replay(rec, engine)
        finally:
            svc._recovering = False
        svc.recovered_streams = dict(svc._by_sid)
        svc._checkpoint()  # collapse the replay: a re-crash replays nothing
        if svc._pool.pending_blocks() > 0:
            svc._batcher.note_feed()  # replayed blocks are ready: arm dispatch
            svc._work.set()
        return svc

    def _restore_stream(self, sid: int, engine, snap: dict) -> AsyncStream:
        store = self._slab.open_store() if self._slab is not None else None
        handle = self._pool.open(engine, store=store)
        handle._session.restore(snap["session"])
        handle._queue.extend(
            torch.from_numpy(np.asarray(a, np.int32)).to(engine.device) for a in snap["queue"]
        )
        handle.bits_emitted = int(snap["handle_bits"])
        stream = AsyncStream(self, handle)
        stream.sid = sid
        # the client's position restarts at the checkpoint's ack watermark;
        # replayed ack records past it turn into suppression below
        stream.bits_taken = stream.acked_bits = int(snap["acked"])
        stream._enc_state = int(snap["enc_state"])
        stream.chunks_admitted = int(snap["chunks_admitted"])
        self._streams.append(stream)
        self._by_handle[handle] = stream
        self._by_sid[sid] = stream
        self._next_sid = max(self._next_sid, sid + 1)
        return stream

    def _replay(self, rec: tuple, engine) -> None:
        """Apply one journal record during :meth:`recover`."""
        _seq, kind, *fields = rec
        if kind == "open":
            (sid,) = fields
            if sid in self._by_sid:
                return
            self._next_sid = max(self._next_sid, int(sid))
            st = self.open(engine)
            if st.sid != sid:
                raise RuntimeError(f"replayed open sid {sid} != assigned {st.sid}")
        elif kind == "admit":
            sid, chunk = fields
            st = self._by_sid.get(sid)
            if st is None or st.failed is not None or st.finished:
                return
            self._feed_replay(st, np.asarray(chunk))
        elif kind == "ack":
            sid, acked = fields
            st = self._by_sid.get(sid)
            if st is None:
                return
            gap = int(acked) - st.acked_bits
            if gap > 0:
                # the client durably holds these bits: swallow them instead
                # of redelivering (the no-duplicate-delivery invariant)
                st._suppress += gap
                st.acked_bits = st.bits_taken = int(acked)
        elif kind == "finish":
            (sid,) = fields
            st = self._by_sid.pop(sid, None)
            if st is None:
                return
            st.finished = True
            self._pool.close(st._handle)
            st._handle._session.close()
            if st in self._streams:
                self._streams.remove(st)
            self._by_handle.pop(st._handle, None)
        elif kind == "fail":
            sid, msg = fields
            st = self._by_sid.get(sid)
            if st is not None:
                self._fail_stream(st, StreamError(f"recovered quarantine: {msg}"))
        elif kind == "commit":
            (dispatches,) = fields
            self.dispatches = max(self.dispatches, int(dispatches))
        # unknown kinds are skipped: an older journal replays under a newer
        # service as long as the kinds it DID write still mean the same

    def _feed_replay(self, st: AsyncStream, chunk: np.ndarray) -> None:
        """Re-feed a journaled chunk, retiring slab pages via a dispatch on
        exhaustion exactly like live backpressure would have."""
        try:
            try:
                st._handle.feed(chunk)
            except SlabExhausted:
                if self._pool.pending_blocks() <= 0:
                    raise
                self._dispatch()  # frees committed pages, as a live wait would
                st._handle.feed(chunk)
        except StreamError as err:
            # deterministically bad symbols fail on replay exactly as they
            # did live: quarantine and move on
            self._count_error(err)
            self._fail_stream(st, err)
            return
        st.chunks_admitted += 1
        self._batcher.note_feed()

    # ---- admission -----------------------------------------------------------------
    def _check_live(self, stream: AsyncStream) -> None:
        """Raise the most specific standing failure before touching state."""
        if stream.failed is not None:
            raise stream.failed
        if self._failure is not None:
            raise self._failure
        if self._closing:
            raise RuntimeError("service is closing")

    async def _admit(self, stream: AsyncStream, chunk) -> None:
        if stream.finished and stream.failed is None:
            raise ValueError("send() on a finished stream")
        self._check_live(stream)
        # one host copy serves the session's buffer and the journal record
        chunk = _host_symbols(chunk)
        if self._injector is not None and self._injector.fire("admission"):
            err = nonfinite_error("send() [injected]", 1, int(chunk.size) or 1)
            self._count_error(err)
            self._fail_stream(stream, err)
            raise err
        t0 = self._clock()  # the shed deadline spans the WHOLE admission
        while True:
            self._check_live(stream)
            if self._pool.pending_blocks() >= self.max_pending_blocks:
                await self._wait_for_space("pending-block cap", t0)
                continue
            try:
                if self._injector is not None and self._injector.fire("slab"):
                    exc = SlabExhausted("injected: slab pages exhausted")
                    exc.injected = True
                    raise exc
                # session ingest is atomic w.r.t. slab exhaustion: page
                # capacity is reserved before any symbol is written, so a
                # failed admit can simply retry after the next dispatch
                stream._handle.feed(chunk)
            except SlabExhausted as exc:
                self._count_error(exc)
                if self._pool.pending_blocks() <= 0:
                    if getattr(exc, "injected", False):
                        continue  # synthetic fault, nothing to free: re-admit
                    # nothing a dispatch could free — the chunk cannot fit
                    raise
                await self._wait_for_space("slab pages", t0)
                continue
            except StreamError as err:
                # engine-boundary validation (non-finite or shape-invalid
                # symbols): per-stream poison — quarantine it, nobody else
                # is touched and the rejected chunk never entered the buffer
                self._count_error(err)
                self._fail_stream(stream, err)
                raise
            break
        # WAL the admitted chunk BEFORE admission completes (before the
        # chunk becomes dispatchable). Logging after the feed keeps shed/
        # quarantined admissions out of the journal; a crash in the gap
        # just loses an unconfirmed send() — the client's resume cursor
        # (chunks_admitted, derived from this record) re-sends it.
        if self._journal is not None and not self._recovering:
            try:
                self._journal.append("admit", stream.sid, chunk)
            except OSError as exc:  # durability broken → the service is dead
                self._fail_service(exc)
                raise self._failure from exc
        stream.chunks_admitted += 1
        now = self._clock()
        if self._t_first is None:
            self._t_first = now
        stream._note_admitted(now)
        self._batcher.note_feed()
        self._work.set()

    async def _wait_for_space(self, why: str, t0: float) -> None:
        if not self.block_on_backpressure:
            exc = Backpressure(f"admission refused: {why} exhausted")
            self._count_error(exc)
            raise exc
        if (
            self.shed_deadline_ms is not None
            and (self._clock() - t0) * 1e3 >= self.shed_deadline_ms
        ):
            exc = ShedError(
                f"admission shed: {why} still exhausted after "
                f"{self.shed_deadline_ms} ms"
            )
            self._count_error(exc)
            self.shed_blocks += 1
            raise exc
        self._space.clear()
        self._work.set()  # ensure the dispatcher wakes to make progress
        if self.shed_deadline_ms is None:
            await self._space.wait()
            return
        # real-time backstop so a stalled dispatcher cannot outlive the shed
        # deadline; the deterministic check above (injected clock) decides
        remaining = self.shed_deadline_ms / 1e3 - (self._clock() - t0)
        try:
            await asyncio.wait_for(self._space.wait(), max(0.0, remaining))
        except asyncio.TimeoutError:
            pass

    async def _finish(self, stream: AsyncStream, n_bits: int | None) -> torch.Tensor:
        self._check_live(stream)
        if stream.finished:
            raise ValueError("finish() called twice on one stream")
        before = stream._handle.bits_emitted
        cap = None
        if self._sentinel is not None and not self._recovering:
            s = stream._handle._session
            nb, _n_blocks, prior = s._finish_plan(n_bits)
            if nb > prior and self._sentinel.sample():
                # flush-tail capture: the store may be short of the padded
                # window — check() treats missing stages as excluded zeros
                cap = (
                    np.array(s._store.read(prior - s._base, nb - prior), np.float32),
                    s.spec.code,
                    stream._enc_state,
                )
        attempt = 0
        while True:
            try:
                bits = stream._handle.finish(n_bits)  # take() fold + flush plan
                break
            except StreamError as err:
                # the stream's own flush launch is what fails: quarantine it
                self._count_error(err)
                self._fail_stream(stream, err)
                raise err from None
            except CapacityError:
                raise  # a flush never allocates; surface allocator bugs loudly
            except MeshLost as exc:
                self._count_error(exc)
                self._handle_mesh_loss(exc)
                self.retries += 1
                continue  # the flush replays on the rebuilt engine, bit-exact
            except Exception as exc:  # noqa: BLE001 - transient flush failure
                self._count_error(exc)
                if attempt >= self.retry.max_retries:
                    err = StreamError(
                        f"stream flush failed after {attempt} retries ({exc!r})"
                    )
                    err.__cause__ = exc
                    self._fail_stream(stream, err)
                    raise err from exc
                await asyncio.sleep(self.retry.delay_s(attempt))
                attempt += 1
                self.retries += 1
        if cap is not None:
            tail_len = stream._handle.bits_emitted - before
            tail = bits[bits.shape[0] - tail_len :]
            err = self._sentinel.check(
                tail.cpu().numpy(), cap[0], cap[1], cap[2], stream=stream._handle
            )
            if err is not None:
                self._count_error(err)
                self._fail_stream(stream, err)
                raise err
        bits = stream._consume(bits)
        stream._retained.clear()
        if stream.acked_bits != stream.bits_taken:
            # finish() is the terminal hand-off: returning implies delivery
            stream.acked_bits = stream.bits_taken
            self._journal_ack(stream)
        if self._journal is not None and not self._recovering:
            self._journal.append("finish", stream.sid)
        _wait_for(bits)
        now = self._clock()
        self._bits_delivered += stream._handle.bits_emitted - before
        self._t_last = now
        stream._drain_inflight(now)
        stream.finished = True
        self._pool.close(stream._handle)  # idempotent pool exit
        stream._handle._session.close()  # slab pages → free-list
        self._streams.remove(stream)  # keep the live list O(live streams)
        self._by_handle.pop(stream._handle, None)
        self._by_sid.pop(stream.sid, None)
        self._space.set()  # freed pages may unblock waiting senders
        if self._journal is not None and not self._recovering and not self._streams:
            self._checkpoint()  # everything delivered + acked: log truncates
        return bits

    # ---- accounting ----------------------------------------------------------------
    def metrics(self) -> dict:
        """Chunk-latency percentiles + sustained throughput so far.

        ``p50_ms``/``p99_ms`` are None until there are latency samples; with
        fewer than ~20 samples the p99 is the interpolated max and should be
        read as such. Every dict in the snapshot is a deep copy.
        """
        lat = np.asarray(self._latencies_s, np.float64)
        span = (
            self._t_last - self._t_first
            if self._t_first is not None and self._t_last is not None
            else 0.0
        )
        return dict(
            chunks=int(lat.size),
            dispatches=self.dispatches,
            launches=self._pool.launches,
            bits_delivered=self._bits_delivered,
            span_s=span,
            sustained_mbps=(
                self._bits_delivered / span / 1e6 if span > 0 else None
            ),
            p50_ms=float(np.percentile(lat, 50) * 1e3) if lat.size else None,
            p99_ms=float(np.percentile(lat, 99) * 1e3) if lat.size else None,
            slab_pages_high_water=(
                self._slab.high_water if self._slab is not None else None
            ),
            # failure-model observability — deep-copied: callers mutating
            # the snapshot must never reach live counters
            errors_by_class=copy.deepcopy(dict(self._errors_by_class)),
            faults_injected=(
                copy.deepcopy(dict(self._injector.fired))
                if self._injector is not None
                else {}
            ),
            retries=self.retries,
            shed_blocks=self.shed_blocks,
            quarantined_streams=self.quarantined_streams,
            # durability + integrity observability
            checkpoints=self.checkpoints_written,
            journal_seq=(self._journal.seq if self._journal is not None else None),
            integrity_checked=(
                self._sentinel.checked if self._sentinel is not None else 0
            ),
            integrity_flagged=(
                self._sentinel.flagged if self._sentinel is not None else 0
            ),
        )


async def run_poisson_trace(
    engine,
    ys,
    n_bits_list,
    *,
    chunk_symbols: int,
    rate_chunks_per_s: float,
    seed: int = 0,
    service_kwargs: dict | None = None,
    slab: SymbolSlab | None = None,
    fault_injector: FaultInjector | None = None,
) -> tuple[list, dict]:
    """Drive ``len(ys)`` concurrent streams through the service under a
    Poisson arrival process and return (per-stream results, service metrics).

    Each stream ``i`` sends ``ys[i]`` (numpy or a tensor) in
    ``chunk_symbols``-sized chunks with i.i.d. exponential inter-arrival
    gaps at ``rate_chunks_per_s`` (independent per stream; the aggregate
    arrival process is their superposition). Chunk CONTENT is independent
    of timing, so the decoded bits (an int32 tensor on the engine's device
    per stream) are bit-exact to per-stream one-shot ``engine.decode`` no
    matter how the trace interleaves.

    A stream that the injector (or real validation) kills returns its typed
    :class:`DecodeError` in the results list instead of bits; healthy
    streams are unaffected.
    """
    service_kwargs = dict(service_kwargs or {})
    if fault_injector is not None:
        service_kwargs.setdefault("fault_injector", fault_injector)
    async with AsyncDecodeService(slab=slab, **service_kwargs) as svc:

        async def one(i: int):
            stream = svc.open(engine)
            y = ys[i] if isinstance(ys[i], torch.Tensor) else np.asarray(ys[i])
            # independent per-stream rng: the trace is reproducible no matter
            # how the event loop interleaves the stream tasks
            rng = np.random.default_rng(seed + 7919 * i)
            gaps = rng.exponential(1.0 / rate_chunks_per_s, -(-len(y) // chunk_symbols))
            outs = []
            try:
                for j, lo in enumerate(range(0, len(y), chunk_symbols)):
                    await asyncio.sleep(float(gaps[j]))
                    await stream.send(y[lo : lo + chunk_symbols])
                    outs.append(stream.take())
                outs.append(await stream.finish(n_bits_list[i]))
            except DecodeError as exc:
                # typed per-stream failure: report it as this stream's result
                # (quarantine already released its pages); service-fatal
                # failures resurface from aclose() instead
                return exc
            return torch.cat(outs)

        bits = await asyncio.gather(*[one(i) for i in range(len(ys))])
        report = svc.metrics()
    return list(bits), report
