"""The port's async decode service against the reference's, on the CPU.

Port engines (``device="cpu"``, ``backend="ref"``, D = 64, L = 16) and the
JAX ``backend="ref"`` engines are fed the same numpy streams, made from a
seed. Both services are driven by one fake clock where timing matters: the
dispatch instants (which ``poll()`` fires) and the ``metrics()`` counters
must be equal, and every delivered bit equal to the JAX one-shot decode.
Then the port alone: the deadline-or-size trigger, backpressure in both
modes, the 64-stream Poisson trace bit-exact, and tensor chunks. Mirrors
``tests/test_serve_async.py``.

The helpers here are shared by ``test_torch_faults.py``, ``test_torch_slab.py``
and ``test_torch_journal.py``.
"""

import asyncio
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.engine import DecoderEngine as JEngine
from repro.core.pbvd import PBVDConfig as JConfig
from repro.launch import faults as j_faults
from repro.launch import serve_async as j_serve_async
from repro.launch import slab as j_slab
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.encoder import encode_np, terminate
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.launch import faults, serve_async, slab
from repro_torch.launch.serve_async import (
    AsyncDecodeService,
    Backpressure,
    DeadlineBatcher,
    run_poisson_trace,
)
from repro_torch.launch.serve_decoder import _latency_summary
from repro_torch.launch.slab import SlabExhausted, SymbolSlab

GEO = dict(D=64, L=16, q=8)
T_PAGE = GEO["D"] + 2 * GEO["L"]
N_BITS = 256  # the shared stream length: the JAX reference compiles once per spec

# the two packages side by side: (faults, serve_async, slab)
PORT = "port"
REF = "ref"
MODS = {
    PORT: (faults, serve_async, slab),
    REF: (j_faults, j_serve_async, j_slab),
}


def stream(name: str, n_bits: int, seed: int, ebn0: float = 4.5) -> np.ndarray:
    """BPSK of the terminated, encoded payload plus AWGN at ``ebn0`` dB, in
    the spec's wire format (1-D for punctured specs), float32."""
    spec = get_code_spec(name)
    rng = np.random.default_rng(seed)
    coded = encode_np(terminate(rng.integers(0, 2, n_bits), spec.code), spec.code)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    sigma = np.sqrt(1.0 / (2.0 * spec.rate * 10.0 ** (ebn0 / 10.0)))
    return (1.0 - 2.0 * tx + rng.normal(scale=sigma, size=tx.shape)).astype(np.float32)


def engine(name: str = "ccsds", **knobs) -> DecoderEngine:
    return DecoderEngine(
        PBVDConfig(spec=get_code_spec(name), backend="ref", **{**GEO, **knobs}), device="cpu"
    )


@functools.lru_cache(maxsize=None)
def jengine(name: str = "ccsds", metric_mode: str = "f32") -> JEngine:
    return JEngine(JConfig(spec=j_get_code_spec(name), backend="ref", metric_mode=metric_mode,
                           **GEO))


def engine_of(side: str, name: str = "ccsds", **knobs):
    return engine(name, **knobs) if side == PORT else jengine(name, **knobs)


def want(ys, n_bits: int = N_BITS, name: str = "ccsds", **knobs) -> list[np.ndarray]:
    """The JAX reference's one-shot decode of each stream (one batched call)."""
    out = jengine(name, **knobs).decode_batch([jnp.asarray(y) for y in ys], [n_bits] * len(ys))
    return [np.asarray(b) for b in out]


def bits_of(x) -> np.ndarray:
    """Delivered bits of either package as an int64 numpy array."""
    if isinstance(x, torch.Tensor):
        assert x.dtype == torch.int32
        x = x.numpy()
    return np.asarray(x).astype(np.int64)


def chunks_of(y: np.ndarray, n_chunks: int) -> list[np.ndarray]:
    bounds = np.linspace(0, len(y), n_chunks + 1).astype(int)
    return [y[lo:hi] for lo, hi in zip(bounds[:-1], bounds[1:])]


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


COUNTERS = ("chunks", "dispatches", "launches", "bits_delivered", "retries", "shed_blocks",
            "quarantined_streams", "errors_by_class", "faults_injected", "checkpoints",
            "journal_seq", "integrity_checked", "integrity_flagged", "slab_pages_high_water",
            "p50_ms", "p99_ms", "span_s")


# ---------------------------------------------------------------------------
# One fake clock, two services: the same dispatch instants and counters
# ---------------------------------------------------------------------------
def _lockstep(side: str, ys, *, schedule: dict, n_chunks: int, integrity: float,
              service_kw: dict):
    """Feed ``ys`` round by round (every stream one chunk per round) and poll
    three times per round with the clock advancing 4 ms between polls.
    Returns the (clock, fired) trace, the metrics and each stream's bits or
    failure class name."""
    f_mod, s_mod, sl_mod = MODS[side]
    clk = FakeClock()
    eng = engine_of(side)
    chunk_lists = [chunks_of(y, n_chunks) for y in ys]

    async def scenario():
        svc = s_mod.AsyncDecodeService(
            clock=clk.now,
            slab=sl_mod.SymbolSlab(n_pages=8 * len(ys), page_stages=T_PAGE, R=2),
            fault_injector=f_mod.FaultInjector(seed=3, schedule=schedule),
            retry=f_mod.RetryPolicy(max_retries=2, backoff_s=0.004, multiplier=2.0),
            integrity_rate=integrity,
            integrity_min_agreement=0.95,
            **service_kw,
        )
        streams = [svc.open(eng) for _ in ys]
        trace, outs = [], [[] for _ in ys]
        for k in range(n_chunks):
            for i, st in enumerate(streams):
                if st.failed is None:
                    try:
                        await st.send(chunk_lists[i][k])
                    except f_mod.DecodeError:
                        pass
            for _ in range(3):
                trace.append((round(clk.now(), 9), svc.poll()))
                clk.advance(0.004)
            for i, st in enumerate(streams):
                if st.failed is None:
                    outs[i].append(bits_of(st.take()))
        results = []
        for i, st in enumerate(streams):
            try:
                outs[i].append(bits_of(await st.finish(N_BITS)))
                results.append(np.concatenate(outs[i]))
            except f_mod.DecodeError as exc:
                results.append(type(exc).__name__)
            clk.advance(0.001)
        return trace, svc.metrics(), results

    return asyncio.run(scenario())


LOCKSTEP_CASES = {
    "clean": (dict(), 0.0, 4.5, dict(max_batch_blocks=6, deadline_ms=10.0)),
    "retries": (dict(dispatch={0, 1, 4}), 0.0, 4.5, dict(max_batch_blocks=6, deadline_ms=10.0)),
    "mesh and poison": (dict(mesh={1}, stream_poison={2}, slab={3}, admission={9}), 0.0, 4.5,
                        dict(max_batch_blocks=4, deadline_ms=0.0)),
    "corrupt": (dict(decode_corrupt={2}, dispatch={3}), 1.0, 9.0,
                dict(max_batch_blocks=1000, deadline_ms=6.0)),
}


@pytest.mark.parametrize("case", list(LOCKSTEP_CASES))
def test_same_dispatch_instants_and_counters_as_the_reference(case):
    schedule, integrity, ebn0, service_kw = LOCKSTEP_CASES[case]
    ys = [stream("ccsds", N_BITS, 300 + i, ebn0) for i in range(4)]
    runs = {side: _lockstep(side, ys, schedule=schedule, n_chunks=4, integrity=integrity,
                            service_kw=service_kw) for side in (PORT, REF)}
    (p_trace, p_m, p_res), (r_trace, r_m, r_res) = runs[PORT], runs[REF]
    assert p_trace == r_trace
    assert any(fired for _, fired in p_trace)
    assert {k: p_m[k] for k in COUNTERS} == {k: r_m[k] for k in COUNTERS}
    refs = want(ys)
    for got_p, got_r, ref in zip(p_res, r_res, refs):
        if isinstance(got_r, str):
            assert got_p == got_r  # the same typed failure
        else:
            np.testing.assert_array_equal(got_p, got_r)
            if case != "corrupt":
                np.testing.assert_array_equal(got_p, ref)
    if case == "corrupt":
        assert p_m["integrity_flagged"] == 1
        assert [r for r in p_res if isinstance(r, str)] == ["IntegrityError"]
    if schedule:
        assert p_m["faults_injected"] == {k: len(v) for k, v in schedule.items()}


# ---------------------------------------------------------------------------
# The trigger
# ---------------------------------------------------------------------------
def test_deadline_batcher_matches_the_reference_under_a_fake_clock():
    clk = FakeClock()
    port = DeadlineBatcher(max_batch_blocks=4, deadline_s=0.010, clock=clk.now)
    ref = j_serve_async.DeadlineBatcher(max_batch_blocks=4, deadline_s=0.010, clock=clk.now)
    rng = np.random.default_rng(1)
    for _ in range(200):
        op = int(rng.integers(0, 4))
        for b in (port, ref):
            if op == 0:
                b.note_feed()
            elif op == 1:
                b.fired()
        if op == 2:
            clk.advance(float(rng.uniform(0, 0.006)))
        pending = int(rng.integers(0, 6))
        assert port.due(pending) == ref.due(pending)
        assert port.timeout() == ref.timeout()
    with pytest.raises(ValueError):
        DeadlineBatcher(0, 1.0)
    with pytest.raises(ValueError):
        DeadlineBatcher(1, -1.0)


def test_service_dispatch_deadline_and_latencies_on_a_fake_clock():
    """Manual poll() under a fake clock: the dispatch sequence and every
    recorded chunk latency are exact numbers, as in the reference."""
    y = stream("ccsds", N_BITS, 8)
    clk = FakeClock()

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=10.0,
                                 max_pending_blocks=10_000, clock=clk.now)
        st = svc.open(engine())
        await st.send(y[: len(y) // 2])
        assert svc.poll() is False
        clk.advance(0.009)
        assert svc.poll() is False
        clk.advance(0.001)
        assert svc.poll() is True  # exactly at the 10 ms deadline
        assert svc.poll() is False
        clk.advance(5.0)
        assert svc.poll() is False  # the arm was cleared by the fire
        await st.send(y[len(y) // 2 :])
        clk.advance(0.010)
        assert svc.poll() is True
        clk.advance(0.003)
        return await st.finish(N_BITS), svc

    out, svc = asyncio.run(scenario())
    np.testing.assert_array_equal(bits_of(out), want([y])[0])
    m = svc.metrics()
    assert (m["dispatches"], m["chunks"]) == (2, 2)
    lats = sorted(svc._latencies_s)
    assert lats[0] == pytest.approx(0.013) and lats[1] == pytest.approx(5.020)


def test_metrics_guard_small_samples():
    m = AsyncDecodeService(max_batch_blocks=1, deadline_ms=1.0).metrics()
    assert m["chunks"] == 0
    assert m["p50_ms"] is None and m["p99_ms"] is None and m["sustained_mbps"] is None
    assert _latency_summary([]) == "no latency samples"
    assert "p99≈max" in _latency_summary([1.0, 2.0])


# ---------------------------------------------------------------------------
# Backpressure
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blocking", [False, True])
def test_pending_cap_backpressure(blocking):
    y = stream("ccsds", 512, 12)

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0,
                                 max_pending_blocks=2, block_on_backpressure=blocking)
        st = svc.open(engine())
        await st.send(y[:300])  # ≥ 2 blocks ready → at the cap
        assert svc._pool.pending_blocks() >= 2
        if blocking:
            parked = asyncio.ensure_future(st.send(y[300:]))
            for _ in range(5):
                await asyncio.sleep(0)
            assert not parked.done()  # parked on the cap, not queued
            svc._space.set()  # a wake that frees nothing re-parks the sender
            for _ in range(5):
                await asyncio.sleep(0)
            assert not parked.done()
            assert svc.poll() is True
            await asyncio.wait_for(parked, timeout=5)
        else:
            with pytest.raises(Backpressure, match="pending-block cap"):
                await st.send(y[300:])
            assert svc.metrics()["errors_by_class"] == {"Backpressure": 1}
            assert svc.poll() is True
            await st.send(y[300:])
        return torch.cat([st.take(), await st.finish(512)])

    out = asyncio.run(scenario())
    np.testing.assert_array_equal(bits_of(out), want([stream("ccsds", 512, 12)], 512)[0])


@pytest.mark.parametrize("blocking", [False, True])
def test_slab_backpressure_and_the_hopeless_admit(blocking):
    y = stream("ccsds", 512, 14)

    async def scenario():
        sl = SymbolSlab(n_pages=4, page_stages=T_PAGE, R=2)
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0, slab=sl,
                                 block_on_backpressure=blocking)
        st = svc.open(engine())
        await st.send(y[: 4 * T_PAGE])  # fills the slab exactly
        if blocking:
            parked = asyncio.ensure_future(st.send(y[4 * T_PAGE :]))
            for _ in range(5):
                await asyncio.sleep(0)
            assert not parked.done()
            assert svc.poll() is True  # decode → commit → pages freed
            await asyncio.wait_for(parked, timeout=5)
        else:
            with pytest.raises(Backpressure, match="slab pages"):
                await st.send(y[4 * T_PAGE :])
            assert svc.poll() is True
            await st.send(y[4 * T_PAGE :])
        assert svc.metrics()["errors_by_class"]["SlabExhausted"] == 1
        bits = torch.cat([st.take(), await st.finish(512)])
        assert sl.pages_in_use == 0
        # a chunk bigger than the whole slab raises even in blocking mode
        svc2 = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0,
                                  slab=SymbolSlab(n_pages=1, page_stages=8, R=2))
        with pytest.raises(SlabExhausted):
            await svc2.open(engine()).send(y[:300])
        return bits

    out = asyncio.run(scenario())
    np.testing.assert_array_equal(bits_of(out), want([y], 512)[0])


# ---------------------------------------------------------------------------
# The acceptance trace and tensor chunks
# ---------------------------------------------------------------------------
def test_64_stream_poisson_trace_bit_exact():
    S = 64
    ys = [stream("ccsds", N_BITS, 40 + i) for i in range(S)]
    sl = SymbolSlab(n_pages=6 * S, page_stages=T_PAGE, R=2)
    bits, report = asyncio.run(run_poisson_trace(
        engine(), ys, [N_BITS] * S, chunk_symbols=100, rate_chunks_per_s=5000.0, seed=3,
        slab=sl, service_kwargs=dict(max_batch_blocks=64, deadline_ms=2.0)))
    for b, r in zip(bits, want(ys)):
        np.testing.assert_array_equal(bits_of(b), r)
    assert report["chunks"] == sum(-(-len(y) // 100) for y in ys)
    assert report["bits_delivered"] == S * N_BITS
    assert report["p50_ms"] is not None
    assert 0 < report["slab_pages_high_water"] <= sl.n_pages
    assert sl.pages_in_use == 0
    assert report["dispatches"] < report["chunks"]  # the dispatcher coalesced


def test_tensor_chunks_and_punctured_streams():
    """send() takes what DecoderSession.ingest takes: tensors (here on the
    CPU) and 1-D punctured chunks; bits stay tensors on the engine's device."""
    y = stream("ccsds-3/4", N_BITS, 17)

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0,
                                 slab=SymbolSlab(n_pages=16, page_stages=T_PAGE, R=2))
        st = svc.open(engine("ccsds-3/4"))
        outs = []
        for c in chunks_of(y, 5):
            await st.send(torch.from_numpy(c))
            svc.poll()
            outs.append(st.take())
        outs.append(await st.finish(N_BITS))
        assert all(o.dtype == torch.int32 and o.device.type == "cpu" for o in outs)
        return torch.cat(outs)

    got = asyncio.run(scenario())
    np.testing.assert_array_equal(bits_of(got), want([y], name="ccsds-3/4")[0])
