"""The port's failure taxonomy, retry policy and fault injector against the
reference's, and the service's failure model, on the CPU.

The classes, the retry schedule and every ``fire()`` sequence must equal the
reference's for the same seed, schedule and rates. The service's failure
paths (quarantine by bisection, retry with backoff, device loss without a
mesh, shedding, the dispatcher's death) run on port engines (``device="cpu"``,
``backend="ref"``, D = 64, L = 16), and every healthy stream is held bit for
bit against the JAX ``backend="ref"`` one-shot decode. Mirrors
``tests/test_faults.py``.
"""

import asyncio

import numpy as np
import pytest
import torch

from repro.launch import faults as j_faults
from repro.launch import serve_async as j_serve_async
from repro.launch import slab as j_slab
from repro_torch.launch import faults, serve_async, slab
from repro_torch.launch.faults import (
    FAULT_SITES,
    DispatchError,
    FaultInjector,
    RetryPolicy,
    ShedError,
    StreamError,
    SymbolError,
    nonfinite_error,
)
from repro_torch.launch.serve_async import AsyncDecodeService, run_poisson_trace
from repro_torch.launch.serve_decoder import SessionPool
from repro_torch.launch.slab import SymbolSlab

from test_torch_serve_async import (
    N_BITS,
    T_PAGE,
    FakeClock,
    bits_of,
    engine,
    stream,
    want,
)

CLASSES = [
    (faults, j_faults, "DecodeError"),
    (faults, j_faults, "StreamError"),
    (faults, j_faults, "SymbolError"),
    (faults, j_faults, "IntegrityError"),
    (faults, j_faults, "DispatchError"),
    (faults, j_faults, "MeshLost"),
    (faults, j_faults, "CapacityError"),
    (faults, j_faults, "ShedError"),
    (serve_async, j_serve_async, "Backpressure"),
    (slab, j_slab, "SlabExhausted"),
]


# ---------------------------------------------------------------------------
# Taxonomy, retry policy, injector
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("port_mod,ref_mod,name", CLASSES, ids=[c[2] for c in CLASSES])
def test_taxonomy_mro_names_equal_the_reference(port_mod, ref_mod, name):
    port, ref = getattr(port_mod, name), getattr(ref_mod, name)
    assert [c.__name__ for c in port.__mro__] == [c.__name__ for c in ref.__mro__]


def test_typed_errors_carry_the_reference_fields():
    assert faults.MeshLost("gone", lost_chips=4).lost_chips == 4
    err = faults.IntegrityError("x", stream=7, agreement=0.5, bound=0.85)
    assert (err.stream, err.agreement, err.bound) == (7, 0.5, 0.85)
    assert str(nonfinite_error("decode()", 3, 100)) == str(j_faults.nonfinite_error("decode()", 3, 100))
    assert isinstance(nonfinite_error("t", 1, 2), ValueError)


@pytest.mark.parametrize("kw", [dict(), dict(max_retries=4, backoff_s=0.01, max_backoff_s=0.05),
                                dict(max_retries=0, backoff_s=0.0),
                                dict(backoff_s=0.003, multiplier=3.0, max_backoff_s=1.0)])
def test_retry_policy_schedule_equals_the_reference(kw):
    port, ref = RetryPolicy(**kw), j_faults.RetryPolicy(**kw)
    assert port.max_retries == ref.max_retries
    assert [port.delay_s(k) for k in range(8)] == [ref.delay_s(k) for k in range(8)]
    with pytest.raises(ValueError):
        port.delay_s(-1)


@pytest.mark.parametrize("kw", [dict(max_retries=-1), dict(multiplier=0.5), dict(backoff_s=-1.0)])
def test_retry_policy_refusals(kw):
    with pytest.raises(ValueError):
        RetryPolicy(**kw)
    with pytest.raises(ValueError):
        j_faults.RetryPolicy(**kw)


def test_fault_sites_in_the_reference_order():
    assert FAULT_SITES == j_faults.FAULT_SITES
    assert FAULT_SITES[-1] == "decode_corrupt"


@pytest.mark.parametrize("site", FAULT_SITES)
def test_injector_fire_sequence_equals_the_reference(site):
    """Schedule and rate modes at one site, interleaved with the others: the
    same seed consults the same per-site rng streams, draw for draw."""
    kw = dict(seed=11, schedule={site: {0, 3, 17}}, rates={s: 0.2 for s in FAULT_SITES},
              mesh_lost_chips=2)
    port, ref = FaultInjector(**kw), j_faults.FaultInjector(**kw)
    order = np.random.default_rng(5).choice(FAULT_SITES, 300)
    seq_p = [port.fire(s) for s in order]
    seq_r = [ref.fire(s) for s in order]
    assert seq_p == seq_r and 0 < sum(seq_p) < len(seq_p)
    assert dict(port.counts) == dict(ref.counts)
    assert dict(port.fired) == dict(ref.fired)
    assert port.mesh_lost_chips == ref.mesh_lost_chips == 2


def test_injector_refusals():
    inj = FaultInjector(schedule={"dispatch": {1}})
    assert [inj.fire("dispatch") for _ in range(3)] == [False, True, False]
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultInjector(schedule={"bogus": {0}})
    with pytest.raises(ValueError, match="unknown fault site"):
        inj.fire("bogus")
    with pytest.raises(ValueError):
        FaultInjector(rates={"slab": 1.5})


# ---------------------------------------------------------------------------
# The service's failure model
# ---------------------------------------------------------------------------
def test_retry_backoff_on_a_fake_clock():
    y = stream("ccsds", 512, 22)
    clk = FakeClock()

    async def scenario():
        svc = AsyncDecodeService(
            max_batch_blocks=1, deadline_ms=0.0, clock=clk.now,
            retry=RetryPolicy(max_retries=3, backoff_s=0.010, multiplier=2.0),
            fault_injector=FaultInjector(schedule={"dispatch": {0, 1}}))
        st = svc.open(engine())
        await st.send(y)
        assert svc.poll() is True  # attempt 1 fails: 10 ms backoff armed
        assert svc._retry_at == pytest.approx(clk.now() + 0.010)
        assert svc.poll() is False
        clk.advance(0.010)
        assert svc.poll() is True  # attempt 2 fails: 20 ms
        assert svc._retry_at == pytest.approx(clk.now() + 0.020)
        clk.advance(0.020)
        assert svc.poll() is True  # attempt 3 succeeds
        m = svc.metrics()
        assert (m["retries"], m["errors_by_class"], m["quarantined_streams"]) == (
            2, {"DispatchError": 2}, 0)
        return torch.cat([st.take(), await st.finish(512)])

    np.testing.assert_array_equal(bits_of(asyncio.run(scenario())), want([y], 512)[0])


def test_mesh_loss_without_a_mesh_is_a_replayed_dispatch():
    """On a meshless engine a MeshLost is absorbed as a retried dispatch
    that replays the ready blocks, bit-exact."""
    y = stream("ccsds", 512, 26)
    clk = FakeClock()

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1, deadline_ms=0.0, clock=clk.now,
                                 fault_injector=FaultInjector(schedule={"mesh": {0}}))
        eng = engine()
        st = svc.open(eng)
        await st.send(y)
        assert svc.poll() is True  # MeshLost: retry armed at once
        assert st._handle._session.engine is eng
        assert svc.poll() is True  # the replay
        m = svc.metrics()
        assert (m["errors_by_class"], m["retries"]) == ({"MeshLost": 1}, 1)
        return torch.cat([st.take(), await st.finish(512)])

    np.testing.assert_array_equal(bits_of(asyncio.run(scenario())), want([y], 512)[0])


def test_poisoned_stream_quarantined_in_one_poll_and_pages_reused():
    y0, y1 = stream("ccsds", 512, 23), stream("ccsds", 512, 24)

    async def scenario():
        sl = SymbolSlab(n_pages=16, page_stages=T_PAGE, R=2)
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0,
                                 max_pending_blocks=10_000, slab=sl,
                                 fault_injector=FaultInjector(schedule={"stream_poison": {1}}))
        healthy, poisoned = svc.open(engine()), svc.open(engine())
        await healthy.send(y0)
        await poisoned.send(y1)
        held = sl.pages_in_use
        assert svc.poll() is True  # bisect + quarantine + deliver
        assert poisoned.failed is not None
        with pytest.raises(StreamError):
            poisoned.take()
        with pytest.raises(StreamError):
            await poisoned.send(y1[:10])
        assert sl.pages_in_use < held
        assert np.all(sl._data[sl._free] == 0.0)  # released pages are zeroed
        m = svc.metrics()
        assert m["quarantined_streams"] == 1 and m["errors_by_class"]["StreamError"] >= 1
        bits = torch.cat([healthy.take(), await healthy.finish(512)])
        assert sl.pages_in_use == 0
        reuse = svc.open(engine())
        await reuse.send(y1)
        svc.poll()
        return bits, torch.cat([reuse.take(), await reuse.finish(512)])

    bits, reuse = asyncio.run(scenario())
    w0, w1 = want([y0, y1], 512)
    np.testing.assert_array_equal(bits_of(bits), w0)
    np.testing.assert_array_equal(bits_of(reuse), w1)


def test_nonfinite_chunk_quarantines_only_its_stream():
    ya, yb = stream("ccsds", 192, 30), stream("ccsds", 192, 31)
    bad = yb.copy()
    bad[7] = np.nan

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0)
        a, b = svc.open(engine()), svc.open(engine())
        await a.send(ya[: len(ya) // 2])
        with pytest.raises(SymbolError, match="non-finite"):
            await b.send(bad)
        assert b.failed is not None
        await a.send(ya[len(ya) // 2 :])
        svc.poll()
        bits = torch.cat([a.take(), await a.finish(192)])
        assert svc.metrics()["quarantined_streams"] == 1
        return bits

    np.testing.assert_array_equal(bits_of(asyncio.run(scenario())), want([ya], 192)[0])


def test_shedding_past_the_deadline_on_a_fake_clock():
    y = stream("ccsds", 512, 25)
    clk = FakeClock()

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0, max_pending_blocks=2,
                                 clock=clk.now, shed_deadline_ms=50.0)
        st = svc.open(engine())
        await st.send(y[:300])
        parked = asyncio.ensure_future(st.send(y[300:]))
        for _ in range(5):
            await asyncio.sleep(0)
        svc._space.set()  # a wake inside the deadline re-parks
        for _ in range(5):
            await asyncio.sleep(0)
        assert not parked.done()
        clk.advance(0.051)
        svc._space.set()
        with pytest.raises(ShedError, match="shed"):
            await asyncio.wait_for(parked, timeout=5)
        m = svc.metrics()
        assert (m["shed_blocks"], m["errors_by_class"]) == (1, {"ShedError": 1})
        assert st.failed is None  # shedding drops the chunk, not the stream
        assert svc.poll() is True
        await st.send(y[300:])
        svc.poll()
        return torch.cat([st.take(), await st.finish(512)])

    np.testing.assert_array_equal(bits_of(asyncio.run(scenario())), want([y], 512)[0])


def test_dispatcher_death_reaches_every_waiter_and_aclose():
    """The stranded-waiter fix: a pool whose step() raises something the
    failure model does not absorb fails parked senders, new work and aclose()."""
    y = stream("ccsds", 512, 27)

    class RaisingPool(SessionPool):
        def step(self, *, isolate=False):
            raise RuntimeError("launch exploded")

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1, deadline_ms=0.0, max_pending_blocks=1,
                                 retry=RetryPolicy(max_retries=1, backoff_s=0.0))
        raising = RaisingPool()
        raising._members = svc._pool._members
        svc._pool = raising
        svc.start()
        st = svc.open(engine())
        await st.send(y[:300])
        parked = asyncio.ensure_future(st.send(y[300:]))
        with pytest.raises(DispatchError, match="dispatcher died"):
            await asyncio.wait_for(parked, timeout=10)
        with pytest.raises(DispatchError):
            await st.send(y[300:])
        with pytest.raises(DispatchError):
            await st.finish(512)
        with pytest.raises(DispatchError):
            svc.open(engine())
        with pytest.raises(DispatchError, match="dispatcher died"):
            await svc.aclose()
        m = svc.metrics()
        assert m["errors_by_class"] == {"RuntimeError": 2, "DispatchError": 1}
        assert m["retries"] == 1

    asyncio.run(scenario())


# ---------------------------------------------------------------------------
# The chaos trace
# ---------------------------------------------------------------------------
def test_chaos_64_stream_trace_healthy_bit_exact_poisoned_typed():
    """The reference's chaos schedule (stream poison, transient dispatch,
    slab exhaustion, device loss, an admission fault) over 64 Poisson
    streams: healthy streams bit-exact to JAX, failures typed, nothing hung,
    no page leaked, and the injector fired exactly its schedule."""
    S = 64
    ys = [stream("ccsds", N_BITS, 80 + i) for i in range(S)]
    sl = SymbolSlab(n_pages=6 * S, page_stages=T_PAGE, R=2)
    poisoned = {3, 17}
    schedule = {"stream_poison": poisoned, "dispatch": {1, 4}, "slab": {5, 30}, "mesh": {2},
                "admission": {100}}
    injector = FaultInjector(seed=5, schedule=schedule)
    results, report = asyncio.run(run_poisson_trace(
        engine(), ys, [N_BITS] * S, chunk_symbols=100, rate_chunks_per_s=5000.0, seed=9,
        slab=sl, service_kwargs=dict(max_batch_blocks=64, deadline_ms=2.0),
        fault_injector=injector))
    failed = {i for i, r in enumerate(results) if isinstance(r, Exception)}
    assert poisoned <= failed and len(failed) <= len(poisoned) + 1
    assert all(isinstance(results[i], StreamError) for i in failed)
    for i, ref in enumerate(want(ys)):
        if i not in failed:
            np.testing.assert_array_equal(bits_of(results[i]), ref)
    assert sl.pages_in_use == 0
    assert report["quarantined_streams"] == len(failed)
    assert dict(injector.fired) == {k: len(v) for k, v in schedule.items()}
    assert report["faults_injected"] == dict(injector.fired)
    errs = report["errors_by_class"]
    assert (errs["DispatchError"], errs["MeshLost"], errs["SlabExhausted"],
            errs["SymbolError"]) == (2, 1, 2, 1)
    assert 1 <= errs["StreamError"] <= 2
    assert report["bits_delivered"] >= (S - len(failed)) * N_BITS
