"""The port's elastic rescale after device loss against the reference, on the CPU.

``plan_rescale`` and ``plan_decode_rescale`` must return the reference's
plans over a grid of mesh shapes, casualty counts and ``shrink_axes``
choices (the reference's functions read only ``axis_names`` and ``shape``,
so both get the same plain object). Then ``rescale_decode_engine`` and the
async service's mesh-loss path on meshes over ``["cpu"] * n``: every
rebuilt engine, replayed dispatch and recovered journal delivers bits
equal to the port's meshless decode and the JAX ``backend="ref"`` one-shot
decode. Mirrors the elastic cases of ``tests/test_fault_tolerance.py``,
``tests/test_faults.py`` and ``tests/test_serve_async.py``.
"""

import asyncio
import itertools
import math

import numpy as np
import pytest

from repro.core.engine import DecoderEngine as JEngine
from repro.launch import elastic as j_elastic
from repro.launch.mesh import make_decode_mesh as j_make_decode_mesh
from repro_torch.core.engine import DecoderEngine
from repro_torch.launch import elastic
from repro_torch.launch.faults import FaultInjector
from repro_torch.launch.mesh import make_decode_mesh
from repro_torch.launch.serve_async import AsyncDecodeService

import test_torch_journal
from test_torch_journal import _crash_half, _recover_half
from test_torch_serve_async import (
    MODS,
    PORT,
    REF,
    FakeClock,
    bits_of,
    chunks_of,
    engine,
    engine_of,
    stream,
    want,
)

CPU8 = ["cpu"] * 8


class FakeMesh:
    def __init__(self, names, sizes):
        self.axis_names = tuple(names)
        self.shape = dict(zip(names, sizes))


GRID = [(("data",), (8,)), (("pod", "data"), (4, 4)), (("pod", "data", "model"), (2, 4, 2))]


def meshed(spec: str, **kw) -> DecoderEngine:
    return DecoderEngine(engine().cfg, mesh=make_decode_mesh(spec, devices=CPU8), **kw)


def subsets(names):
    return [c for r in range(1, len(names) + 1) for c in itertools.combinations(names, r)]


# ---------------------------------------------------------------------------
# Plans
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("names,sizes", GRID, ids=["8", "4x4", "2x4x2"])
def test_plans_equal_the_reference(names, sizes):
    mesh = FakeMesh(names, sizes)
    total = math.prod(sizes)
    for lost in range(total + 1):
        for shrink in [None, *subsets(names)]:
            got = elastic.plan_rescale(mesh, lost, shrink_axes=shrink)
            ref = j_elastic.plan_rescale(mesh, lost, shrink_axes=shrink)
            assert (got.old_shape, got.new_shape, got.axis_names, got.dropped_chips,
                    got.new_chip_count) == (ref.old_shape, ref.new_shape, ref.axis_names,
                                            ref.dropped_chips, ref.new_chip_count), (lost, shrink)
            if shrink is None:
                continue
            got = elastic.plan_decode_rescale(mesh, shrink, lost)
            ref = j_elastic.plan_decode_rescale(mesh, shrink, lost)
            assert (got is None) == (ref is None), (lost, shrink)
            if got is not None:
                assert dataclass_tuple(got) == dataclass_tuple(ref)


def dataclass_tuple(plan) -> tuple:
    return plan.old_shape, plan.new_shape, plan.axis_names, plan.dropped_chips


def test_plan_rescale_maximizes_across_axes_and_refuses_unknown_axes():
    """The counterexample to a first-fit search: two 4-wide axes, 7 chips
    lost; 3×3 = 9 chips survive, not 4×2 = 8."""
    plan = elastic.plan_rescale(FakeMesh(("a", "b"), (4, 4)), lost_chips=7)
    assert plan.new_chip_count == 9 and sorted(plan.new_shape) == [3, 3]
    assert plan.dropped_chips == 7
    mesh = FakeMesh(("pod", "data"), (2, 8))
    assert elastic.plan_rescale(mesh, 4, shrink_axes=("data",)).new_shape == (2, 6)
    with pytest.raises(ValueError, match="shrink_axes") as got:
        elastic.plan_rescale(mesh, 1, shrink_axes=("bogus",))
    with pytest.raises(ValueError) as ref:
        j_elastic.plan_rescale(mesh, 1, shrink_axes=("bogus",))
    assert str(got.value) == str(ref.value)
    assert elastic.plan_decode_rescale(FakeMesh(("data",), (1,)), ("data",), 1) is None
    assert elastic.plan_decode_rescale(FakeMesh(("pod", "data"), (4, 2)), ("data",), 5) is None


# ---------------------------------------------------------------------------
# rescale_decode_engine
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dispatch", ["constraint", "shard_map"])
def test_rescale_decode_engine_shrinks_then_drops_to_meshless(dispatch):
    eng = meshed("data=8", shard_dispatch=dispatch)
    five = elastic.rescale_decode_engine(eng, 3)
    assert dict(five.mesh.shape) == {"data": 5} and five.n_shards == 5
    assert (five.cfg, five.block_axes, five.shard_dispatch, five.device) == (
        eng.cfg, ("data",), dispatch, eng.device)
    assert list(five.mesh.devices.flat) == list(eng.mesh.devices.flat)[:5]
    gone = elastic.rescale_decode_engine(eng, 7)
    assert gone.mesh is None and gone.n_shards == 1 and gone.block_axes == ("data",)
    assert (gone.cfg, gone.shard_dispatch, gone.device) == (eng.cfg, dispatch, eng.device)
    assert elastic.rescale_decode_engine(gone, 1) is gone  # meshless: unchanged
    ys = [stream("ccsds", 512, 70 + i) for i in range(3)]
    ref = want(ys, 512)
    for e in (eng, five, gone):
        for got, r in zip(e.decode_batch(ys, [512] * 3), ref):
            np.testing.assert_array_equal(bits_of(got), r)


def test_rescale_keeps_fixed_axes_and_matches_the_reference_shape():
    eng = DecoderEngine(engine().cfg, mesh=make_decode_mesh("pod=2,data=4", devices=CPU8),
                        block_axes=("data",))
    new = elastic.rescale_decode_engine(eng, 3)
    assert dict(new.mesh.shape) == {"pod": 2, "data": 2} and new.n_shards == 2
    plan = j_elastic.plan_decode_rescale(FakeMesh(("pod", "data"), (2, 4)), ("data",), 3)
    assert plan.new_shape == tuple(new.mesh.shape.values())


# ---------------------------------------------------------------------------
# The service: MeshLost rebuilds meshed engines and replays bit-exact
# ---------------------------------------------------------------------------
def _one_loss(side: str, eng, y, *, schedule: dict, flush_only: bool = False):
    """One stream under ``schedule``; returns the bits, the metrics and the
    engine the stream ends on."""
    f_mod, s_mod, _ = MODS[side]
    clk = FakeClock()

    async def scenario():
        svc = s_mod.AsyncDecodeService(max_batch_blocks=1, deadline_ms=0.0, clock=clk.now,
                                       fault_injector=f_mod.FaultInjector(schedule=schedule))
        st = svc.open(eng)
        await st.send(y)
        if not flush_only:
            assert svc.poll() is True  # MeshLost: engines rebuilt, replay armed
            assert svc.poll() is True  # the replay
        bits = bits_of(st.take()), bits_of(await st.finish(512))
        return np.concatenate(bits), svc.metrics(), st._handle._session.engine, svc

    return asyncio.run(scenario())


def test_mesh_loss_on_four_devices_rebuilds_three_and_replays():
    y = stream("ccsds", 512, 26)
    eng = meshed("data=4")
    bits, m, now, _ = _one_loss(PORT, eng, y, schedule={"mesh": {0}})
    assert now is not eng and dict(now.mesh.shape) == {"data": 3}
    assert (m["errors_by_class"], m["retries"]) == ({"MeshLost": 1}, 1)
    np.testing.assert_array_equal(bits, want([y], 512)[0])


def test_mesh_loss_on_one_device_drops_to_meshless_as_the_reference():
    """The reference on its one-device JAX mesh and the port on a one-device
    mesh: both rebuild meshless, with the same counters and bits."""
    y = stream("ccsds", 512, 26)
    out = {}
    for side, eng in ((PORT, meshed("data=1")),
                      (REF, JEngine(engine_of(REF).cfg, mesh=j_make_decode_mesh("data=1"),
                                    block_axes=("data",)))):
        bits, m, now, _ = _one_loss(side, eng, y, schedule={"mesh": {0}})
        assert now is not eng and now.mesh is None
        assert (m["errors_by_class"], m["retries"]) == ({"MeshLost": 1}, 1)
        out[side] = bits, {k: m[k] for k in ("dispatches", "launches", "bits_delivered")}
    np.testing.assert_array_equal(out[PORT][0], out[REF][0])
    assert out[PORT][1] == out[REF][1]
    np.testing.assert_array_equal(out[PORT][0], want([y], 512)[0])


def test_mesh_loss_at_the_flush_rebuilds_and_replays_the_flush():
    y = stream("ccsds", 512, 27)
    eng = meshed("data=2", shard_dispatch="shard_map")
    bits, m, now, _ = _one_loss(PORT, eng, y, schedule={"mesh": {0}}, flush_only=True)
    assert now.mesh is None  # two devices less one: meshless
    assert (m["errors_by_class"], m["retries"]) == ({"MeshLost": 1}, 1)
    np.testing.assert_array_equal(bits, want([y], 512)[0])


def test_mesh_loss_drill_four_to_meshless_on_many_streams():
    """data=4 → 3 → 2 → meshless under a scheduled loss at three dispatches;
    every stream exact, the injector's counts equal to the schedule."""
    ys = [stream("ccsds", 512, 80 + i) for i in range(6)]
    eng = meshed("data=4")
    clk = FakeClock()
    schedule = {"mesh": {0, 2, 4}}

    async def scenario():
        inj = FaultInjector(schedule=schedule)
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0, clock=clk.now,
                                 fault_injector=inj)
        streams = [svc.open(eng) for _ in ys]
        shapes = []
        for k in range(4):
            for st, y in zip(streams, ys):
                await st.send(chunks_of(y, 4)[k])
            for _ in range(2):
                svc.poll()
                e = streams[0]._handle._session.engine
                shapes.append(None if e.mesh is None else e.mesh.shape["data"])
        outs = [np.concatenate([bits_of(st.take()), bits_of(await st.finish(512))])
                for st in streams]
        return outs, svc.metrics(), inj, shapes

    outs, m, inj, shapes = asyncio.run(scenario())
    assert inj.fired["mesh"] == 3 and m["faults_injected"] == {"mesh": 3}
    assert m["errors_by_class"] == {"MeshLost": 3} and m["retries"] == 3
    assert [s for i, s in enumerate(shapes) if i == 0 or s != shapes[i - 1]] == [3, 2, None]
    for got, ref in zip(outs, want(ys, 512)):
        np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# Journals cross between meshed and meshless services
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("writer,reader", [("data=4", None), (None, "pod=2,data=2")])
def test_a_journal_recovers_across_the_mesh_exactly_once(tmp_path, monkeypatch, writer, reader):
    n_bits = 512
    ys = [stream("ccsds", n_bits, 90 + i) for i in range(3)]
    chunk_lists = [chunks_of(y, 4) for y in ys]

    def use(spec):
        eng = engine() if spec is None else DecoderEngine(
            engine().cfg, mesh=make_decode_mesh(spec, devices=CPU8), block_axes=None)
        monkeypatch.setattr(test_torch_journal, "engine_of", lambda side, **kw: eng)

    use(writer)
    durable = _crash_half(PORT, chunk_lists, 2, tmp_path, n_bits=n_bits)
    use(reader)
    outs, sl = _recover_half(PORT, chunk_lists, durable, tmp_path, n_bits=n_bits)
    for got, ref in zip(outs, want(ys, n_bits)):
        assert len(got) == n_bits  # exactly once: no duplicate, no gap
        np.testing.assert_array_equal(got, ref)
    assert sl.pages_in_use == 0
