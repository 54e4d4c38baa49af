"""The port's lane split over a device mesh against the reference, on the CPU.

Meshes are built over device lists that name the CPU several times
(``["cpu"] * 8``), so the split runs for real: 8 equal lane slices, 8
launches, joined on the engine's device. Every mesh-bound ``decode``,
``decode_batch``, session and pool step is held bit for bit against the
port's meshless decode and the JAX ``backend="ref"`` engine, on numpy
streams made from a seed (D = 64, L = 16, q = 8); every eager refusal
against the reference's message. Mirrors ``tests/test_mesh_engine.py`` and
the mesh cases of ``tests/test_distributed.py``.
"""

import functools
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.engine import DecoderEngine as JEngine
from repro.core.pbvd import PBVDConfig as JConfig
from repro.kernels import ops as j_ops
from repro.launch import mesh as j_mesh
from repro.sharding import rules as j_rules
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig, decode_stream_sharded
from repro_torch.device import DeviceUnavailableError
from repro_torch.kernels.ops import SHARD_DISPATCH, check_mesh_launch
from repro_torch.launch import serve_decoder
from repro_torch.launch.mesh import (
    DecodeMesh,
    make_decode_mesh,
    make_local_mesh,
    parse_mesh_spec,
    shrink_mesh,
)
from repro_torch.launch.serve_decoder import SessionPool
from repro_torch.sharding.rules import block_mesh_axes
from repro_torch.sharding.smap import lane_shard_devices, lane_split

from test_torch_serve_async import GEO, stream

CPU8 = ["cpu"] * 8
LENS = [96, 190, 96, 250, 128]  # 13 blocks of D = 64: divides no shard count here
MESHES = {"data=8": ("data=8", ("data",)), "pod=2,data=4": ("pod=2,data=4", None)}


def cfg_of(backend: str = "ref", metric_mode: str = "f32") -> PBVDConfig:
    return PBVDConfig(spec=get_code_spec("ccsds"), backend=backend, metric_mode=metric_mode,
                      **GEO)


class FakeMesh:
    """What the reference's checks read of a mesh: axis names and sizes."""

    def __init__(self, **sizes):
        self.axis_names = tuple(sizes)
        self.shape = dict(sizes)


@functools.lru_cache(maxsize=None)
def fleet() -> tuple:
    return tuple(stream("ccsds", n, 30 + i) for i, n in enumerate(LENS))


@functools.lru_cache(maxsize=None)
def jax_fleet_bits(metric_mode: str) -> tuple:
    """The JAX reference's meshless ``decode_batch`` of the ragged fleet."""
    eng = JEngine(JConfig(spec=j_get_code_spec("ccsds"), backend="ref", metric_mode=metric_mode,
                          **GEO))
    return tuple(np.asarray(b) for b in eng.decode_batch([jnp.asarray(y) for y in fleet()], LENS))


@functools.lru_cache(maxsize=None)
def port_fleet_bits(backend: str, metric_mode: str) -> tuple:
    eng = DecoderEngine(cfg_of(backend, metric_mode), device="cpu")
    return tuple(b.numpy() for b in eng.decode_batch(fleet(), LENS)), eng.decode(
        fleet()[1], LENS[1]).numpy()


def message(fn, *args, **kw) -> str:
    with pytest.raises((ValueError, KeyError)) as info:
        fn(*args, **kw)
    return str(info.value)


# ---------------------------------------------------------------------------
# Mesh decode: every backend × metric mode × dispatch × mesh, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("dispatch", SHARD_DISPATCH)
@pytest.mark.parametrize("metric_mode", ["f32", "i8"])
@pytest.mark.parametrize("backend", ["ref", "cuda", "fused"])
def test_mesh_decode_equals_meshless_and_jax(backend, metric_mode, dispatch, mesh_name):
    spec, block_axes = MESHES[mesh_name]
    eng = DecoderEngine(cfg_of(backend, metric_mode), mesh=make_decode_mesh(spec, devices=CPU8),
                        block_axes=block_axes, shard_dispatch=dispatch)
    assert eng.n_shards == 8 and eng.device == torch.device("cpu")
    assert eng.block_axes == (("pod", "data") if block_axes is None else block_axes)
    batch, one = port_fleet_bits(backend, metric_mode)
    got = eng.decode_batch(fleet(), LENS)
    for g, b, j in zip(got, batch, jax_fleet_bits(metric_mode)):
        assert g.dtype == torch.int32 and g.device == eng.device
        np.testing.assert_array_equal(g.numpy(), b)
        np.testing.assert_array_equal(g.numpy(), j)
    np.testing.assert_array_equal(eng.decode(fleet()[1], LENS[1]).numpy(), one)


@pytest.mark.parametrize("dispatch", SHARD_DISPATCH)
def test_mesh_session_and_sharded_stream_decode(dispatch):
    mesh = make_decode_mesh("data=8", devices=CPU8)
    y, n = fleet()[3], LENS[3]
    want = port_fleet_bits("ref", "f32")[0][3]
    np.testing.assert_array_equal(want, jax_fleet_bits("f32")[3])
    eng = DecoderEngine(cfg_of(), mesh=mesh, shard_dispatch=dispatch)
    sess = eng.session()
    parts = [sess.decode(y[lo:lo + 70]) for lo in range(0, len(y), 70)]
    np.testing.assert_array_equal(torch.cat(parts + [sess.finish(n)]).numpy(), want)
    out = decode_stream_sharded(y, n, cfg_of(), mesh, block_axes=None, shard_dispatch=dispatch)
    np.testing.assert_array_equal(out.numpy(), want)


def test_each_shard_launches_once_on_its_device(monkeypatch):
    """The split hands each shard its slice on its own device; under
    "constraint" a shard with no real lane is not launched, under
    "shard_map" every equal slice is, pad lanes included."""
    from repro_torch.core import engine as engine_mod

    seen = []
    real = engine_mod.pbvd_decode_blocks

    def spy(y_blocks, *a, **kw):
        seen.append(y_blocks.shape[2])
        return real(y_blocks, *a, **kw)

    monkeypatch.setattr(engine_mod, "pbvd_decode_blocks", spy)
    y, n = fleet()[1], LENS[1]  # 3 blocks
    for dispatch, widths in (("constraint", [1, 1, 1]), ("shard_map", [1] * 8)):
        seen.clear()
        eng = DecoderEngine(cfg_of(), mesh=make_decode_mesh("data=8", devices=CPU8),
                            shard_dispatch=dispatch)
        eng.decode(y, n)
        assert seen == widths, dispatch
    seen.clear()
    DecoderEngine(cfg_of(), mesh=make_decode_mesh("data=2", devices=CPU8)).decode(y, n)
    assert seen == [2, 1]


def test_lane_split_order_follows_the_block_axes():
    """Slices go to the lane shards in the row-major order of block_axes;
    other axes replicate, and each shard runs on its first device."""
    mesh = DecodeMesh([torch.device("cpu")] * 8, (2, 2, 2), ("pod", "data", "model"))
    order = np.arange(8).reshape(2, 2, 2)
    # the devices are all the CPU, so hold the index arithmetic on a tagged copy
    tagged = type("M", (), dict(axis_names=mesh.axis_names, shape=mesh.shape,
                                devices=order))()
    assert lane_shard_devices(tagged, ("pod", "data")) == [0, 2, 4, 6]
    assert lane_shard_devices(tagged, ("data", "pod")) == [0, 4, 2, 6]
    assert lane_shard_devices(tagged, ("model",)) == [0, 1]
    assert lane_shard_devices(tagged, ("data", "model")) == [0, 1, 2, 3]
    blocks = torch.arange(2 * 12).reshape(1, 2, 12)
    out = lane_split(lambda b: b[0], blocks, ["cpu"] * 4, out_device=torch.device("cpu"))
    assert torch.equal(out, blocks[0])
    out = lane_split(lambda b: b[0], blocks, ["cpu"] * 4, out_device=torch.device("cpu"),
                     n_real=5)
    assert torch.equal(out, blocks[0, :, :5])
    with pytest.raises(ValueError, match="equal slices"):
        lane_split(lambda b: b[0], blocks, ["cpu"] * 5, out_device=torch.device("cpu"))


def test_a_failed_shard_launch_propagates(monkeypatch):
    """No fallback: the error of a shard's launch reaches the caller."""
    from repro_torch.core import engine as engine_mod

    calls = []

    def boom(y_blocks, *a, **kw):
        calls.append(y_blocks.shape[2])
        if len(calls) == 2:
            raise RuntimeError("shard 1 failed to launch")
        return torch.zeros((64, y_blocks.shape[2]), dtype=torch.int32)

    monkeypatch.setattr(engine_mod, "pbvd_decode_blocks", boom)
    eng = DecoderEngine(cfg_of(), mesh=make_decode_mesh("data=4", devices=CPU8))
    with pytest.raises(RuntimeError, match="shard 1 failed"):
        eng.decode(fleet()[3], LENS[3])
    assert calls == [1, 1]


# ---------------------------------------------------------------------------
# Lane budget
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 3, 6, 8])
def test_lane_budget_divides_into_the_shards_and_never_shrinks(n_shards):
    if n_shards == 1:
        eng = DecoderEngine(cfg_of(), device="cpu")
    else:
        eng = DecoderEngine(cfg_of(),
                            mesh=make_decode_mesh(f"data={n_shards}", devices=CPU8))
    assert eng.n_shards == n_shards
    for n in range(1, 70):
        b = eng._lane_budget(n)
        assert b % n_shards == 0 and n <= b < n + n_shards
    blocks = torch.ones((3, 2, 13), dtype=torch.int8)
    padded = eng._pad_lanes(blocks)
    assert padded.shape[2] == eng._lane_budget(13)
    assert torch.equal(padded[:, :, :13], blocks) and not padded[:, :, 13:].any()


# ---------------------------------------------------------------------------
# Eager refusals, each with the reference's message
# ---------------------------------------------------------------------------
def test_check_mesh_launch_refusals_carry_the_reference_messages():
    mesh = FakeMesh(data=2, model=1)
    for fn in (check_mesh_launch, j_ops.check_mesh_launch):
        assert fn(mesh, ("data",), "ref") == 2
        assert fn(mesh, ("data", "model"), "ref", dispatch="shard_map") == 2
    cases = [
        ((mesh, ("pod",), "ref"), {}),
        ((mesh, ("data", "data"), "ref"), {}),
        ((mesh, (), "ref"), {}),
        ((mesh, ("data",), "ref"), dict(dispatch="pjit")),
        ((FakeMesh(data=0), ("data",), "ref"), {}),
    ]
    for args, kw in cases:
        assert message(check_mesh_launch, *args, **kw) == message(j_ops.check_mesh_launch,
                                                                   *args, **kw)
    with pytest.raises(KeyError, match="no_such_backend"):
        check_mesh_launch(mesh, ("data",), "no_such_backend")
    # the engine runs the same check when it is BUILT, not at the first decode
    with pytest.raises(ValueError, match=r"block_axes \['pod'\] not in mesh axes"):
        DecoderEngine(cfg_of(), mesh=make_local_mesh(2, devices=CPU8), block_axes=("pod",))
    with pytest.raises(ValueError, match="unknown shard dispatch"):
        DecoderEngine(cfg_of(), mesh=make_local_mesh(2, devices=CPU8), shard_dispatch="pjit")


def test_block_mesh_axes_resolve_as_the_reference():
    for names in (("data", "model"), ("pod", "data", "model"), ("data",), ("pod",)):
        m = FakeMesh(**{a: 1 for a in names})
        assert block_mesh_axes(m) == j_rules.block_mesh_axes(m)
    bad = FakeMesh(model=1)
    assert message(block_mesh_axes, bad) == message(j_rules.block_mesh_axes, bad)
    assert j_rules.DEFAULT_RULES["blocks"] == ("pod", "data")
    eng = DecoderEngine(cfg_of(), mesh=make_local_mesh(4, 2, devices=CPU8), block_axes=None)
    assert eng.block_axes == ("data",) and eng.n_shards == 4


@pytest.mark.parametrize("spec", ["", "data", "data=0", "data=x", "data=2,data=4", "=4",
                                  " , ", "data=-1"])
def test_parse_mesh_spec_refusals_match(spec):
    assert message(parse_mesh_spec, spec) == message(j_mesh.parse_mesh_spec, spec)


def test_parse_and_make_decode_mesh():
    for spec in ("data=8", "pod=2, data=4", "data=3,model=2"):
        assert parse_mesh_spec(spec) == j_mesh.parse_mesh_spec(spec)
    mesh = make_decode_mesh("pod=2,data=3", devices=CPU8)
    assert mesh.axis_names == ("pod", "data") and list(mesh.shape.items()) == [("pod", 2),
                                                                               ("data", 3)]
    assert mesh.devices.shape == (2, 3) and mesh.size == 6
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    # "needs N devices, only M available" without the reference's XLA_FLAGS hint
    n = len(jax.devices())
    want = message(j_mesh.make_decode_mesh, f"data={n + 1}")
    got = message(make_decode_mesh, f"data={n + 1}", devices=["cpu"] * n)
    assert got == want.split(" (CPU rehearsal")[0]
    assert message(make_decode_mesh, "data=0", devices=CPU8) == message(
        j_mesh.parse_mesh_spec, "data=0")


def test_make_local_mesh_refusals_match():
    n = len(jax.devices())
    devs = ["cpu"] * n
    for kw in (dict(model=n + 1), dict(model=0), dict(data=n + 1, model=1), dict(data=0)):
        assert message(make_local_mesh, devices=devs, **kw) == message(j_mesh.make_local_mesh,
                                                                        **kw)
    mesh = make_local_mesh(devices=CPU8, model=2)
    assert dict(mesh.shape) == {"data": 4, "model": 2}


def test_device_rules_of_a_mesh(monkeypatch):
    with pytest.raises(ValueError, match="one type"):
        DecodeMesh(["cpu", "meta"], (2,), ("data",))
    mesh = make_decode_mesh("data=2", devices=CPU8)
    DecoderEngine(cfg_of(), mesh=mesh, device="cpu")  # agrees with the mesh: accepted
    with pytest.raises(ValueError, match="mesh's first device"):
        DecoderEngine(cfg_of(), mesh=mesh, device="meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        make_decode_mesh("data=2", devices=["cuda:0"] * 2)
    with pytest.raises(DeviceUnavailableError, match="make_decode_mesh"):
        make_decode_mesh("data=1")  # the default list is every CUDA device
    with pytest.raises(DeviceUnavailableError):
        DecoderEngine(cfg_of(), mesh=mesh, device="cuda")


def test_shrink_mesh_keeps_the_first_devices():
    mesh = DecodeMesh([torch.device("cpu")] * 8, (2, 4), ("pod", "data"))
    small = shrink_mesh(mesh, (2, 3))
    assert small.axis_names == mesh.axis_names and dict(small.shape) == {"pod": 2, "data": 3}
    for bad, match in (((2,), "has 1 axes"), ((0, 4), "non-positive"), ((2, 5), "only 8")):
        with pytest.raises(ValueError, match=match):
            shrink_mesh(mesh, bad)


# ---------------------------------------------------------------------------
# The pool: groups by mesh content, pins released once
# ---------------------------------------------------------------------------
def test_pool_three_groups_ragged_cadence_bit_exact():
    """One stream through a meshless, a "constraint" and a "shard_map"
    handle at a ragged chunk cadence: three launch groups, each equal to
    the solo decode."""
    n = 512
    y = stream("ccsds", n, 7)
    solo = DecoderEngine(cfg_of(), device="cpu").decode(y, n).numpy()
    want = np.asarray(JEngine(JConfig(spec=j_get_code_spec("ccsds"), backend="ref", **GEO))
                      .decode(jnp.asarray(y), n))
    np.testing.assert_array_equal(solo, want)
    mesh = make_decode_mesh("data=8", devices=CPU8)
    engines = [DecoderEngine(cfg_of(), device="cpu"), DecoderEngine(cfg_of(), mesh=mesh),
               DecoderEngine(cfg_of(), mesh=mesh, shard_dispatch="shard_map")]
    pool = SessionPool()
    handles = [pool.open(e) for e in engines]
    pos, outs = [0] * 3, [[] for _ in handles]
    crng = np.random.default_rng(1)
    while any(p < len(y) for p in pos):
        for i, h in enumerate(handles):
            if pos[i] < len(y):
                step = int(crng.integers(40, 300))
                h.feed(y[pos[i]:pos[i] + step])
                pos[i] += step
        pool.step()
        for i, h in enumerate(handles):
            outs[i].append(h.take())
    assert len({pool._group_key(h._session) for h in handles}) == 3
    for h, o in zip(handles, outs):
        np.testing.assert_array_equal(torch.cat(o + [h.finish(n)]).numpy(), solo)


def test_pool_keys_on_mesh_content_and_lane_binding():
    y = stream("ccsds", 256, 5)
    want = DecoderEngine(cfg_of(), device="cpu").decode(y, 256).numpy()
    eng_a = DecoderEngine(cfg_of(), mesh=make_local_mesh(4, 2, devices=CPU8))
    eng_b = DecoderEngine(cfg_of(), mesh=make_local_mesh(4, 2, devices=CPU8))  # equal content
    eng_m = DecoderEngine(cfg_of(), mesh=eng_a.mesh, block_axes=("model",))
    eng_c = DecoderEngine(cfg_of(), mesh=eng_a.mesh, shard_dispatch="shard_map")
    pool = SessionPool()
    handles = [pool.open(e) for e in (eng_a, eng_b, eng_m, eng_c)]
    assert len(pool._mesh_refs) == 4
    for h in handles:
        h.feed(y)
    pool.step()
    assert pool.launches == 3  # a+b, model, shard_map
    for h in handles:
        np.testing.assert_array_equal(torch.cat([h.take(), h.finish(256)]).numpy(), want)


def test_pool_mesh_pin_released_once_and_survives_id_reuse():
    mesh = make_decode_mesh("data=2", devices=CPU8)
    eng = DecoderEngine(cfg_of(), mesh=mesh)
    pool = SessionPool()
    h1 = pool.open(eng)
    assert len(pool._mesh_refs) == 1
    pool.close(h1)
    pool.close(h1)  # double close: the pin was released, exactly once
    assert len(pool._mesh_refs) == 0
    del h1
    gc.collect()
    handles = [pool.open(eng) for _ in range(4)]
    meshless = pool.open(DecoderEngine(cfg_of(), device="cpu"))
    assert set(pool._mesh_refs) == set(handles)
    assert all(m is mesh for m in pool._mesh_refs.values())
    for h in handles + [meshless]:
        pool.close(h)
    assert len(pool) == 0 and not pool._mesh_refs


def test_pool_open_partial_failure_leaves_no_state():
    eng = DecoderEngine(cfg_of(), mesh=make_decode_mesh("data=2", devices=CPU8))
    pool = SessionPool()

    class ExplodingDict(dict):
        def __setitem__(self, k, v):
            raise RuntimeError("registration failed")

    pool._mesh_refs = ExplodingDict()
    with pytest.raises(RuntimeError, match="registration failed"):
        pool.open(eng)
    assert len(pool) == 0 and len(pool._mesh_refs) == 0


def test_pool_repoint_moves_the_mesh_pins():
    mesh = make_decode_mesh("data=4", devices=CPU8)
    eng, small = DecoderEngine(cfg_of(), mesh=mesh), DecoderEngine(
        cfg_of(), mesh=shrink_mesh(mesh, (3,)))
    meshless = DecoderEngine(cfg_of(), device="cpu")
    pool = SessionPool()
    h = pool.open(eng)
    assert pool.repoint_engine(eng, small) == 1 and pool._mesh_refs[h] is small.mesh
    assert pool.repoint_engine(small, meshless) == 1 and not pool._mesh_refs


def test_cli_pooled_mode_on_a_one_device_mesh(capsys):
    serve_decoder.main(["--device", "cpu", "--backend", "ref", "--d", "64", "--l", "16",
                        "--mesh", "data=1", "--shard-dispatch", "shard_map",
                        "--chunk-bits", "96", "--n-chunks", "3", "--streams", "3",
                        "--ebn0", "6"])
    out = capsys.readouterr().out
    assert "mesh {'data': 1} over 1 device(s) [cpu]" in out
    assert "1 shards, dispatch=shard_map" in out and "batched launches" in out
    assert "BER = " in out
