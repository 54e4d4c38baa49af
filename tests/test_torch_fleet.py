"""The decode fleet across processes, on the CPU over gloo.

Each rank count starts 2 or 3 rank processes once (this file run as a
script, one per rank), each rank with two CPU "devices", so the mesh is
``data=4`` or ``data=6`` over every rank's list. Every rank decodes the
same numpy streams (made from a seed, D = 64, L = 16, q = 8) through the
spanning mesh — ``decode`` at lane counts that leave ragged and
padding-only ranks, ``decode_batch`` of a ragged fleet, a streaming
session, a pooled step of 8 sessions and the ``serve_decoder`` CLI's
pooled mode — and every rank's bits are held against the JAX reference's
meshless ``backend="ref"`` decode, run here in the parent. The ranks also
count their own launches and record the refusals of the service, the
journal, the rescale and the LM's rules.

Every wait has its own limit: the ranks start their group with
``init_process_group(timeout=...)``, and the parent kills every rank still
running at its deadline and fails. The group meets on a file in the test's
own temporary directory, so parallel test workers never collide.
"""

import contextlib
import datetime
import io
import os
import pickle
import subprocess
import sys
import time
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

GEO = dict(D=64, L=16, q=8)
BLOCKS = (2, 3, 7, 11, 2, 3, 7, 11)  # blocks per stream: 2 and 3 leave padding-only ranks
N_BITS = [n * GEO["D"] - 5 for n in BLOCKS]
SEED = 20261018
CLI = dict(streams=4, chunk_bits=128, n_chunks=4, ebn0=2.0, seed=3)
GROUP_TIMEOUT_S = 30  # the ranks' process group: collectives and its start
DEADLINE_S = 90  # the parent's wait for every rank of one spawn


def _stream(n_bits: int, seed: int) -> np.ndarray:
    from repro_torch.core.codespec import get_code_spec
    from repro_torch.core.encoder import encode_np, terminate

    code = get_code_spec("ccsds").code
    rng = np.random.default_rng(seed)
    coded = encode_np(terminate(rng.integers(0, 2, n_bits), code), code)
    return (1.0 - 2.0 * coded + rng.normal(scale=0.8, size=coded.shape)).astype(np.float32)


# ---------------------------------------------------------------------------
# One rank: run as ``python test_torch_fleet.py RANK WORLD DIR``
# ---------------------------------------------------------------------------
def _rank_cases(rank: int, world: int, out: Path) -> dict:
    from repro_torch.core import engine as engine_mod
    from repro_torch.core.codespec import get_code_spec
    from repro_torch.core.engine import DecoderEngine
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.launch import serve_decoder
    from repro_torch.launch.elastic import rescale_decode_engine
    from repro_torch.launch.journal import ChunkJournal
    from repro_torch.launch.mesh import make_decode_mesh, maybe_init_distributed
    from repro_torch.launch.serve_async import AsyncDecodeService
    from repro_torch.launch.serve_decoder import SessionPool
    from repro_torch.sharding.rules import LogicalRules

    data = np.load(out / "inputs.npz")
    ys = [data[f"y{i}"] for i in range(len(BLOCKS))]
    launches = [0]
    plain = engine_mod.pbvd_decode_blocks

    def counted(*args, **kwargs):
        launches[0] += 1
        return plain(*args, **kwargs)

    engine_mod.pbvd_decode_blocks = counted
    res: dict = {}
    # torchrun's environment with the group already up: the start is a no-op
    os.environ.update(MASTER_ADDR="127.0.0.1", WORLD_SIZE=str(world), RANK=str(rank))
    res["init again"] = maybe_init_distributed()
    mesh = make_decode_mesh(f"data={2 * world}", devices=["cpu", "cpu"])
    res["owners"] = mesh.owners.tolist()

    def engine(backend: str = "cuda", dispatch: str = "constraint", m=mesh):
        cfg = PBVDConfig(spec=get_code_spec("ccsds"), backend=backend, **GEO)
        return DecoderEngine(cfg, mesh=m, shard_dispatch=dispatch)

    for backend in ("cuda", "fused"):
        for dispatch in ("constraint", "shard_map"):
            eng = engine(backend, dispatch)
            for i in range(4):
                launches[0] = 0
                bits = eng.decode(ys[i], N_BITS[i])
                res["decode", backend, dispatch, i] = (bits.numpy(), launches[0])
    res["device"] = str(engine().device)

    for dispatch in ("constraint", "shard_map"):
        launches[0] = 0
        bits = engine("cuda", dispatch).decode_batch(ys, N_BITS)
        res["batch", dispatch] = ([b.numpy() for b in bits], launches[0])

    eng = engine()
    sess = eng.session()
    cuts = np.linspace(0, len(ys[3]), 5).astype(int)
    got = [sess.decode(ys[3][lo:hi]) for lo, hi in zip(cuts[:-1], cuts[1:])]
    res["session"] = torch.cat(got + [sess.finish(N_BITS[3])]).numpy()

    pool = SessionPool()
    handles = [pool.open(eng) for _ in ys]
    cut = np.random.default_rng(SEED)
    pos, outs = [0] * len(ys), [[] for _ in ys]
    while any(p < len(y) for p, y in zip(pos, ys)):
        for i, h in enumerate(handles):
            step = int(cut.integers(40, 300))
            h.feed(ys[i][pos[i]: pos[i] + step])
            pos[i] += step
        pool.step()
        for o, h in zip(outs, handles):
            o.append(h.take())
    keys = {pool._group_key(h._session) for h in handles}
    res["pool"] = ([torch.cat(o + [h.finish(n)]).numpy()
                    for o, h, n in zip(outs, handles, N_BITS)], pool.launches,
                   [k[-1] for k in keys])

    # the CLI's pooled mode: record each handle's launches through the pool
    opened, cli_bits = [], {}
    real_open, real_launch = SessionPool.open, SessionPool._launch

    def open_(self, engine, **kw):
        opened.append(real_open(self, engine, **kw))
        return opened[-1]

    def launch_(self, entries, **kw):
        got = real_launch(self, entries, **kw)
        for (ps, _), bits in zip(entries, got):
            cli_bits.setdefault(ps, []).append(bits)
        return got

    SessionPool.open, SessionPool._launch = open_, launch_
    argv = ["--device", "cpu", "--mesh", f"data={world}", "--d", str(GEO["D"]), "--l",
            str(GEO["L"]), "--q", str(GEO["q"]), "--streams", str(CLI["streams"]),
            "--chunk-bits", str(CLI["chunk_bits"]), "--n-chunks", str(CLI["n_chunks"]),
            "--ebn0", str(CLI["ebn0"]), "--seed", str(CLI["seed"])]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_decoder.main(argv)
    SessionPool.open, SessionPool._launch = real_open, real_launch
    res["cli"] = ([torch.cat(cli_bits[h]).numpy() for h in opened], buf.getvalue())

    def refusal(fn) -> str | None:
        try:
            fn()
        except ValueError as exc:
            return str(exc)
        return None

    jdir = out / f"journal-{rank}"
    res["refusals"] = {
        "service": refusal(lambda: AsyncDecodeService().open(eng)),
        "journal": refusal(lambda: AsyncDecodeService(journal=ChunkJournal(jdir)).open(eng)),
        "recover": refusal(lambda: AsyncDecodeService.recover(ChunkJournal(jdir), eng)),
        "rescale": refusal(lambda: rescale_decode_engine(eng, 1)),
        "rules": refusal(lambda: LogicalRules(mesh, {"batch": "data"})),
        # a mesh that leaves the last rank without a device: every rank refuses
        "idle rank": refusal(lambda: engine(m=make_decode_mesh(f"data={world - 1}",
                                                               devices=["cpu"]))),
    }
    return res


def _rank_main(rank: int, world: int, out: Path) -> int:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{out / 'rendezvous'}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        res = _rank_cases(rank, world, out)
    except Exception:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
        return 1
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# The parent
# ---------------------------------------------------------------------------
def _spawn(world: int, out: Path) -> list[dict]:
    """Run ``world`` ranks on ``out``; kill them all and fail at the deadline."""
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(root / "src"), "OMP_NUM_THREADS": "1"}
    logs = [open(out / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world), str(out)],
                              env=env, cwd=root, stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    deadline = time.monotonic() + DEADLINE_S
    try:
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()

    def said(r: int) -> str:
        err = out / f"rank{r}.err"
        return (err.read_text() if err.exists() else "") + (out / f"rank{r}.log").read_text()

    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world} exited {p.returncode}:\n{said(r)}"
    results = []
    for r in range(world):
        with open(out / f"rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def reference():
    """The streams and the JAX reference's meshless ``"ref"`` decodes: of the
    8 ragged streams, and of the CLI's streams (its own seeded transmission)."""
    import jax.numpy as jnp

    from repro.core.codespec import get_code_spec as j_get_code_spec
    from repro.core.engine import DecoderEngine as JEngine
    from repro.core.pbvd import PBVDConfig as JConfig
    from repro_torch.core.codespec import get_code_spec
    from repro_torch.launch.serve_decoder import _make_stream

    ys = [_stream(n, SEED + i) for i, n in enumerate(N_BITS)]
    ref = JEngine(JConfig(spec=j_get_code_spec("ccsds"), backend="ref", **GEO))
    bits = [np.asarray(b) for b in ref.decode_batch([jnp.asarray(y) for y in ys], N_BITS)]
    n_cli = CLI["chunk_bits"] * CLI["n_chunks"]
    cli_ys = [_make_stream(get_code_spec("ccsds"), n_cli, CLI["ebn0"], CLI["seed"] + i,
                           torch.device("cpu"))[1] for i in range(CLI["streams"])]
    cli = [np.asarray(b) for b in ref.decode_batch([jnp.asarray(y) for y in cli_ys],
                                                   [n_cli] * len(cli_ys))]
    return ys, bits, cli


@pytest.fixture(scope="module", params=[2, 3], ids=lambda w: f"{w}ranks")
def fleet(request, reference, tmp_path_factory):
    world = request.param
    out = tmp_path_factory.mktemp(f"fleet{world}")
    ys = reference[0]
    np.savez(out / "inputs.npz", **{f"y{i}": y for i, y in enumerate(ys)})
    return world, _spawn(world, out)


def _lane_widths(n_blocks: int, n_shards: int, dispatch: str) -> list[int]:
    budget = -(-n_blocks // n_shards) * n_shards
    width = budget // n_shards
    if dispatch == "shard_map":
        return [width] * n_shards
    return [max(0, min((i + 1) * width, n_blocks) - i * width) for i in range(n_shards)]


def test_decode_on_every_rank_equals_the_reference(fleet, reference):
    """``decode`` through the spanning mesh: every rank's bits equal the
    reference's, and each rank launched once per lane shard it holds that
    has lanes to decode — none where it holds only padding."""
    world, results = fleet
    _, want, _ = reference
    idle_ranks = 0
    for rank, res in enumerate(results):
        assert res["owners"] == [r for r in range(world) for _ in range(2)]
        assert res["device"] == "cpu" and res["init again"] is False
        for backend in ("cuda", "fused"):
            for dispatch in ("constraint", "shard_map"):
                for i in range(4):
                    bits, n = res["decode", backend, dispatch, i]
                    np.testing.assert_array_equal(bits, want[i])
                    widths = _lane_widths(BLOCKS[i], 2 * world, dispatch)
                    assert n == sum(1 for w in widths[2 * rank: 2 * rank + 2] if w)
                    idle_ranks += dispatch == "constraint" and n == 0
    assert idle_ranks  # some rank held only padding


def test_decode_batch_on_every_rank_equals_the_reference(fleet, reference):
    world, results = fleet
    _, want, _ = reference
    for rank, res in enumerate(results):
        for dispatch in ("constraint", "shard_map"):
            bits, n = res["batch", dispatch]
            for got, w in zip(bits, want):
                np.testing.assert_array_equal(got, w)
            assert n == 2  # one launch on each of the rank's two shards


def test_session_on_every_rank_equals_the_reference(fleet, reference):
    """A solo streaming session fed the same 4 chunks on every rank."""
    _, results = fleet
    _, want, _ = reference
    for res in results:
        np.testing.assert_array_equal(res["session"], want[3])


def test_pooled_step_on_every_rank_equals_the_reference(fleet, reference):
    """8 pooled sessions at a ragged cadence, one group: one pool launch per
    step on every rank, each session's bits equal to the reference's, and
    the group key names each device with its owning rank."""
    world, results = fleet
    _, want, _ = reference
    steps = {res["pool"][1] for res in results}
    assert len(steps) == 1  # every rank launched the same steps
    for res in results:
        bits, _, placements = res["pool"]
        for got, w in zip(bits, want):
            np.testing.assert_array_equal(got, w)
        assert len(placements) == 1
        owners = [d[0] for d in placements[0][2]]
        assert owners == [r for r in range(world) for _ in range(2)]


def test_cli_pooled_mode_on_every_rank_equals_the_reference(fleet, reference):
    world, results = fleet
    _, _, want = reference
    for rank, res in enumerate(results):
        bits, out = res["cli"]
        assert len(bits) == CLI["streams"]
        for got, w in zip(bits, want):
            np.testing.assert_array_equal(got[: len(w)], w)
        assert f"mesh {{'data': {world}}}" in out
        assert f"(this is rank {rank} of {world})" in out
        assert "BER = " in out


def test_spanning_mesh_refusals(fleet):
    world, results = fleet
    for res in results:
        msgs = res["refusals"]
        assert "wall clock" in msgs["service"]
        assert "ChunkJournal" in msgs["journal"] and "process group" in msgs["journal"]
        assert "ChunkJournal" in msgs["recover"]
        assert "rescale_decode_engine" in msgs["rescale"] and "survivors" in msgs["rescale"]
        assert "one process" in msgs["rules"]
        assert f"rank(s) [{world - 1}] hold no position" in msgs["idle rank"]


def test_pool_key_tells_ranks_apart():
    """Two ranks' ``cuda:0`` are two devices: equal indices on different
    ranks never share a group, equal meshes built twice do."""
    from repro_torch.core.codespec import get_code_spec
    from repro_torch.core.pbvd import PBVDConfig
    from repro_torch.launch.mesh import DecodeMesh
    from repro_torch.launch.serve_decoder import SessionPool

    def key(owners):
        mesh = DecodeMesh(["meta"] * 2, (2,), ("data",), owners=owners)
        eng = SimpleNamespace(mesh=mesh, block_axes=("data",), shard_dispatch="constraint")
        cfg = PBVDConfig(spec=get_code_spec("ccsds"), **GEO)
        return SessionPool._group_key(SimpleNamespace(cfg=cfg, _int_dtype=None, engine=eng))

    assert key([0, 1]) == key([0, 1])
    assert key([0, 1]) != key([0, 0]) != key([1, 1])
    assert key([0, 1])[-1][2] == ((0, "meta", None), (1, "meta", None))


def test_cli_starts_the_group_before_the_mesh(monkeypatch):
    """``--mesh`` calls ``maybe_init_distributed`` before it builds the mesh,
    as the reference's CLI does; without ``--mesh`` it is not called."""
    from repro_torch.launch import serve_decoder

    calls = []

    class Stop(Exception):
        pass

    def mesh(*args, **kwargs):
        calls.append("mesh")
        raise Stop

    monkeypatch.setattr(serve_decoder, "maybe_init_distributed",
                        lambda: calls.append("init") or False)
    monkeypatch.setattr(serve_decoder, "make_decode_mesh", mesh)
    with pytest.raises(Stop):
        serve_decoder.main(["--device", "cpu", "--mesh", "data=2"])
    assert calls == ["init", "mesh"]
    calls.clear()
    with contextlib.redirect_stdout(io.StringIO()):
        serve_decoder.main(["--device", "cpu", "--d", "64", "--l", "16", "--chunk-bits", "64",
                            "--n-chunks", "1"])
    assert calls == []


def test_a_lone_process_builds_local_meshes():
    """Without a process group nothing changes: no owners but this process,
    no span, every position local."""
    from repro_torch.launch.mesh import make_decode_mesh, make_local_mesh

    for mesh in (make_decode_mesh("data=4", devices=["cpu"] * 4),
                 make_local_mesh(2, 2, devices=["cpu"] * 4)):
        assert not mesh.spans_processes and mesh.process_count == 1
        assert mesh.is_local.all() and len(mesh.local_devices) == 4
        assert mesh.owners.shape == mesh.devices.shape and not mesh.owners.any()


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3])))
