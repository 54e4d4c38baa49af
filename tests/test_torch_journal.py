"""The port's chunk journal, crash recovery and integrity sentinel against the
reference's, on the CPU.

The journal's bytes must equal the reference's for the same records, and
each package must read the other's log and checkpoint; a journaled trace of
port engines (``device="cpu"``, ``backend="ref"``, D = 64, L = 16) abandoned
at every dispatch boundary must recover to deliver the JAX ``backend="ref"``
one-shot bits exactly once, with no page leaked; a journal written by the
reference's service must recover under the port's and the reverse; the
sentinel must flag the same spans as the reference's. Then the CLI's async
and durable modes run on ``--device cpu`` in subprocesses, the durable one
killed by SIGKILL and recovered. Mirrors ``tests/test_journal.py``.
"""

import asyncio
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch.journal import ChunkJournal as JJournal
from repro.launch.journal import IntegritySentinel as JSentinel
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.encoder import encode_np
from repro_torch.launch.faults import FaultInjector, IntegrityError
from repro_torch.launch.journal import ChunkJournal, IntegritySentinel
from repro_torch.launch.serve_async import AsyncDecodeService
from repro_torch.launch.slab import SymbolSlab

from test_torch_serve_async import (
    MODS,
    PORT,
    REF,
    T_PAGE,
    FakeClock,
    bits_of,
    chunks_of,
    engine,
    engine_of,
    stream,
    want,
)

JOURNALS = {PORT: ChunkJournal, REF: JJournal}
SRC = Path(__file__).resolve().parents[1] / "src"


# ---------------------------------------------------------------------------
# ChunkJournal mechanics
# ---------------------------------------------------------------------------
def _write_records(j) -> None:
    j.append("open", 0)
    j.append("admit", 0, np.arange(12, dtype=np.float32).reshape(6, 2))
    j.append("admit", 0, np.arange(-5, 5, dtype=np.int8))
    j.append("ack", 0, 64)
    j.append("commit", 3)
    j.append("fail", 0, "poisoned")
    j.append("finish", 0)


def test_journal_bytes_equal_the_reference_and_cross_read(tmp_path):
    port, ref = ChunkJournal(tmp_path / "p"), JJournal(tmp_path / "r")
    _write_records(port)
    _write_records(ref)
    port.close()
    ref.close()
    assert Path(port.log_path).read_bytes() == Path(ref.log_path).read_bytes()
    for reader in (ChunkJournal(tmp_path / "r"), JJournal(tmp_path / "p")):
        recs = reader.records()
        assert [r[:2] for r in recs] == [(i + 1, k) for i, k in enumerate(
            ["open", "admit", "admit", "ack", "commit", "fail", "finish"])]
        np.testing.assert_array_equal(recs[2][3], np.arange(-5, 5, dtype=np.int8))
        assert reader.append("open", 1) == 8  # seq continues past the other's log
        reader.close()


@pytest.mark.parametrize("writer", [PORT, REF])
def test_torn_tail_and_crc_frontier(tmp_path, writer):
    """A half-written record ends the log; a corrupt one ends it at the
    frontier, even with intact records behind it. Both readers agree."""
    j = JOURNALS[writer](tmp_path)
    j.append("open", 0)
    mid = os.path.getsize(j.log_path)
    j.append("ack", 0, 128)
    j.append("finish", 0)
    j.close()
    with open(j.log_path, "ab") as f:  # SIGKILL mid-write: half a record
        f.write(b"\x40\x00\x00\x00\x99\x99")
    for reader in (ChunkJournal, JJournal):
        assert [r[1] for r in reader(tmp_path).records()] == ["open", "ack", "finish"]
    j2 = ChunkJournal(tmp_path)
    assert j2.append("commit", 1) == 4
    j2.close()
    with open(j.log_path, "r+b") as f:  # flip one payload byte of record 2
        f.seek(mid + 8)
        b = f.read(1)
        f.seek(mid + 8)
        f.write(bytes([b[0] ^ 0xFF]))
    for reader in (ChunkJournal, JJournal):
        assert [r[1] for r in reader(tmp_path).records()] == ["open"]


def test_checkpoint_is_atomic_compacts_the_log_and_crosses(tmp_path):
    j = ChunkJournal(tmp_path)
    for sid in range(4):
        j.append("open", sid)
    j.write_checkpoint({"dispatches": 7, "streams": {}})
    assert os.path.getsize(j.log_path) == 0
    j.append("open", 99)
    for reader in (ChunkJournal, JJournal):
        ckpt, pending = reader(tmp_path).load()
        assert (ckpt["dispatches"], ckpt["last_seq"]) == (7, 4)
        assert [r[1:] for r in pending] == [("open", 99)]
    with open(j.ckpt_path + ".tmp", "wb") as f:  # never promoted
        f.write(b"garbage that never got renamed")
    assert ChunkJournal(tmp_path).load_checkpoint()["dispatches"] == 7
    with open(j.ckpt_path, "r+b") as f:
        f.truncate(5)
    assert ChunkJournal(tmp_path).load_checkpoint() is None
    j.close()


# ---------------------------------------------------------------------------
# Crash → recover
# ---------------------------------------------------------------------------
def _crash_half(side: str, chunk_lists, kill_at: int, jdir, *, n_bits: int, metric_mode="f32"):
    """A journaled manual-poll trace abandoned after its ``kill_at``-th
    dispatch (0 = before any). The client acks what it takes after every
    dispatch except the last before the crash (those bits die with it).
    Returns each stream's durably held bits."""
    f_mod, s_mod, sl_mod = MODS[side]
    eng = engine_of(side, metric_mode=metric_mode)

    async def run():
        svc = s_mod.AsyncDecodeService(
            max_batch_blocks=1000, deadline_ms=0.0, checkpoint_every=2,
            slab=sl_mod.SymbolSlab(n_pages=8 * len(chunk_lists), page_stages=T_PAGE, R=2),
            journal=JOURNALS[side](jdir))
        streams = [svc.open(eng) for _ in chunk_lists]
        durable = [[] for _ in chunk_lists]
        fired = 0
        for k in range(len(chunk_lists[0])):
            if fired >= kill_at:
                return durable  # "SIGKILL": nothing closed, nothing flushed
            for st, chunks in zip(streams, chunk_lists):
                await st.send(chunks[k])
            if svc.poll():
                fired += 1
                for i, st in enumerate(streams):
                    got = bits_of(st.take(ack=False))
                    if fired >= kill_at:
                        continue  # taken but never acked
                    durable[i].append(got)
                    st.ack()
        return durable

    return asyncio.run(run())


def _recover_half(side: str, chunk_lists, durable, jdir, *, n_bits: int, metric_mode="f32"):
    f_mod, s_mod, sl_mod = MODS[side]
    sl = sl_mod.SymbolSlab(n_pages=8 * len(chunk_lists), page_stages=T_PAGE, R=2)

    async def run():
        svc = s_mod.AsyncDecodeService.recover(
            JOURNALS[side](jdir), engine_of(side, metric_mode=metric_mode), slab=sl,
            max_batch_blocks=1000, deadline_ms=0.0)
        outs = []
        for i, chunks in enumerate(chunk_lists):
            st = svc.recovered_streams[i]
            assert st.acked_bits == sum(len(d) for d in durable[i])
            for k in range(st.chunks_admitted, len(chunks)):
                await st.send(chunks[k])
                svc.poll()
            tail = [bits_of(st.take()), bits_of(await st.finish(n_bits))]
            outs.append(np.concatenate([*durable[i], *tail]))
        return outs

    return asyncio.run(run()), sl


@pytest.mark.parametrize("kill_at", range(0, 5))
def test_kill_point_matrix_recovers_exactly_once(tmp_path, kill_at):
    n_bits, n_chunks = 512, 4
    ys = [stream("ccsds", n_bits, 40 + i) for i in range(3)]
    chunk_lists = [chunks_of(y, n_chunks) for y in ys]
    durable = _crash_half(PORT, chunk_lists, kill_at, tmp_path, n_bits=n_bits)
    outs, sl = _recover_half(PORT, chunk_lists, durable, tmp_path, n_bits=n_bits)
    for got, ref in zip(outs, want(ys, n_bits)):
        assert len(got) == n_bits  # exactly once: no duplicate, no gap
        np.testing.assert_array_equal(got, ref)
    assert sl.pages_in_use == 0


@pytest.mark.parametrize("writer,reader,kill_at,metric_mode",
                         [(REF, PORT, 2, "f32"), (PORT, REF, 3, "f32"), (REF, PORT, 3, "i8")])
def test_a_journal_recovers_under_the_other_package(tmp_path, writer, reader, kill_at,
                                                    metric_mode):
    n_bits, n_chunks = 512, 4
    ys = [stream("ccsds", n_bits, 60 + i) for i in range(2)]
    chunk_lists = [chunks_of(y, n_chunks) for y in ys]
    durable = _crash_half(writer, chunk_lists, kill_at, tmp_path, n_bits=n_bits,
                          metric_mode=metric_mode)
    outs, sl = _recover_half(reader, chunk_lists, durable, tmp_path, n_bits=n_bits,
                             metric_mode=metric_mode)
    for got, ref in zip(outs, want(ys, n_bits, metric_mode=metric_mode)):
        assert len(got) == n_bits
        np.testing.assert_array_equal(got, ref)
    assert sl.pages_in_use == 0


def test_recovery_after_a_torn_tail_and_after_a_clean_finish(tmp_path):
    y = stream("ccsds", 512, 55)
    chunks = chunks_of(y, 4)

    async def crash():
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0, checkpoint_every=None,
                                 slab=SymbolSlab(8, T_PAGE, 2), journal=ChunkJournal(tmp_path))
        st = svc.open(engine())
        for c in chunks[:3]:
            await st.send(c)
        svc.poll()

    asyncio.run(crash())
    with open(os.path.join(tmp_path, "journal.log"), "ab") as f:
        f.write(b"\xff" * 7)  # the torn half-record a SIGKILL leaves

    async def resume():
        sl = SymbolSlab(8, T_PAGE, 2)
        svc = AsyncDecodeService.recover(ChunkJournal(tmp_path), engine(), slab=sl,
                                         max_batch_blocks=1000, deadline_ms=0.0)
        st = svc.recovered_streams[0]
        assert st.chunks_admitted == 3
        for c in chunks[3:]:
            await st.send(c)
            svc.poll()
        bits = torch.cat([st.take(), await st.finish(512)])
        assert sl.pages_in_use == 0
        return bits

    np.testing.assert_array_equal(bits_of(asyncio.run(resume())), want([y], 512)[0])
    j = ChunkJournal(tmp_path)  # every stream finished: nothing to replay
    assert j.load()[1] == []
    svc = AsyncDecodeService.recover(j, engine(), slab=SymbolSlab(8, T_PAGE, 2))
    assert svc.recovered_streams == {} and svc._streams == []


# ---------------------------------------------------------------------------
# Integrity sentinel
# ---------------------------------------------------------------------------
def test_sentinel_flags_the_same_spans_as_the_reference():
    """Clean, flipped, erased and short spans at several SNRs: the same
    verdicts, agreements and counters, and the same sampling draws."""
    code = get_code_spec("ccsds").code
    rng = np.random.default_rng(7)
    port, ref = IntegritySentinel(min_agreement=0.95), JSentinel(min_agreement=0.95)
    for trial in range(40):
        n = int(rng.integers(1, 200))
        bits = rng.integers(0, 2, n)
        state = int(rng.integers(0, code.n_states))
        coded = encode_np(bits, code, state)
        window = (1.0 - 2.0 * coded + rng.normal(scale=float(rng.uniform(0.1, 0.9)),
                                                   size=coded.shape)).astype(np.float32)
        if trial % 5 == 1:
            window[rng.random(window.shape) < 0.3] = 0.0  # erasures
        if trial % 4 == 2:
            window = window[: n // 2]  # a flush past the buffered tail
        sent = bits.copy()
        if trial % 2:
            sent[int(rng.integers(0, n))] ^= 1
        got, exp = port.check(sent, window, code, state), ref.check(sent, window, code, state)
        assert (got is None) == (exp is None)
        if got is not None:
            assert isinstance(got, IntegrityError)
            assert (got.agreement, got.bound, str(got)) == (exp.agreement, exp.bound, str(exp))
    assert (port.checked, port.flagged) == (ref.checked, ref.flagged) and port.flagged > 0
    p, r = IntegritySentinel(rate=0.3, seed=4), JSentinel(rate=0.3, seed=4)
    assert [p.sample() for _ in range(100)] == [r.sample() for _ in range(100)]
    with pytest.raises(ValueError, match="rate"):
        IntegritySentinel(rate=1.5)


def test_sentinel_quarantines_one_corrupted_stream():
    """A post-kernel bit flip on stream A is flagged by the re-encode screen
    and fails A with IntegrityError; B, in the same dispatches, is bit-exact."""
    ya, yb = stream("ccsds", 512, 80, 8.0), stream("ccsds", 512, 81, 8.0)
    inj = FaultInjector(schedule={"decode_corrupt": {0}})

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0,
                                 slab=SymbolSlab(16, T_PAGE, 2), fault_injector=inj,
                                 integrity_rate=1.0, integrity_min_agreement=0.95)
        a, b = svc.open(engine()), svc.open(engine())
        ca, cb = chunks_of(ya, 8), chunks_of(yb, 8)
        for k in range(2):
            await a.send(ca[k])
            await b.send(cb[k])
        svc.poll()  # the first delivery: decode_corrupt consultation 0 hits A
        with pytest.raises(IntegrityError, match="integrity sentinel"):
            a.take()
        for c in cb[2:]:
            await b.send(c)
            svc.poll()
        return torch.cat([b.take(), await b.finish(512)]), svc.metrics()

    out_b, m = asyncio.run(scenario())
    np.testing.assert_array_equal(bits_of(out_b), want([yb], 512)[0])
    assert (m["integrity_flagged"], m["quarantined_streams"]) == (1, 1)
    assert m["integrity_checked"] >= 2
    assert m["errors_by_class"]["IntegrityError"] == 1
    assert m["faults_injected"] == {"decode_corrupt": 1}


def test_metrics_returns_a_deep_copy():
    y = stream("ccsds", 256, 90)
    clk = FakeClock()

    async def scenario():
        svc = AsyncDecodeService(max_batch_blocks=1000, deadline_ms=0.0, clock=clk.now,
                                 fault_injector=FaultInjector(schedule={"dispatch": {0}}))
        st = svc.open(engine())
        await st.send(y)
        assert svc.poll() is True and svc.poll() is False
        clk.advance(60.0)
        assert svc.poll() is True
        m = svc.metrics()
        m["errors_by_class"]["DispatchError"] = 999
        m["faults_injected"]["dispatch"] = 999
        m2 = svc.metrics()
        assert (m2["errors_by_class"], m2["faults_injected"], m2["retries"]) == (
            {"DispatchError": 1}, {"dispatch": 1}, 1)
        return torch.cat([st.take(), await st.finish(256)])

    np.testing.assert_array_equal(bits_of(asyncio.run(scenario())), want([y])[0])


# ---------------------------------------------------------------------------
# The CLI's async and durable modes, each in its own process
# ---------------------------------------------------------------------------
CLI = [sys.executable, "-m", "repro_torch.launch.serve_decoder", "--device", "cpu",
       "--backend", "ref", "--d", "64", "--l", "16", "--serve-async"]


def _cli(args, cwd):
    env = dict(os.environ, PYTHONPATH=str(SRC))
    return subprocess.run(CLI + args, capture_output=True, text=True, cwd=cwd, env=env,
                          timeout=120)


def test_cli_async_mode(tmp_path):
    r = _cli(["--streams", "6", "--chunk-bits", "128", "--n-chunks", "4",
              "--rate-chunks-per-s", "400", "--ebn0", "6"], tmp_path)
    assert r.returncode == 0, r.stderr
    assert "async: 6 streams" in r.stdout and "BER = " in r.stdout


def test_cli_durable_kill_and_recover(tmp_path):
    """--kill-at 3 dies by SIGKILL mid-trace; --recover resumes from the
    journal and exits 0 with every stream's delivered file bit-exact to the
    one-shot decode and no duplicate bit."""
    args = ["--journal-dir", str(tmp_path / "j"), "--streams", "3", "--chunk-bits", "128",
            "--n-chunks", "6", "--rate-chunks-per-s", "100", "--integrity-rate", "1.0"]
    killed = _cli(args + ["--kill-at", "3"], tmp_path)
    assert killed.returncode == -signal.SIGKILL, killed.stdout + killed.stderr
    recovered = _cli(args + ["--recover"], tmp_path)
    assert recovered.returncode == 0, recovered.stdout + recovered.stderr
    assert "all streams bit-exact" in recovered.stdout
    for i in range(3):  # exactly once: each file holds the whole payload
        assert (tmp_path / "j" / f"delivered-{i}.bits").stat().st_size == 128 * 6
