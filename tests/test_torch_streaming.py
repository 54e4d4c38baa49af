"""Streaming sessions of the port against the JAX reference, on the CPU.

The port's ``DecoderSession`` (engines with ``device="cpu"``, ``backend="ref"``,
D = 64, L = 16) is fed numpy streams made from a seed in chunks and held bit
for bit against the one-shot decode of the JAX ``backend="ref"`` engine and of
the port itself: random partitions, one row at a time, punctured phases cut
mid-period, pre-quantized chunks, the refusals that leave the session as it
was, the flush of a partial block, radix 4 in i8 and matrix with the prefix
walk, and snapshots that cross between the two packages. Mirrors
``tests/test_engine.py``'s streaming tests and ``tests/test_property.py``'s
partition fuzz (a seeded set of partitions in place of hypothesis).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.engine import ArraySessionStore as JStore
from repro.core.engine import DecoderEngine as JEngine
from repro.core.pbvd import PBVDConfig as JConfig
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.encoder import encode_np, terminate
from repro_torch.core.engine import ArraySessionStore, DecoderEngine
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.quantize import quantize_soft
from repro_torch.launch.faults import SymbolError

GEO = dict(D=64, L=16, q=8, backend="ref")
N_BITS = 640  # most tests share this length, so the reference compiles once per spec


def _stream(name: str, n_bits: int, seed: int, sigma: float = 0.7) -> np.ndarray:
    """BPSK of the encoded payload plus noise, in the wire format of the spec
    (1-D punctured symbols for punctured specs), float32."""
    spec = get_code_spec(name)
    rng = np.random.default_rng(seed)
    coded = encode_np(terminate(rng.integers(0, 2, n_bits), spec.code), spec.code)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    return (1.0 - 2.0 * tx + rng.normal(scale=sigma, size=tx.shape)).astype(np.float32)


def _engines(name: str, **knobs):
    port = DecoderEngine(PBVDConfig(spec=get_code_spec(name), **{**GEO, **knobs}), device="cpu")
    ref = JEngine(JConfig(spec=j_get_code_spec(name), **{**GEO, **knobs}))
    return port, ref


def _want(ref: JEngine, y: np.ndarray, n_bits: int | None) -> np.ndarray:
    return np.asarray(ref.decode(jnp.asarray(y), n_bits))


def _stream_through(sess, parts, n_bits) -> np.ndarray:
    outs = [sess.decode(c) for c in parts]
    outs.append(sess.finish(n_bits))
    assert all(o.dtype == torch.int32 and o.device.type == "cpu" for o in outs)
    return torch.cat(outs).numpy()


def _random_parts(y: np.ndarray, n_parts: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(1, len(y)), n_parts - 1, replace=False))
    return np.split(y, cuts)


@pytest.mark.parametrize("name", ["ccsds", "ccsds-3/4"])
def test_streaming_100_chunks_matches_one_shot(name):
    y = _stream(name, N_BITS, seed=4)
    port, ref = _engines(name)
    want = _want(ref, y, N_BITS)
    assert np.array_equal(port.decode(y, N_BITS).numpy(), want)
    sess = port.session()
    parts = _random_parts(y, 100, seed=0)
    # every other chunk arrives as a tensor (float64 numpy and tensors alike)
    outs = [sess.decode(torch.as_tensor(c) if i % 2 else c.astype(np.float64))
            for i, c in enumerate(parts)]
    assert sum(o.shape[0] for o in outs) > 0  # bits were emitted before the flush
    outs.append(sess.finish(N_BITS))
    np.testing.assert_array_equal(torch.cat(outs).numpy(), want)
    assert sess.bits_emitted == N_BITS


def test_streaming_one_row_at_a_time_and_empty_chunk():
    y = _stream("ccsds", N_BITS, seed=6)
    port, ref = _engines("ccsds")
    sess = port.session()
    parts = [y[i : i + 1] for i in range(len(y))] + [y[:0]]  # the empty chunk is a no-op
    np.testing.assert_array_equal(_stream_through(sess, parts, N_BITS), _want(ref, y, N_BITS))


def test_streaming_punctured_phase_carries_across_misaligned_chunks():
    y = _stream("ccsds-5/6", N_BITS, seed=7)
    port, ref = _engines("ccsds-5/6")
    sizes, parts, i = [1, 2, 3, 5, 7, 11, 13], [], 0
    while i < len(y):
        n = sizes[len(parts) % len(sizes)]
        parts.append(y[i : i + n])
        i += n
    np.testing.assert_array_equal(_stream_through(port.session(), parts, N_BITS),
                                  _want(ref, y, N_BITS))


def test_streaming_prequantized_int8_chunks_and_mixed_refusal():
    y = _stream("ccsds", N_BITS, seed=9)
    port, ref = _engines("ccsds")
    yq = quantize_soft(torch.as_tensor(y), 8).numpy()
    assert yq.dtype == np.int8
    sess = port.session()
    got = _stream_through(sess, [torch.as_tensor(c) for c in np.array_split(yq, 7)], N_BITS)
    np.testing.assert_array_equal(got, _want(ref, yq, N_BITS))
    # a float chunk in an integer session, and the reverse, are refused
    with pytest.raises(SymbolError, match="cannot mix") as info:
        sess.decode(np.zeros((4, 2), np.float32))
    assert isinstance(info.value, ValueError)
    fsess = port.session()
    fsess.decode(y[:10])
    with pytest.raises(SymbolError, match="cannot mix"):
        fsess.decode(yq[10:20])


def test_streaming_punctured_refuses_full_rate_chunks():
    sess, _ = _engines("ccsds-3/4")
    with pytest.raises(SymbolError, match="1-D punctured"):
        sess.session().decode(np.zeros((8, 2), np.float32))


def test_streaming_nonfinite_chunk_refused_state_unchanged():
    y = _stream("ccsds", N_BITS, seed=10)
    port, ref = _engines("ccsds")
    sess = port.session()
    out = [sess.decode(y[:200])]
    before = sess.snapshot()
    bad = y[200:260].copy()
    bad[3, 1] = np.inf
    with pytest.raises(SymbolError, match="non-finite"):
        sess.decode(bad)
    after = sess.snapshot()
    assert {k: v for k, v in after.items() if k != "store"} == {
        k: v for k, v in before.items() if k != "store"}
    np.testing.assert_array_equal(after["store"]["rows"], before["store"]["rows"])
    out += [sess.decode(y[200:]), sess.finish(N_BITS)]
    np.testing.assert_array_equal(torch.cat(out).numpy(), _want(ref, y, N_BITS))


@pytest.mark.parametrize("n_bits,n_stream", [(150, 150), (10, 10), (600, N_BITS)])
def test_streaming_finish_partial_block_and_short_stream(n_bits, n_stream):
    """n_bits not a multiple of D, a stream shorter than L, and n_bits below
    the stages received."""
    y = _stream("ccsds", n_stream, seed=n_bits)
    port, ref = _engines("ccsds")
    got = _stream_through(port.session(), np.array_split(y, 3), n_bits)
    np.testing.assert_array_equal(got, _want(ref, y, n_bits))
    sess = port.session()  # the default flush length: the stages received
    np.testing.assert_array_equal(_stream_through(sess, [y], None), _want(ref, y, None))


@pytest.mark.parametrize(
    "knobs",
    [dict(metric_mode="i8", acs_radix=4), dict(acs_impl="matrix", acs_k=2, tb_mode="prefix")],
    ids=["i8-radix4", "matrix-k2-prefix"],
)
def test_streaming_knobs_match_reference(knobs):
    y = _stream("ccsds", N_BITS, seed=11)
    port, ref = _engines("ccsds", **knobs)
    got = _stream_through(port.session(), _random_parts(y, 9, seed=1), N_BITS)
    np.testing.assert_array_equal(got, _want(ref, y, N_BITS))


def test_streaming_seeded_partitions_across_specs():
    """About twenty seeded partitions (chunk counts 1 … 40, including empty
    chunks) over five specs, each equal to the one-shot decode."""
    rng = np.random.default_rng(2026)
    for name in ("ccsds", "ccsds-2/3", "ccsds-3/4", "ccsds-5/6", "lte-1/3"):
        n_bits = 150
        y = _stream(name, n_bits, seed=len(name))
        port, ref = _engines(name)
        want = _want(ref, y, n_bits)
        for trial in range(4):
            n_parts = int(rng.integers(1, 41))
            cuts = np.sort(rng.integers(0, len(y) + 1, n_parts - 1))
            parts = np.split(y, cuts)
            got = _stream_through(port.session(), parts, n_bits)
            np.testing.assert_array_equal(got, want, err_msg=f"{name} trial {trial}")


@pytest.mark.parametrize("direction", ["port-port", "repro-port", "port-repro"])
@pytest.mark.parametrize("name,prequantized", [("ccsds", False), ("ccsds-3/4", False),
                                               ("ccsds", True)])
def test_snapshot_restore_mid_stream(direction, name, prequantized):
    y = _stream(name, N_BITS, seed=13)
    if prequantized:
        y = quantize_soft(torch.as_tensor(y), 8).numpy()
    port, ref = _engines(name)
    want = _want(ref, y, N_BITS)
    parts = _random_parts(y, 6, seed=2)
    first = ref.session() if direction == "repro-port" else port.session()
    head = [np.asarray(first.decode(c)) for c in parts[:3]]
    snap = first.snapshot()
    second = ref.session() if direction == "port-repro" else port.session()
    second.restore(snap)
    tail = [np.asarray(second.decode(c)) for c in parts[3:]]
    tail.append(np.asarray(second.finish(N_BITS)))
    np.testing.assert_array_equal(np.concatenate(head + tail), want)
    assert second.bits_emitted == N_BITS


def test_array_session_store_contract():
    for Store in (ArraySessionStore, JStore):  # the port's and the reference's
        s = Store(2)
        assert len(s) == 0
        s.append(np.arange(10, dtype=np.int64).reshape(5, 2))
        s.grow(3)
        s.grow(0)
        assert len(s) == 8
        s.scatter(np.array([5, 7]), np.array([1, 0]), np.array([9.5, -1.0]))
        np.testing.assert_array_equal(s.read(4, 10), [[8, 9], [0, 9.5], [0, 0], [-1, 0]])
        assert s.read(0, 2).dtype == np.float32
        s.drop_prefix(3)
        s.drop_prefix(0)
        snap = s.snapshot()
        assert len(s) == 5 and snap["rows"].shape == (5, 2)
        fresh = Store(2)
        fresh.restore(snap)
        np.testing.assert_array_equal(fresh.read(0, 5), s.read(0, 5))
        snap["rows"][0, 0] = 99.0  # a snapshot is a copy
        assert fresh.read(0, 1)[0, 0] == 6.0
        with pytest.raises(ValueError, match="not empty"):
            fresh.restore(snap)
        s.close()
        s.close()
        assert len(s) == 0
    # the snapshots themselves are interchangeable
    a, b = ArraySessionStore(3), JStore(3)
    rows = np.random.default_rng(0).normal(size=(4, 3))
    a.append(rows)
    b.append(rows)
    np.testing.assert_array_equal(a.snapshot()["rows"], b.snapshot()["rows"])
