"""The port's ``SessionPool`` and ``serve_decoder`` CLI against the reference, on the CPU.

Many pooled sessions (engines with ``device="cpu"``, D = 64, L = 16) are fed
numpy streams made from a seed and held bit for bit against the JAX
``backend="ref"`` one-shot decode; the grouping's launch counts, the
quarantine bisection, the flush that survives a failed launch and the CLI's
modes are checked as ``tests/test_batched.py`` and ``tests/test_faults.py``
check the reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.engine import DecoderEngine as JEngine
from repro.core.pbvd import PBVDConfig as JConfig
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.encoder import encode_np, terminate
from repro_torch.core.engine import DecoderEngine, DeviceUnavailableError
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.quantize import quantize_soft
from repro_torch.kernels.registry import backend_preferred_tb_mode
from repro_torch.launch import serve_decoder
from repro_torch.launch.faults import StreamError
from repro_torch.launch.serve_decoder import SessionPool

GEO = dict(D=64, L=16, q=8)
N_BITS = 256


def _stream(name: str, n_bits: int, seed: int) -> np.ndarray:
    spec = get_code_spec(name)
    rng = np.random.default_rng(seed)
    coded = encode_np(terminate(rng.integers(0, 2, n_bits), spec.code), spec.code)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    return (1.0 - 2.0 * tx + rng.normal(scale=0.7, size=tx.shape)).astype(np.float32)


def _engine(name: str = "ccsds", backend: str = "ref", **knobs) -> DecoderEngine:
    return DecoderEngine(PBVDConfig(spec=get_code_spec(name), backend=backend, **GEO, **knobs),
                         device="cpu")


def _want(name: str, y: np.ndarray, n_bits: int = N_BITS) -> np.ndarray:
    ref = JEngine(JConfig(spec=j_get_code_spec(name), backend="ref", **GEO))
    return np.asarray(ref.decode(jnp.asarray(y), n_bits))


def _drain(h, n_bits: int = N_BITS) -> np.ndarray:
    return torch.cat([h.take(), h.finish(n_bits)]).numpy()


def test_pool_mixed_specs_bit_exact():
    """Concurrent sessions over mixed specs and rates, random chunk cadences:
    every stream decodes bit-exact to the reference's one-shot decode."""
    names = ["ccsds", "ccsds-3/4", "ccsds-5/6", "lte-1/3"]
    ys = [_stream(n, 512, 20 + i) for i, n in enumerate(names)]
    pool = SessionPool()
    handles = [pool.open(_engine(n)) for n in names]
    rng = np.random.default_rng(0)
    pos, outs = [0] * len(names), [[] for _ in names]
    while any(p < len(y) for p, y in zip(pos, ys)):
        for i, (y, h) in enumerate(zip(ys, handles)):
            if pos[i] < len(y):
                n = int(rng.integers(1, 180))
                h.feed(y[pos[i] : pos[i] + n])
                pos[i] += n
        pool.step()
        for i, h in enumerate(handles):
            outs[i].append(h.take())
    for i, h in enumerate(handles):
        outs[i].append(h.finish(512))
    for i, name in enumerate(names):
        got = torch.cat(outs[i])
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _want(name, ys[i], 512), err_msg=name)
        assert handles[i].bits_emitted == 512


def test_pool_groups_compatible_sessions_into_one_launch():
    """Sessions sharing (mother code, geometry, backend, dtype, device) share
    a launch, punctured rates of one mother code included; geometry and
    backend split groups."""
    eng_a, eng_b = _engine("ccsds"), _engine("ccsds-3/4")
    ya, yb = _stream("ccsds", N_BITS, 1), _stream("ccsds-3/4", N_BITS, 2)
    pool = SessionPool()
    ha1, ha2, hb = pool.open(eng_a), pool.open(eng_a), pool.open(eng_b)
    for h, y in ((ha1, ya), (ha2, ya), (hb, yb)):
        h.feed(y)
    assert pool.pending_blocks() > 0
    n_blocks = pool.step()
    assert pool.launches == 1
    delivered = sum(h.take().shape[0] // 64 for h in (ha1, ha2, hb))
    assert n_blocks == delivered > 0
    hc = pool.open(DecoderEngine(PBVDConfig(spec=get_code_spec("ccsds"), D=128, L=16, q=8,
                                            backend="ref"), device="cpu"))
    hf = pool.open(_engine("ccsds", backend="fused"))
    for h in (ha1, hc, hf):
        h.feed(ya)
    pool.step()
    assert pool.launches == 4  # D=64 ref, D=128 ref, D=64 fused


def test_pool_groups_on_resolved_tb_mode_and_radix():
    eng_auto = _engine(tb_mode="auto")
    eng_expl = _engine(tb_mode=backend_preferred_tb_mode("ref"))
    eng_r4 = _engine(tb_mode="auto", acs_radix=4)
    eng_mat = [_engine(acs_impl="matrix", acs_radix=r) for r in (2, 4)]
    y = _stream("ccsds", N_BITS, 11)
    pool = SessionPool()
    h_auto, h_expl = pool.open(eng_auto), pool.open(eng_expl)
    h_auto.feed(y)
    h_expl.feed(y)
    pool.step()
    assert pool.launches == 1  # auto resolved == explicit → one group
    h_auto2, h_r4 = pool.open(eng_auto), pool.open(eng_r4)
    h_auto2.feed(y)
    h_r4.feed(y)
    pool.step()
    assert pool.launches == 3  # the radix-4 session launched apart
    h_m = [pool.open(e) for e in eng_mat]
    for h in h_m:
        h.feed(y)
    pool.step()
    assert pool.launches == 4  # matrix ignores the radix: one group
    want = _want("ccsds", y)
    for h in (h_auto, h_expl, h_auto2, h_r4, *h_m):
        np.testing.assert_array_equal(_drain(h), want)


def test_pool_int_and_float_sessions_do_not_mix():
    eng = _engine()
    y = _stream("ccsds", N_BITS, 3)
    yq = quantize_soft(torch.as_tensor(y), 8).numpy()
    pool = SessionPool()
    hf, hi = pool.open(eng), pool.open(eng)
    hf.feed(y)
    hi.feed(yq)
    pool.step()
    assert pool.launches == 2
    np.testing.assert_array_equal(_drain(hf), _want("ccsds", y))
    np.testing.assert_array_equal(_drain(hi), _want("ccsds", yq))


def test_pool_close_and_empty_step():
    pool = SessionPool()
    h = pool.open(_engine())
    assert len(pool) == 1
    assert pool.step() == 0  # nothing buffered: no launch
    assert pool.launches == 0
    assert h.take().shape == (0,) and h.take().dtype == torch.int32
    pool.close(h)
    pool.close(h)  # idempotent
    assert len(pool) == 0


@pytest.mark.parametrize("n_streams,culprits", [(4, {1}), (5, {0, 3}), (1, {0})])
def test_pool_bisection_quarantines_culprits_healthy_bit_exact(n_streams, culprits):
    eng = _engine()
    ys = [_stream("ccsds", N_BITS, 60 + i) for i in range(n_streams)]
    pool = SessionPool()
    handles = [pool.open(eng) for _ in ys]
    marked = {handles[i] for i in culprits}

    def hook(entries, isolating):
        for ps, _ in entries:
            if ps in marked:
                raise StreamError("poisoned lane-group", stream=ps)

    pool.fault_hook = hook
    for h, y in zip(handles, ys):
        h.feed(y)
    pending = pool.pending_blocks()
    with pytest.raises(StreamError):
        pool.step()  # the plain step fails whole — nothing committed
    assert pool.pending_blocks() == pending > 0
    pool.step(isolate=True)
    bad = pool.drain_quarantined()
    assert {ps for ps, _ in bad} == marked
    assert all(isinstance(err, StreamError) for _, err in bad)
    assert len(pool) == n_streams - len(culprits)
    for i, (h, y) in enumerate(zip(handles, ys)):
        if i not in culprits:
            np.testing.assert_array_equal(_drain(h), _want("ccsds", y))
    assert pool.drain_quarantined() == []


def test_pool_quarantine_wraps_a_foreign_launch_error():
    pool = SessionPool()
    h = pool.open(_engine())
    h.feed(_stream("ccsds", N_BITS, 5))

    def hook(entries, isolating):
        raise RuntimeError("device lost")

    pool.fault_hook = hook
    assert pool.step(isolate=True) == 0
    [(ps, err)] = pool.drain_quarantined()
    assert ps is h and isinstance(err, StreamError) and err.stream is h
    assert isinstance(err.__cause__, RuntimeError)


def test_pool_finish_folds_undrained_output_and_survives_a_failed_flush():
    y = _stream("ccsds", 300, 7)
    want = _want("ccsds", y, 300)
    pool = SessionPool()
    h = pool.open(_engine())
    h.feed(y)
    pool.step()  # decodes the ready blocks; their bits wait in the queue
    fail = [True]

    def hook(entries, isolating):
        if fail[0]:
            raise RuntimeError("flush launch failed")

    pool.fault_hook = hook
    with pytest.raises(RuntimeError, match="flush"):
        h.finish(300)
    fail[0] = False
    got = h.finish(300)  # the retry still holds the undrained step() output
    np.testing.assert_array_equal(got.numpy(), want)
    assert h.bits_emitted == 300


def test_pool_repoint_engine():
    """Members on a lost engine move to its replacement (same config) and
    replay their buffered blocks there, bit-exact."""
    eng_a, eng_b = _engine(), _engine()
    y = _stream("ccsds", N_BITS, 9)
    pool = SessionPool()
    h1, h2, h3 = pool.open(eng_a), pool.open(eng_a), pool.open(eng_b)
    for h in (h1, h2, h3):
        h.feed(y[:150])
    pool.step()
    assert pool.repoint_engine(eng_a, eng_b) == 2
    assert pool.repoint_engine(eng_a, eng_b) == 0
    for h in (h1, h2, h3):
        h.feed(y[150:])
    assert all(h._session.engine is eng_b for h in (h1, h2, h3))
    launches = pool.launches
    pool.step()
    assert pool.launches == launches + 1
    want = _want("ccsds", y)
    for h in (h1, h2, h3):
        np.testing.assert_array_equal(_drain(h), want)


@pytest.mark.parametrize("streams", [1, 3])
def test_cli_single_and_pooled_modes(capsys, streams):
    serve_decoder.main(["--device", "cpu", "--backend", "ref", "--d", "64", "--l", "16",
                        "--code", "ccsds-3/4", "--chunk-bits", "96", "--n-chunks", "3",
                        "--streams", str(streams), "--ebn0", "6"])
    out = capsys.readouterr().out
    assert "ccsds-3/4 on CPU" in out and "BER = " in out
    assert ("batched launches" in out) == (streams > 1)


def test_cli_default_device_refuses_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError, match="serve_decoder"):
        serve_decoder.main(["--d", "64", "--l", "16", "--n-chunks", "1"])
