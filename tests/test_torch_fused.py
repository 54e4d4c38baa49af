"""The port's fused single-kernel decoder against the JAX reference, on the CPU.

``pbvd_fused`` runs its plain version here (a CPU tensor takes the plain
version, and only that): packed words equal to the JAX Pallas fused kernel
in interpret mode at radix 2, and to the JAX reference ACS + serial walk at
radix 4 (the JAX fused radix-4 kernel does not run on this JAX). The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``. Also here: the kernel's shared-memory plan, the build
digest over shared headers, the engine's one fused call per batch, and the
config interop of ``acs_radix`` and ``backend``.
"""

import shutil
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.pbvd import PBVDConfig as JConfig
from repro.kernels import ref as j_ref
from repro.kernels.fused import pbvd_fused_pallas
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.interop import config_fields, convert_config
from repro_torch.kernels import _build, acs, fused, ref, traceback

CCSDS, J_CCSDS = get_code_spec("ccsds").code, j_get_code_spec("ccsds").code
IS95, J_IS95 = get_code_spec("is95-k9").code, j_get_code_spec("is95-k9").code


def _pack_np(bits: np.ndarray) -> np.ndarray:
    """(n, B) {0,1} → (n/32, B) int32 words, bit b & 31 of word b >> 5."""
    w = (bits.astype(np.int64).reshape(-1, 32, bits.shape[1]) << np.arange(32)[None, :, None])
    w = w.sum(axis=1)
    return np.where(w >= 1 << 31, w - (1 << 32), w).astype(np.int32)


@pytest.mark.parametrize(
    "kind,mode,T,decode_start,n_decode,start",
    [("float32", "f32", 64, 16, 32, "zero"),
     ("int8", "f32", 96, 20, 64, "random"),
     ("int8", "i8", 90, 8, 96, "zero")],  # i8: clip; 96 > T - decode_start: top bits 0
)
def test_fused_plain_equals_pallas_interpret(kind, mode, T, decode_start, n_decode, start):
    rng = np.random.default_rng(T)
    B = 100  # the port masks the ragged lane edge; the Pallas kernel needs 128
    if kind == "float32":
        y = (rng.normal(size=(T, 2, B)) * 2.0).astype(np.float32)
    else:
        y = rng.integers(-127, 128, (T, 2, B)).astype(np.int8)
    st = (rng.integers(0, 64, B).astype(np.int32) if start == "random"
          else np.zeros(B, np.int32))
    pad = ((0, 0), (0, 0), (0, 128 - B))
    want = pbvd_fused_pallas(jnp.asarray(np.pad(y, pad)), J_CCSDS, decode_start=decode_start,
                             n_decode=n_decode, start_state=jnp.asarray(np.pad(st, (0, 128 - B))),
                             interpret=True, metric_mode=mode)
    fused.launches = 0
    got = fused.pbvd_fused(torch.as_tensor(y), CCSDS, decode_start=decode_start,
                           n_decode=n_decode, start_state=torch.as_tensor(st), metric_mode=mode)
    assert got.dtype == torch.int32 and got.shape == (n_decode // 32, B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :B])
    assert fused.launches == 0


@pytest.mark.parametrize("mode", ["f32", "i16", "i8"])
@pytest.mark.parametrize("name,T", [("ccsds", 77), ("is95-k9", 64)])
def test_fused_plain_radix4_equals_reference_walk(name, T, mode):
    code, jcode = {"ccsds": (CCSDS, J_CCSDS), "is95-k9": (IS95, J_IS95)}[name]
    rng = np.random.default_rng(T)
    y = rng.integers(-127, 128, (T, 2, 9)).astype(np.int8)
    st = rng.integers(0, code.n_states, 9).astype(np.int32)
    sp_j, _ = j_ref.acs_forward_ref(jnp.asarray(y), jcode, metric_mode=mode, radix=4)
    n_window = min(64, T - 10)  # is95-k9: 64 bits overhang T, the top ones stay 0
    bits_j = np.asarray(j_ref.traceback_ref(sp_j, jcode, 10, n_window, jnp.asarray(st)))
    bits_j = np.pad(bits_j, ((0, 64 - n_window), (0, 0)))
    got = fused.pbvd_fused(torch.as_tensor(y), code, decode_start=10, n_decode=64,
                           start_state=torch.as_tensor(st), metric_mode=mode, radix=4)
    np.testing.assert_array_equal(got.numpy(), _pack_np(bits_j))
    # by contract radix 4 decodes what radix 2 does
    r2 = fused.pbvd_fused(torch.as_tensor(y), code, decode_start=10, n_decode=64,
                          start_state=torch.as_tensor(st), metric_mode=mode)
    assert torch.equal(got, r2)


def test_fused_plain_is_reference_function_and_checks_arguments():
    assert fused.pbvd_fused_plain is ref.pbvd_fused_ref
    y = torch.zeros((20, 2, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="multiple of 32"):
        fused.pbvd_fused(y, CCSDS, decode_start=2, n_decode=20)
    with pytest.raises(ValueError, match="decode_start"):
        fused.pbvd_fused(y, CCSDS, decode_start=20, n_decode=32)
    with pytest.raises(ValueError, match="CPU or CUDA"):  # meta has the counter's branch
        fused.pbvd_fused(types.SimpleNamespace(device=torch.device("xpu")), CCSDS,
                         decode_start=2, n_decode=32)
    meta = fused.pbvd_fused(torch.empty((20, 2, 3), dtype=torch.int8, device="meta"), CCSDS,
                            decode_start=2, n_decode=32)
    assert meta.device.type == "meta" and meta.shape == (1, 3)


def test_smem_plan():
    # CCSDS at the main path: two blocks per CTA; two metric planes, two
    # min slots per block and 596 · 2 survivor words per block, 4 B each
    assert fused.smem_plan(596, 64) == (2, 4 * (2 * 2 * 64 + 2 * 2 + 2 * 596 * 2))
    assert fused.smem_plan(596, 256)[0] == 1  # K = 9: 19,072 B of history
    G, nbytes = fused.smem_plan(4096 + 2 * 64, 256)  # K = 9, D = 4096, L = 64
    assert G == 1 and 48 * 1024 < nbytes <= fused.SMEM_PER_CTA
    assert fused.smem_plan(20000, 4)[0] == 1  # a long block of a small code drops to G = 1
    with pytest.raises(ValueError, match=r"T=8000 stages at N=256 states needs 258080 bytes"):
        fused.smem_plan(8000, 256)


def test_build_digest_covers_shared_headers(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    before = {n: _build._target(n, csrc) for n in ("acs", "fused", "traceback")}
    assert before == {n: _build._target(n) for n in before}  # same bytes, same name
    header = csrc / "acs_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build._target(n, csrc) for n in before}
    assert after["acs"] != before["acs"] and after["fused"] != before["fused"]
    (csrc / "fused.cu").write_text((csrc / "fused.cu").read_text() + "\n")
    assert _build._target("fused", csrc) != after["fused"]
    assert _build._target("acs", csrc) == after["acs"]
    assert "fused" in _build.sources() and "acs_core" not in _build.sources()


def test_decode_batch_is_one_fused_call_and_cpu_leaves_counts_at_zero(monkeypatch):
    calls = []
    plain = fused.pbvd_fused_plain
    monkeypatch.setattr(fused, "pbvd_fused_plain", lambda *a, **k: calls.append(1) or plain(*a, **k))
    engine = DecoderEngine(PBVDConfig(D=40, L=12, backend="fused", metric_mode="i8"), device="cpu")
    rng = np.random.default_rng(5)
    ys = [rng.normal(size=(n, 2)).astype(np.float32) for n in (120, 120, 77, 5)]
    acs.launches = traceback.launches = fused.launches = 0
    got = engine.decode_batch(ys, [120, 100, None, 5])
    assert len(calls) == 1
    assert (acs.launches, traceback.launches, fused.launches) == (0, 0, 0)
    want = DecoderEngine(PBVDConfig(D=40, L=12, backend="ref", metric_mode="i8"), device="cpu")
    for yi, nb, bi in zip(ys, [120, 100, None, 5], got):
        assert torch.equal(bi, want.decode(yi, nb))


@pytest.mark.parametrize("jax_backend,port_backend", [("pallas", "cuda"), ("ref", "ref"),
                                                      ("fused", "fused")])
def test_interop_carries_radix_and_backend(jax_backend, port_backend):
    jcfg = JConfig(spec=j_get_code_spec("ccsds-3/4"), D=64, L=24, q=6, backend=jax_backend,
                   metric_mode="i16", acs_radix=4)
    fields = dict(
        polys=np.array(jcfg.spec.code.polys), puncture=np.array(jcfg.spec.puncture), D=jcfg.D,
        L=jcfg.L, q=jcfg.q, start_policy=jcfg.start_policy, metric_mode=jcfg.metric_mode,
        acs_radix=jcfg.acs_radix, backend=jcfg.backend,
    )
    cfg = convert_config(fields)
    assert (cfg.backend, cfg.acs_radix, cfg.metric_mode) == (port_backend, 4, "i16")
    back = config_fields(cfg)
    assert (back["backend"], back["acs_radix"]) == (jax_backend, 4)
    assert convert_config(back) == cfg
    with pytest.raises(KeyError, match="no counterpart"):
        convert_config({**fields, "backend": "tpu"})


@pytest.mark.parametrize("jax_backend", ["pallas", "ref", "fused"])
def test_interop_carries_tb_and_acs_knobs(jax_backend):
    jcfg = JConfig(spec=j_get_code_spec("is95-k9"), D=64, L=24, q=8, backend=jax_backend,
                   metric_mode="i8", tb_mode="prefix", tb_chunk=12, acs_impl="matrix", acs_k=2)
    fields = dict(
        polys=np.array(jcfg.spec.code.polys), puncture=None, D=jcfg.D, L=jcfg.L, q=jcfg.q,
        start_policy=jcfg.start_policy, metric_mode=jcfg.metric_mode, backend=jcfg.backend,
        acs_radix=jcfg.acs_radix, tb_mode=jcfg.tb_mode, tb_chunk=jcfg.tb_chunk,
        acs_impl=jcfg.acs_impl, acs_k=jcfg.acs_k,
    )
    cfg = convert_config(fields)
    assert (cfg.tb_mode, cfg.tb_chunk, cfg.acs_impl, cfg.acs_k) == ("prefix", 12, "matrix", 2)
    back = config_fields(cfg)
    assert {k: back[k] for k in ("tb_mode", "tb_chunk", "acs_impl", "acs_k")} == dict(
        tb_mode="prefix", tb_chunk=12, acs_impl="matrix", acs_k=2)
    assert convert_config(back) == cfg
    # absent knobs keep the config's defaults
    base = convert_config({k: v for k, v in fields.items()
                           if k not in ("tb_mode", "tb_chunk", "acs_impl", "acs_k")})
    assert (base.tb_mode, base.tb_chunk, base.acs_impl, base.acs_k) == ("auto", 64, "butterfly", 2)
