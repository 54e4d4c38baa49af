"""The port's prefix traceback against the JAX reference, on the CPU.

The same numpy survivor words (random int32 words, so bit 31, the sign
bit, is set as often as any other) go through ``repro`` and
``repro_torch``; decoded bits and packed words must be equal. On CPU
tensors ``traceback_prefix`` runs its plain version
(``ref.traceback_prefix_chunked_ref``) and ``pbvd_fused`` runs
``ref.pbvd_fused_ref``. The three phases of ``csrc/traceback_core.cuh``
(batched composition, the walk over composed maps, the expansion with the
zero pad below stage 0 and the fused kernel's packing of a window that is
not word aligned) are modelled here in numpy and held against the plain
versions; ``chip_smoke.py`` holds the kernels themselves against the plain
versions on the card. Also here: the shared-memory plans, the engine with
the new knobs against the JAX ``backend="ref"`` engine, and golden replay.
"""

import json
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.engine import DecoderEngine as JEngine
from repro.core.pbvd import PBVDConfig as JConfig
from repro.core.trellis import ConvCode as JConvCode
from repro.kernels import ref as j_ref
from repro.kernels import traceback as j_traceback
from repro.kernels.fused import pbvd_fused_pallas
from repro_torch.core.codespec import available_code_specs, get_code_spec
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import acs, fused, ref, traceback

K5 = ((1, 0, 0, 1, 1), (1, 1, 1, 0, 1))  # (2,1,5): one survivor word per stage
CODES = {
    "ccsds": (get_code_spec("ccsds").code, j_get_code_spec("ccsds").code),
    "is95-k9": (get_code_spec("is95-k9").code, j_get_code_spec("is95-k9").code),
    "k5": (ConvCode(polys=K5), JConvCode(polys=K5)),
}
GOLDEN_DIR = Path(__file__).resolve().parent / "golden"


def _words(T, W, B, seed):
    return np.random.default_rng(seed).integers(-(1 << 31), 1 << 31, (T, W, B)).astype(np.int32)


@pytest.mark.parametrize(
    "name,T,ds,nd,tb_chunk",
    [("ccsds", 40, 10, 20, 1), ("ccsds", 40, 10, 20, 7), ("ccsds", 40, 10, 20, 16),
     ("ccsds", 40, 10, 20, 40), ("ccsds", 40, 10, 20, 43),
     ("ccsds", 40, 2, 30, 16),  # c_lo = 0: the pad rows sit in the first expanded chunk
     ("k5", 30, 4, 20, 7)],  # W = 1
)
def test_prefix_plain_equals_pallas_interpret(name, T, ds, nd, tb_chunk):
    code, jcode = CODES[name]
    W = -(-code.n_states // 32)
    sp = _words(T, W, 128, T + tb_chunk)
    st = np.random.default_rng(ds).integers(0, code.n_states, 128).astype(np.int32)
    want = j_traceback.traceback_prefix_pallas(jnp.asarray(sp), jnp.asarray(st), jcode,
                                               decode_start=ds, n_decode=nd,
                                               tb_chunk=tb_chunk, interpret=True)
    traceback.prefix_launches = 0
    got = traceback.traceback_prefix(torch.as_tensor(sp), code, ds, nd, torch.as_tensor(st),
                                     tb_chunk)
    assert got.dtype == torch.int32 and got.shape == (nd, 128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert traceback.prefix_launches == 0


@pytest.mark.parametrize("name", ["ccsds", "is95-k9"])  # W = 2 and W = 8
def test_traceback_prefix_ref_equals_jax(name):
    code, jcode = CODES[name]
    W = -(-code.n_states // 32)
    sp = _words(37, W, 9, len(name))
    st = np.random.default_rng(1).integers(0, code.n_states, 9).astype(np.int32)
    want = j_ref.traceback_prefix_ref(jnp.asarray(sp), jcode, 5, 30, jnp.asarray(st))
    got = ref.traceback_prefix_ref(torch.as_tensor(sp), code, 5, 30, torch.as_tensor(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, ref.traceback_ref(torch.as_tensor(sp), code, 5, 30,
                                              torch.as_tensor(st)))


def test_prefix_chunk_geometry_equals_jax():
    for T in (1, 5, 40, 596, 4224):
        for ds, nd in ((0, T), (0, 1), (T // 3, T - T // 3), (T - 1, 1), (min(42, T - 1), 1)):
            for tb in (1, 7, 16, 64, T, T + 5):
                assert (traceback.prefix_chunk_geometry(T, ds, nd, tb)
                        == j_traceback.prefix_chunk_geometry(T, ds, nd, tb)), (T, ds, nd, tb)
    for args in ((40, 0, 20, 0), (40, 30, 20, 16), (40, -1, 5, 16)):
        with pytest.raises(ValueError) as want:
            j_traceback.prefix_chunk_geometry(*args)
        with pytest.raises(ValueError) as got:
            traceback.prefix_chunk_geometry(*args)
        assert str(got.value) == str(want.value)
    assert traceback.DEFAULT_TB_CHUNK == j_traceback.DEFAULT_TB_CHUNK == 64


@pytest.mark.parametrize(
    "kind,mode,T,ds,nd,tb_chunk",
    [("int8", "f32", 60, 12, 32, 16),
     ("int8", "i8", 50, 8, 64, 7)],  # i8; 64 > T - decode_start: the top bits stay 0
)
def test_fused_plain_prefix_equals_pallas_interpret(kind, mode, T, ds, nd, tb_chunk):
    code, jcode = CODES["ccsds"]
    rng = np.random.default_rng(T)
    y = rng.integers(-127, 128, (T, 2, 100)).astype(np.int8)
    st = rng.integers(0, 64, 100).astype(np.int32)
    pad = ((0, 0), (0, 0), (0, 28))
    want = pbvd_fused_pallas(jnp.asarray(np.pad(y, pad)), jcode, decode_start=ds, n_decode=nd,
                             start_state=jnp.asarray(np.pad(st, (0, 28))), interpret=True,
                             metric_mode=mode, tb_mode="prefix", tb_chunk=tb_chunk)
    fused.launches = fused.prefix_launches = 0
    got = fused.pbvd_fused(torch.as_tensor(y), code, decode_start=ds, n_decode=nd,
                           start_state=torch.as_tensor(st), metric_mode=mode, tb_mode="prefix",
                           tb_chunk=tb_chunk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:, :100])
    assert (fused.launches, fused.prefix_launches) == (0, 0)


def _model_prefix(sp, code, ds, n_decode, start, tb_chunk, packed):
    """numpy model of csrc/traceback_core.cuh::prefix_traceback, with the
    emit of K2-prefix (bits) or of the fused kernel (or-ed window words)."""
    T, W, B = sp.shape
    N, half = code.n_states, code.n_states // 2
    n_window = min(n_decode, T - ds)
    C, P, n_chunks, c_lo, c_hi = traceback.prefix_chunk_geometry(T, ds, n_window, tb_chunk)
    n_act, nc_e, ds_local = n_chunks - c_lo, c_hi - c_lo + 1, ds + P - c_lo * C
    words = sp.astype(np.int64) & 0xFFFFFFFF  # the kernels read unsigned words

    def sp_word(stage, w, b):
        return 0 if stage < 0 else words[stage, w, b]

    out = np.zeros((n_decode // 32 if packed else n_decode, B), np.int64)
    for b in range(B):
        maps = np.zeros((n_act, N), np.int64)
        for s in range(N):  # thread s, kComposeBatch = 4 chunks at a time
            for c0 in range(0, n_act, 4):
                h = [s] * 4
                for row in range(C - 1, -1, -1):
                    for q in range(4):
                        if c0 + q < n_act:
                            wd = sp_word((c_lo + c0 + q) * C + row - P, h[q] >> 5, b)
                            h[q] = ((h[q] & (half - 1)) << 1) | ((wd >> (h[q] & 31)) & 1)
                for q in range(4):
                    if c0 + q < n_act:
                        maps[c0 + q, s] = h[q]
        state, entry = int(start[b]) & (N - 1), np.zeros(nc_e, np.int64)
        for c in range(n_act - 1, -1, -1):
            if c < nc_e:
                entry[c] = state
            state = int(maps[c, state])
        for ci in range(nc_e):
            state = int(entry[ci])
            for row in range(C - 1, -1, -1):
                idx = ci * C + row - ds_local
                if 0 <= idx < n_window:
                    bit = state >> (code.v - 1)
                    if packed:
                        out[idx >> 5, b] |= bit << (idx & 31)
                    else:
                        out[idx, b] = bit
                if row == 0:
                    break
                wd = sp_word((c_lo + ci) * C + row - P, state >> 5, b)
                state = ((state & (half - 1)) << 1) | ((wd >> (state & 31)) & 1)
    return np.where(out >= 1 << 31, out - (1 << 32), out).astype(np.int32)


@pytest.mark.parametrize(
    "name,T,ds,nd,tb_chunk",
    [("ccsds", 40, 10, 20, 7), ("ccsds", 40, 2, 30, 16), ("ccsds", 23, 0, 23, 1),
     ("ccsds", 23, 5, 18, 30), ("k5", 45, 9, 32, 10), ("is95-k9", 21, 3, 18, 5)],
)
def test_cuda_prefix_phases_model_equals_plain(name, T, ds, nd, tb_chunk):
    code = CODES[name][0]
    W = -(-code.n_states // 32)
    sp = _words(T, W, 3, T * tb_chunk)
    st = np.random.default_rng(T).integers(0, code.n_states, 3).astype(np.int32)
    want = ref.traceback_ref(torch.as_tensor(sp), code, ds, nd, torch.as_tensor(st))
    np.testing.assert_array_equal(_model_prefix(sp, code, ds, nd, st, tb_chunk, False),
                                  want.numpy())
    plain = traceback.traceback_prefix(torch.as_tensor(sp), code, ds, nd, torch.as_tensor(st),
                                       tb_chunk)
    assert torch.equal(plain, want)
    # the fused tail: a packed width of whole words, overhanging T where it must
    n_words = -(-nd // 32)
    n_window = min(32 * n_words, T - ds)
    bits = ref.traceback_ref(torch.as_tensor(sp), code, ds, n_window, torch.as_tensor(st))
    bits = torch.cat([bits, bits.new_zeros((32 * n_words - n_window, 3))])
    np.testing.assert_array_equal(
        _model_prefix(sp, code, ds, 32 * n_words, st, tb_chunk, True),
        ref._pack_decisions(bits).numpy())


def test_smem_plans_count_the_prefix_scratch():
    # main geometry: T = 596, decode_start = 42, 512 bits, C = 64 → P = 44,
    # 10 chunks, c_lo = 1, c_hi = 9: 9 maps of 64 states, 9 entries, 16 words
    assert traceback.prefix_chunk_geometry(596, 42, 512, 64) == (64, 44, 10, 1, 9)
    per_block = 2 * 64 + 2 + 596 * 2 + 9 * 64 + 9 + 16
    assert fused.smem_plan(596, 64, "prefix", 64, decode_start=42, n_decode=512) == (
        2, 4 * 2 * per_block)
    assert 4 * 9 * 64 == 2304  # the maps, bytes per block
    # the matrix loop adds 2^(kR-1) rows and k planes of W words per block
    assert fused.smem_plan(596, 64, matrix_k=3, R=2)[1] == fused.smem_plan(596, 64)[1] + 4 * 2 * (
        32 + 3 * 2)
    # K = 9, D = 4096, L = 64 with the prefix scratch fits at G = 1
    G, nbytes = fused.smem_plan(4224, 256, "prefix", 64, decode_start=64, n_decode=4096)
    assert G == 1 and nbytes == 4 * (2 * 256 + 8 + 4224 * 8 + 65 * 256 + 64 + 128)
    with pytest.raises(ValueError, match="with the prefix scratch of tb_chunk=16 needs"):
        fused.smem_plan(4224, 256, "prefix", 16, decode_start=64, n_decode=4096)
    assert traceback.prefix_smem_plan(64, 9, 9) == (32, 4 * 32 * (9 * 64 + 9))
    assert traceback.prefix_smem_plan(256, 65, 64)[0] == 2
    with pytest.raises(ValueError, match="use a larger tb_chunk"):
        traceback.prefix_smem_plan(256, 554, 512)
    # the plan a K2-prefix launch (and the "cuda" backend, before K1) checks
    assert traceback.prefix_plan(64, 596, 42, 512, 64) == ((64, 44, 10, 1, 9), 32)
    with pytest.raises(ValueError, match="use a larger tb_chunk"):
        traceback.prefix_plan(256, 596, 42, 512, 1)


def _noisy_stream(name, n_bits, seed):
    from repro_torch.core.encoder import encode_np, terminate

    spec = get_code_spec(name)
    rng = np.random.default_rng(seed)
    coded = encode_np(terminate(rng.integers(0, 2, n_bits), spec.code), spec.code)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    return (1.0 - 2.0 * tx + rng.normal(scale=0.8, size=tx.shape)).astype(np.float32)


@pytest.mark.parametrize(
    "name,knobs",
    [("ccsds", dict(tb_mode="prefix", tb_chunk=7, acs_impl="matrix", acs_k=3)),
     ("is95-k9-2/3", dict(metric_mode="i8", acs_impl="matrix", acs_k=2)),
     ("lte-1/3", dict(metric_mode="i16", tb_mode="prefix", tb_chunk=16))],
)
def test_engine_new_knobs_equal_jax_ref_engine(name, knobs):
    ys = [_noisy_stream(name, n, seed=n) for n in (150, 150, 70)]
    geo = dict(D=32, L=20, q=8, **knobs)
    jeng = JEngine(JConfig(spec=j_get_code_spec(name), backend="ref", **geo))
    want = [np.asarray(b) for b in jeng.decode_batch([jnp.asarray(y) for y in ys])]
    for backend in ("ref", "cuda", "fused"):
        eng = DecoderEngine(PBVDConfig(spec=get_code_spec(name), backend=backend, **geo),
                            device="cpu")
        for got, w in zip(eng.decode_batch(ys), want):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=backend)


@pytest.mark.parametrize("backend", ["cuda", "fused"])
@pytest.mark.parametrize("name", available_code_specs())
def test_golden_replay_through_prefix_and_matrix(name, backend):
    with np.load(GOLDEN_DIR / (name.replace("/", "_") + ".npz"), allow_pickle=False) as z:
        g = {k: z[k] for k in z.files}
    meta = json.loads(str(g["meta"]))
    for mode, key in (("f32", "bits_f32"), ("i8", "bits_i8")):
        cfg = PBVDConfig(spec=get_code_spec(name), D=meta["D"], L=meta["L"], q=meta["q"],
                         backend=backend, metric_mode=mode, tb_mode="prefix", tb_chunk=16,
                         acs_impl="matrix", acs_k=2)
        acs.launches = acs.matrix_launches = traceback.prefix_launches = fused.launches = 0
        bits = DecoderEngine(cfg, device="cpu").decode(g["y"], meta["n_bits"])
        np.testing.assert_array_equal(bits.numpy(), g[key], err_msg=mode)
        assert (acs.launches, acs.matrix_launches, traceback.prefix_launches,
                fused.launches) == (0, 0, 0, 0)


def test_wrappers_refuse_other_devices_and_bad_geometry():
    code = CODES["ccsds"][0]
    # meta tensors take the work counter's branch (launch/cost.py); another device raises
    elsewhere = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        traceback.traceback_prefix(elsewhere, code, 2, 20)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused.pbvd_fused(elsewhere, code, decode_start=2, n_decode=32, tb_mode="prefix")
    meta = torch.empty((40, 2, 3), dtype=torch.int32, device="meta")
    assert traceback.traceback_prefix(meta, code, 2, 20).device.type == "meta"
    sp = torch.zeros((40, 2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="tb_chunk must be >= 1"):
        traceback.traceback_prefix(sp, code, 2, 20, 0, 0)
    with pytest.raises(ValueError, match="outside"):
        traceback.traceback_prefix(sp, code, 30, 20)
    with pytest.raises(ValueError, match="unknown tb_mode"):
        fused.pbvd_fused(sp.to(torch.int8), code, decode_start=2, n_decode=32, tb_mode="zigzag")
