"""The port's narrow metric modes and radix-4 ACS against the JAX reference,
on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``; survivor
words, decoded bits and path metrics must be equal (path metrics after a
cast to int32, since the kernels keep int32 registers in the narrow modes
and the plain versions store int16/int8). The CUDA kernels' stage loop
(``csrc/acs_core.cuh``: clip after widening, min-subtract on the global
step count, the trailing radix-2 stage at odd T) is modelled here in numpy
and held against the plain version, so its schedule is checked without a
card; ``chip_smoke.py`` holds the kernels themselves against the plain
versions on the card.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.engine import DecoderEngine as JEngine
from repro.core.pbvd import PBVDConfig as JConfig
from repro.core.quantize import norm_interval as j_norm_interval
from repro.core.trellis import ConvCode as JConvCode
from repro.kernels import ref as j_ref
from repro.kernels.ops import pbvd_decode_blocks as j_decode_blocks
from repro_torch.core.codespec import available_code_specs, get_code_spec
from repro_torch.core.encoder import encode_np, terminate
from repro_torch.core.engine import DecoderEngine
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.quantize import metric_mode_qmax, norm_interval
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import acs, ref
from repro_torch.kernels.ops import pbvd_decode_blocks

K5 = ((1, 0, 0, 1, 1), (1, 1, 1, 0, 1))  # (2,1,5): i8 cannot take radix 4
CODES = {
    "ccsds": (get_code_spec("ccsds").code, j_get_code_spec("ccsds").code),
    "is95-k9": (get_code_spec("is95-k9").code, j_get_code_spec("is95-k9").code),
    "k5": (ConvCode(polys=K5), JConvCode(polys=K5)),
}
STAGES = {"ccsds": 19, "is95-k9": 24, "k5": 21}  # odd T ends in a trailing radix-2 stage
MODES = ["f32", "i16", "i8"]
GOLDEN_DIR = Path(__file__).resolve().parent / "golden"
VARIANTS = [(2, False), (4, False), (4, True)]  # (radix, r4_combine)


def _symbols(T, R, B, seed, hi=3000):
    """int16 symbols far outside every narrow budget: the clip must catch them."""
    return np.random.default_rng(seed).integers(-hi, hi + 1, (T, R, B)).astype(np.int16)


def _budget_refuses(code, mode, radix):
    try:
        norm_interval(code, mode, radix)
    except ValueError:
        return True
    return False


@pytest.mark.parametrize("variant", VARIANTS, ids=["r2", "r4", "r4-combine"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(CODES))
def test_acs_forward_ref_equals_reference(name, mode, variant):
    radix, combine = variant
    code, jcode = CODES[name]
    if _budget_refuses(code, mode, radix):
        with pytest.raises(ValueError) as ours:
            ref.acs_forward_ref(torch.zeros((4, code.R, 2), dtype=torch.int16), code, mode, radix)
        with pytest.raises(ValueError) as theirs:
            j_norm_interval(jcode, mode, radix)
        assert str(ours.value) == str(theirs.value)
        return
    y = _symbols(STAGES[name], code.R, 6, seed=len(name))
    sp_j, pm_j = j_ref.acs_forward_ref(jnp.asarray(y), jcode, metric_mode=mode, radix=radix,
                                       r4_combine=combine)
    sp, pm = ref.acs_forward_ref(torch.as_tensor(y), code, mode, radix, r4_combine=combine)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j))
    assert str(pm.dtype).removeprefix("torch.") == str(pm_j.dtype)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_j))
    # the CUDA wrapper on a CPU tensor is the plain version
    sp_w, pm_w = acs.acs_forward(torch.as_tensor(y), code, mode, radix)
    assert torch.equal(sp_w, sp) and torch.equal(pm_w, pm)


@pytest.mark.parametrize("radix", [2, 4])
def test_float_symbols_radix4_equals_reference(radix):
    """Float32 at radix 4: only the staged add order is bit-exact."""
    code, jcode = CODES["ccsds"]
    y = (np.random.default_rng(radix).normal(size=(21, 2, 7)) * 2.0).astype(np.float32)
    sp_j, pm_j = j_ref.acs_forward_ref(jnp.asarray(y), jcode, radix=radix)
    sp, pm = ref.acs_forward_ref(torch.as_tensor(y), code, radix=radix, r4_combine=True)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_j))


def _kernel_forward_model(y, code, mode, radix):
    """numpy model of csrc/acs_core.cuh::forward_acs for one parallel block:
    int64 registers, clip after widening, one radix-2 stage at a time, the
    min-subtract after the last stage of every norm_every-th step, and the
    unconditional one after the trailing stage of odd T at radix 4."""
    T, R = y.shape
    N, half = code.n_states, code.n_states // 2
    labels = acs.kernel_labels(code)
    norm_every = norm_interval(code, mode, radix)
    qmax = metric_mode_qmax(code, mode) if norm_every else 0
    y = y.astype(np.int64)
    if qmax:
        y = np.clip(y, -qmax, qmax)
    signs = code.codeword_signs.astype(np.int64)  # (2^R, R): BM(c) = signs[c] · y
    pm = np.zeros(N, dtype=np.int64)
    words = np.zeros((T, -(-N // 32)), dtype=np.int64)
    per_step = 2 if radix == 4 else 1
    for t in range(T):
        bm = signs @ y[t]
        pe = 2 * (np.arange(N) % half)
        m_even = pm[pe] + bm[labels[:, 0]]
        m_odd = pm[pe + 1] + bm[labels[:, 1]]
        dec = m_odd < m_even
        pm = np.where(dec, m_odd, m_even)
        for s in np.flatnonzero(dec):
            words[t, s // 32] |= 1 << (s % 32)
        step, last_of_step = divmod(t, per_step)
        trailing = radix == 4 and T % 2 == 1 and t == T - 1
        if norm_every and (trailing or (last_of_step == per_step - 1
                                        and step % norm_every == norm_every - 1)):
            pm = pm - pm.min()
    return np.where(words >= 1 << 31, words - (1 << 32), words), pm


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("mode", MODES)
def test_kernel_schedule_model_matches_plain(mode, radix):
    code = CODES["ccsds"][0]
    y = _symbols(37, 2, 1, seed=11, hi=200)
    words, pm = _kernel_forward_model(y[:, :, 0], code, mode, radix)
    sp, pm_ref = ref.acs_forward_ref(torch.as_tensor(y), code, mode, radix)
    np.testing.assert_array_equal(sp[:, :, 0].numpy(), words)
    np.testing.assert_array_equal(pm_ref[:, 0].to(torch.int32).numpy(), pm)


def _golden(name):
    with np.load(GOLDEN_DIR / (name.replace("/", "_") + ".npz"), allow_pickle=False) as z:
        data = {k: z[k] for k in z.files}
    data["meta"] = json.loads(str(data["meta"]))
    return data


def _noisy_stream(name, n_bits, seed):
    """BPSK of the encoded payload plus noise, made with numpy (the punctured
    wire format for punctured specs)."""
    spec = get_code_spec(name)
    rng = np.random.default_rng(seed)
    coded = encode_np(terminate(rng.integers(0, 2, n_bits), spec.code), spec.code)
    tx = spec.puncture_stream(coded) if spec.is_punctured else coded
    return (1.0 - 2.0 * tx + rng.normal(scale=0.8, size=tx.shape)).astype(np.float32)


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", available_code_specs())
def test_golden_replay_fused(name, mode, radix):
    g = _golden(name)
    meta = g["meta"]
    spec = get_code_spec(name)
    kw = dict(spec=spec, D=meta["D"], L=meta["L"], q=meta["q"], backend="fused",
              metric_mode=mode, acs_radix=radix)
    if _budget_refuses(spec.code, mode, radix):
        with pytest.raises(ValueError, match="cannot accumulate"):
            PBVDConfig(**kw)
        return
    bits = DecoderEngine(PBVDConfig(**kw), device="cpu").decode(g["y"], meta["n_bits"])
    np.testing.assert_array_equal(bits.numpy(), g["bits_i8"] if mode == "i8" else g["bits_f32"])


@pytest.mark.parametrize(
    "name,mode,radix",
    [("ccsds", "i16", 4), ("ccsds", "i8", 2), ("ccsds-3/4", "i8", 4),
     ("is95-k9", "i16", 2), ("lte-1/3", "i8", 4)],
)
def test_engine_narrow_modes_equal_jax_ref_engine(name, mode, radix):
    y = _noisy_stream(name, 200, seed=len(name) + radix)
    geo = dict(D=40, L=20, metric_mode=mode, acs_radix=radix)
    want = np.asarray(JEngine(JConfig(spec=j_get_code_spec(name), backend="ref", **geo))
                      .decode(jnp.asarray(y), 200))
    for backend in ("fused", "cuda", "ref"):
        engine = DecoderEngine(PBVDConfig(spec=get_code_spec(name), backend=backend, **geo),
                               device="cpu")
        np.testing.assert_array_equal(engine.decode(y, 200).numpy(), want, err_msg=backend)
    fleet = [_noisy_stream(name, 90, seed=s) for s in range(3)]
    for n_bits in ([90, 90, 90], [90, 41, None]):
        got = engine.decode_batch(fleet, n_bits)
        for i, yi in enumerate(fleet):
            assert torch.equal(got[i], engine.decode(yi, n_bits[i])), (n_bits, i)


@pytest.mark.parametrize("mode", ["i16", "i8"])
def test_effective_q_and_quantize_equal_reference(mode):
    y = (np.random.default_rng(3).normal(size=(50, 2)) * 1.7).astype(np.float32)
    for q in (8, None, 2):
        kw = dict(q=q, metric_mode=mode, backend="ref")
        j, t = JConfig(**kw), PBVDConfig(**kw)
        assert t.effective_q == j.effective_q
        got = t.quantize(torch.as_tensor(y))
        want = np.asarray(j.quantize(jnp.asarray(y)))
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype)
        np.testing.assert_array_equal(got.numpy(), want)
    assert PBVDConfig(metric_mode="i8").effective_q == 3  # CCSDS: coarse 3-bit symbols


def test_knob_errors_equal_reference():
    ccsds = get_code_spec("ccsds").code
    blocks = torch.zeros((8, 2, 1), dtype=torch.int8)
    # argmin on fused: the registry's knob error, at the config and the dispatcher
    with pytest.raises(ValueError) as theirs:
        j_decode_blocks(jnp.zeros((8, 2, 128), jnp.int8), j_get_code_spec("ccsds").code,
                        decode_start=2, n_decode=4, backend="fused", start_policy="argmin")
    with pytest.raises(ValueError) as ours:
        PBVDConfig(backend="fused", start_policy="argmin")
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError) as ours:
        pbvd_decode_blocks(blocks, ccsds, decode_start=2, n_decode=4, backend="fused",
                           start_policy="argmin")
    assert str(ours.value) == str(theirs.value)
    # the backend itself refuses argmin when called around the dispatcher
    from repro_torch.kernels.registry import FramedBlocks, get_backend

    with pytest.raises(ValueError, match="tracebacks from state 0"):
        get_backend("fused")(FramedBlocks(blocks, 2, 4), ccsds, start_policy="argmin")
    # radix 4 on a K = 2 code
    k2, jk2 = ConvCode(polys=((1, 1), (1, 0))), JConvCode(polys=((1, 1), (1, 0)))
    with pytest.raises(ValueError) as ours:
        PBVDConfig(code=k2, acs_radix=4)
    with pytest.raises(ValueError) as theirs:
        JConfig(code=jk2, acs_radix=4)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match=r"acs_radix=4 needs K >= 3 \(got K=2\)"):
        pbvd_decode_blocks(blocks, k2, decode_start=2, n_decode=4, acs_radix=4)
    # i8 at radix 4 on (2,1,5): refused at the config and the dispatcher, before launch
    k5, jk5 = CODES["k5"]
    with pytest.raises(ValueError) as theirs:
        JConfig(code=jk5, metric_mode="i8", acs_radix=4)
    for backend in ("fused", "cuda", "ref"):
        with pytest.raises(ValueError) as ours:
            PBVDConfig(code=k5, metric_mode="i8", acs_radix=4, backend=backend)
        assert str(ours.value) == str(theirs.value)
        with pytest.raises(ValueError) as ours:
            pbvd_decode_blocks(blocks, k5, decode_start=2, n_decode=4, backend=backend,
                               metric_mode="i8", acs_radix=4)
        assert str(ours.value) == str(theirs.value)
    # float symbols with a narrow mode
    for mode in ("i16", "i8"):
        with pytest.raises(ValueError) as theirs:
            j_ref.acs_forward_ref(jnp.zeros((4, 2, 3), jnp.float32), CODES["ccsds"][1],
                                  metric_mode=mode)
        with pytest.raises(ValueError) as ours:
            ref.acs_forward_ref(torch.zeros((4, 2, 3)), ccsds, metric_mode=mode)
        head = f"metric_mode={mode!r} needs pre-quantized integer symbols (got float32)"
        assert str(ours.value).startswith(head) and str(theirs.value).startswith(head)
