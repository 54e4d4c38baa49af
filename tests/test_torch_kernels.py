"""The port's kernel modules against the JAX reference, on the CPU.

K1 (forward ACS) and K2 (serial traceback) run their plain PyTorch versions
here: a CPU tensor takes the plain version, and only that. They are held
against ``repro.kernels.ref`` (integer results and survivor words exact;
float32 path metrics with rtol 1e-6, though the same add order makes them
exact too) and once each against the Pallas kernels in interpret mode. The
CUDA kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``; the per-thread arithmetic of the ACS kernel is
modelled here in numpy so its tables are checked without a card.
"""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.trellis import ConvCode as JConvCode
from repro.kernels import ref as j_ref
from repro.kernels.acs import acs_forward_pallas
from repro.kernels.traceback import traceback_pallas
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import acs, ref, traceback

K5 = ((1, 0, 0, 1, 1), (1, 1, 1, 0, 1))  # (2,1,5), N = 16: one word per stage
CODES = {
    "ccsds": get_code_spec("ccsds").code,
    "k5": ConvCode(polys=K5),
    "lte-1/3": get_code_spec("lte-1/3").code,
    "is95-k9": get_code_spec("is95-k9").code,
}
J_CODES = {
    "ccsds": j_get_code_spec("ccsds").code,
    "k5": JConvCode(polys=K5),
    "lte-1/3": j_get_code_spec("lte-1/3").code,
    "is95-k9": j_get_code_spec("is95-k9").code,
}


def _symbols(kind: str, T: int, R: int, B: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "int8":
        return rng.integers(-127, 128, (T, R, B)).astype(np.int8)
    if kind == "int16":
        return rng.integers(-3000, 3001, (T, R, B)).astype(np.int16)
    if kind == "float32":
        return (rng.normal(size=(T, R, B)) * 2.0).astype(np.float32)
    # float32 on a coarse grid: many exact ties in the compares
    return (rng.integers(-4, 5, (T, R, B)) * 0.5).astype(np.float32)


@pytest.mark.parametrize("kind", ["int8", "int16", "float32", "float32-ties"])
@pytest.mark.parametrize("name", list(CODES))
def test_acs_plain_equals_reference(name, kind):
    code = CODES[name]
    y = _symbols(kind, 24, code.R, 9, seed=len(name))
    sp_j, pm_j = j_ref.acs_forward_ref(jnp.asarray(y), J_CODES[name])
    sp, pm = acs.acs_forward_plain(torch.as_tensor(y), code)
    assert sp.dtype == torch.int32 and sp.shape == (24, -(-code.n_states // 32), 9)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j))
    if kind.startswith("float"):
        assert pm.dtype == torch.float32
        np.testing.assert_allclose(pm.numpy(), np.asarray(pm_j), rtol=1e-6, atol=0)
    else:
        assert pm.dtype == torch.int32
        np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_j))


def test_acs_plain_equals_pallas_interpret():
    code = CODES["ccsds"]
    y = _symbols("int8", 64, 2, 128, seed=7)
    sp_j, pm_j = acs_forward_pallas(jnp.asarray(y), J_CODES["ccsds"], stage_chunk=32,
                                    interpret=True)
    sp, pm = acs.acs_forward(torch.as_tensor(y), code)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j))
    np.testing.assert_array_equal(pm.numpy(), np.asarray(pm_j))


def _kernel_stage_model(pm, y_t, labels, R):
    """numpy model of one stage of csrc/acs.cu: thread s reads its even and
    odd predecessor labels, builds each metric as a folded row in r order
    with the fold sign, adds, compares (odd < even) and selects."""
    N = pm.shape[0]
    half = N // 2

    def label_metric(c):
        full, neg = (1 << R) - 1, c >= (1 << (R - 1))
        k = c ^ full if neg else c
        acc = y_t[0] if (k >> (R - 1)) & 1 else -y_t[0]
        for r in range(1, R):
            acc = acc + (y_t[r] if (k >> (R - 1 - r)) & 1 else -y_t[r])
        return -acc if neg else acc

    new, dec = np.empty_like(pm), np.zeros(N, dtype=np.int64)
    for s in range(N):
        pe = 2 * (s % half)
        m_even = pm[pe] + label_metric(int(labels[s, 0]))
        m_odd = pm[pe + 1] + label_metric(int(labels[s, 1]))
        dec[s] = m_odd < m_even
        new[s] = m_odd if dec[s] else m_even
    return new, dec


@pytest.mark.parametrize("name", list(CODES))
def test_kernel_label_arithmetic_matches_plain(name):
    code = CODES[name]
    labels = acs.kernel_labels(code)
    assert labels.shape == (code.n_states, 2) and labels.dtype == np.int32
    y = _symbols("int8", 6, code.R, 1, seed=3).astype(np.int64)
    sp, pm = acs.acs_forward_plain(torch.as_tensor(y.astype(np.int32)), code)
    pm_model = np.zeros(code.n_states, dtype=np.int64)
    for t in range(y.shape[0]):
        pm_model, dec = _kernel_stage_model(pm_model, y[t, :, 0], labels, code.R)
        words = sp[t, :, 0].numpy().astype(np.int64) & 0xFFFFFFFF
        bits = (words[np.arange(code.n_states) // 32] >> (np.arange(code.n_states) % 32)) & 1
        np.testing.assert_array_equal(bits, dec)
    np.testing.assert_array_equal(pm[:, 0].numpy(), pm_model)


def _survivors(name: str, T: int, B: int, seed: int):
    y = _symbols("int8", T, CODES[name].R, B, seed)
    sp, pm = j_ref.acs_forward_ref(jnp.asarray(y), J_CODES[name])
    return np.array(sp), np.array(pm)


@pytest.mark.parametrize("start", ["zero", "argmin", "random"])
@pytest.mark.parametrize("name", ["ccsds", "k5", "is95-k9"])
def test_traceback_plain_equals_reference(name, start):
    code = CODES[name]
    sp, pm = _survivors(name, 40, 11, seed=5)
    if start == "zero":
        st = 0
    elif start == "argmin":
        st = np.argmin(pm, axis=0).astype(np.int32)
    else:
        st = np.random.default_rng(1).integers(0, code.n_states, 11).astype(np.int32)
    for decode_start, n_decode in ((8, 24), (0, 40), (39, 1)):
        want = j_ref.traceback_ref(jnp.asarray(sp), J_CODES[name], decode_start, n_decode,
                                   jnp.asarray(st))
        got = traceback.traceback(torch.as_tensor(sp), code, decode_start, n_decode,
                                  torch.as_tensor(st))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_traceback_plain_equals_pallas_interpret():
    code = CODES["ccsds"]
    sp, pm = _survivors("ccsds", 128, 128, seed=9)
    st = np.argmin(pm, axis=0).astype(np.int32)
    want = traceback_pallas(jnp.asarray(sp), jnp.asarray(st), J_CODES["ccsds"],
                            decode_start=20, n_decode=80, interpret=True)
    got = traceback.traceback(torch.as_tensor(sp), code, 20, 80, torch.as_tensor(st))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("states", [[31], [63], [31, 63], [0, 31, 32, 63]])
def test_survivor_words_with_bit_31_round_trip(states):
    dec = np.zeros((64, 3), dtype=np.int32)
    dec[states] = 1
    words = ref._pack_decisions(torch.as_tensor(dec))
    np.testing.assert_array_equal(words.numpy(), np.asarray(j_ref._pack_decisions(jnp.asarray(dec))))
    assert (words[:, 0] < 0).any() == any(s % 32 == 31 for s in states)
    # a walk through those words reads every set bit back
    code = CODES["ccsds"]
    sp = words[None].repeat(3, 1, 1)
    for s in states:
        got = traceback.traceback(sp, code, 0, 3, s)
        want = j_ref.traceback_ref(jnp.asarray(sp.numpy()), J_CODES["ccsds"], 0, 3, s)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_tensors_leave_launch_counts_at_zero():
    acs.launches = traceback.launches = 0
    code = CODES["ccsds"]
    sp, pm = acs.acs_forward(torch.as_tensor(_symbols("int8", 20, 2, 5, seed=2)), code)
    traceback.traceback(sp, code, 4, 10, torch.argmin(pm, dim=0))
    assert (acs.launches, traceback.launches) == (0, 0)


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor neither on the CPU nor on CUDA raises. A meta
    tensor takes the wrappers' meta branch (the work counter's,
    ``launch/cost.py``): meta outputs, no launch; so the other device here
    is a stand-in that names one."""
    code = CODES["ccsds"]
    elsewhere = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        acs.acs_forward(elsewhere, code)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        traceback.traceback(elsewhere, code, 0, 2)
    acs.launches = traceback.launches = 0
    sp, pm = acs.acs_forward(torch.empty((4, 2, 3), dtype=torch.int8, device="meta"), code)
    bits = traceback.traceback(sp, code, 0, 2)
    assert (sp.device.type, pm.device.type, bits.shape) == ("meta", "meta", (2, 3))
    assert (acs.launches, traceback.launches) == (0, 0)


@pytest.mark.parametrize(
    "kwargs,match",
    [(dict(metric_mode="i16"), "metric_mode"), (dict(radix=3), "radix"),
     (dict(impl="systolic"), "impl")],
)
def test_plain_acs_rejects_unported_knobs(kwargs, match):
    # i16, radix 4 and the matrix impl are ported: float symbols with i16,
    # radix 3 and an impl that does not exist are not
    y = torch.zeros((3, 2, 2), dtype=torch.float32 if "metric_mode" in kwargs else torch.int8)
    with pytest.raises(ValueError, match=match):
        acs.acs_forward(y, CODES["ccsds"], **kwargs)


def test_plain_versions_are_the_reference_functions():
    assert acs.acs_forward_plain is ref.acs_forward_ref
    assert traceback.traceback_plain is ref.traceback_ref


def test_pbvd_decode_ref_matches_classic_viterbi():
    """Level 1 against level 2: a block framed from stage 0 with the zero start."""
    code = CODES["ccsds"]
    rng = np.random.default_rng(4)
    y = (rng.normal(size=(60, 2)) * 1.5).astype(np.float32)
    y[:, :] += 1.0
    want = ref.viterbi_classic_np(y.astype(np.float64), code, init_state=None, final_state=0)
    got = ref.pbvd_decode_ref(torch.as_tensor(y[:, :, None]), code, n_decode=60, n_traceback=0)
    np.testing.assert_array_equal(got[:, 0].numpy(), want)
    np.testing.assert_array_equal(
        ref.viterbi_classic_np(y, code), j_ref.viterbi_classic_np(y, J_CODES["ccsds"])
    )
