"""The port's k-stage (min,+) matrix ACS against the JAX reference, on the CPU.

The same numpy inputs go through ``repro`` and ``repro_torch``; survivor
words, path metrics and decoded bits must be equal (integer and bit data:
exact equality). The plain versions run here: ``acs_forward`` on a CPU
tensor is ``ref.acs_forward_ref`` and ``pbvd_fused`` is ``ref.pbvd_fused_ref``.
The CUDA loop ``csrc/acs_core.cuh::forward_acs_matrix`` is modelled here
thread by thread in numpy (its table lookups, tournament, bit positions,
normalization countdown and trailing stages) and held against the plain
version, so its index arithmetic is checked without a card; ``chip_smoke.py``
holds the kernels themselves against the plain versions on the card.

On the short blocks at k = 4 the JAX oracle runs with ``jax.disable_jit()``:
its scan then steps in Python, which costs far less here than compiling
the 4-stage step. Below k = 4, and on the long blocks that span several
normalization intervals, compiling is the cheaper way.
"""

import contextlib
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.core.pbvd import PBVDConfig as JConfig
from repro.core.trellis import ConvCode as JConvCode
from repro.kernels import ref as j_ref
from repro.kernels.acs import acs_forward_pallas
from repro.kernels.ops import pbvd_decode_blocks as j_decode_blocks
from repro_torch.core.codespec import available_code_specs, get_code_spec
from repro_torch.core.pbvd import PBVDConfig
from repro_torch.core.quantize import metric_mode_qmax, norm_interval
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import acs, fused, ref, traceback
from repro_torch.kernels.ops import pbvd_decode_blocks

MODES = ["f32", "i16", "i8"]
B = 5


def _valid_k(code):
    out = []
    for k in range(1, code.v + 1):
        try:
            code.validate_matrix_k(k)
        except ValueError:
            continue
        out.append(k)
    return out


def _t_off(code, k):
    """T ≢ 0 mod k: one k-step, then a trailing radix-2 stage (k = 1: as
    many steps as it takes i8 to min-subtract once)."""
    return norm_interval(code, "i8") if k == 1 else k + 1


# Every spec at every valid k in f32 (integer symbols) at T ≢ 0 mod k;
# T ≡ 0 mod k (one step, T = k) in f32 at k = 2 and 4; the narrow modes at
# T ≢ 0 mod k, at k = 2: i8 on CCSDS and the rate-1/3 code (min-subtract
# every 4 steps and every step), i16 on K = 9.
# The JAX oracle runs once per mother code (a family's four rates share it)
# and each call costs about a second of primitive compiles, so the full
# cross product of specs, k, modes and T would not fit the suite's time.
def _cases(name):
    code = get_code_spec(name).code
    family = name.split("-")[0] if name != "lte-1/3" else "lte"
    out = [(k, "f32", _t_off(code, k)) for k in _valid_k(code)]
    out += [(k, "f32", k) for k in (2, 4) if k in _valid_k(code)]  # after T = k + 1
    out += {"ccsds": [(2, "i8", 3)], "is95": [(2, "i16", 3)], "lte": [(2, "i8", 3)]}[family]
    return out


def _t_norm(code, k, mode):
    """T ≢ 0 mod k spanning three normalization intervals of k-steps, so
    the global ``step % norm_every`` cadence fires against JAX."""
    return 3 * norm_interval(code, mode, stages_per_step=k) * k + 1


CASES = [(name, k, mode, T) for name in available_code_specs() for k, mode, T in _cases(name)]
# the narrow modes at k = 3 and 4, on CCSDS (the JAX oracle compiles once each)
CASES += [("ccsds", k, mode, _t_norm(get_code_spec("ccsds").code, k, mode))
          for mode in ("i8", "i16") for k in (3, 4)]


def _symbols(T, R, seed):
    """int16 symbols far outside every narrow budget: the clip must catch them."""
    return np.random.default_rng(seed).integers(-3000, 3001, (T, R, B)).astype(np.int16)


@functools.lru_cache(maxsize=None)
def _jax_matrix(polys, k, mode, T, seed):
    """JAX acs_forward_ref(impl="matrix") on one mother code (the specs of a
    family share it), or the ValueError it raises."""
    jcode = JConvCode(polys=polys)
    y = _symbols(T, jcode.R, seed)
    try:
        with jax.disable_jit() if k == 4 and T <= k + 1 else contextlib.nullcontext():
            sp, pm = j_ref.acs_forward_ref(jnp.asarray(y), jcode, metric_mode=mode,
                                           impl="matrix", matrix_k=k)
    except ValueError as err:
        return err
    return np.asarray(sp), np.asarray(pm)


@pytest.mark.parametrize("name,k,mode,T", CASES)
def test_acs_forward_matrix_equals_jax(name, k, mode, T):
    code = get_code_spec(name).code
    seed = 31 * k + T
    want = _jax_matrix(code.polys, k, mode, T, seed)
    y = torch.as_tensor(_symbols(T, code.R, seed))
    if isinstance(want, ValueError):  # the i8 budget refuses this k: same message
        with pytest.raises(ValueError) as info:
            ref.acs_forward_ref(y, code, mode, impl="matrix", matrix_k=k)
        assert str(info.value) == str(want)
        return
    sp, pm = acs.acs_forward(y, code, mode, impl="matrix", k=k)  # CPU: the plain version
    np.testing.assert_array_equal(sp.numpy(), want[0])
    assert str(pm.dtype).removeprefix("torch.") == str(want[1].dtype)
    np.testing.assert_array_equal(pm.numpy(), want[1])
    # the same survivor history as the butterfly, by contract
    assert torch.equal(sp, ref.acs_forward_ref(y, code, mode)[0])


@pytest.mark.parametrize("name,k", [("ccsds", 2), ("is95-k9", 3), ("lte-1/3", 2)])
def test_matrix_step_equals_jax(name, k):
    """One step from random (not zero) metrics: every tournament round decides."""
    code, jcode = get_code_spec(name).code, j_get_code_spec(name).code
    rng = np.random.default_rng(k)
    pm = rng.integers(-300, 300, (code.n_states, B)).astype(np.int32)
    ys = rng.integers(-127, 128, (k, code.R, B)).astype(np.int32)
    new, planes = ref._matrix_step(torch.as_tensor(pm), torch.as_tensor(ys), code, k)
    # numpy operands: the reference's static slicing of them costs nothing
    j_new, j_planes = j_ref._matrix_step(pm, ys, jcode, jnp.int32, k)
    np.testing.assert_array_equal(new.numpy(), np.asarray(j_new))
    assert len(planes) == len(j_planes) == k
    for got, want in zip(planes, j_planes):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode,k", [("i8", 3)])
def test_k1_matrix_plain_equals_pallas_interpret(mode, k):
    code, jcode = get_code_spec("ccsds").code, j_get_code_spec("ccsds").code
    T, chunk = 8 * k, 4 * k  # the Pallas kernel takes whole k-steps per stage chunk
    y = np.random.default_rng(k).integers(-127, 128, (T, 2, 100)).astype(np.int8)
    sp_j, pm_j = acs_forward_pallas(jnp.asarray(np.pad(y, ((0, 0), (0, 0), (0, 28)))), jcode,
                                    stage_chunk=chunk, interpret=True, metric_mode=mode,
                                    impl="matrix", k=k)
    acs.launches = acs.matrix_launches = 0
    sp, pm = acs.acs_forward(torch.as_tensor(y), code, mode, impl="matrix", k=k)
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sp_j)[:, :, :100])
    np.testing.assert_array_equal(pm.to(torch.int32).numpy(), np.asarray(pm_j)[:, :100])
    assert (acs.launches, acs.matrix_launches) == (0, 0)


def test_float_symbols_lower_to_the_butterfly():
    code = get_code_spec("ccsds").code
    y = torch.as_tensor(np.random.default_rng(3).normal(size=(23, 2, 6)).astype(np.float32))
    want = ref.acs_forward_ref(y, code)
    for k in (2, 3):
        got = acs.acs_forward(y, code, impl="matrix", k=k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    kw = dict(decode_start=3, n_decode=32, start_state=5)
    assert torch.equal(fused.pbvd_fused(y, code, impl="matrix", k=3, **kw),
                       fused.pbvd_fused(y, code, **kw))
    with pytest.raises(ValueError, match="exceeds the trellis memory"):
        acs.acs_forward(y, code, impl="matrix", k=7)  # k is validated before the lowering


def test_kernel_matrix_table_and_row_signs():
    """The kernels' packed table is the reference's fold index and sign, and
    the row signs they derive from the row index are its codeword signs."""
    for name in ("ccsds", "is95-k9", "lte-1/3"):
        code = get_code_spec(name).code
        for k in _valid_k(code):
            t = code.matrix_acs_tables(k)
            packed = acs.kernel_matrix_table(code, k)
            assert packed.dtype == np.int32 and packed.shape == t["cc"].shape
            np.testing.assert_array_equal(packed >> 1, t["fold_idx"])
            np.testing.assert_array_equal(1 - 2 * (packed & 1), t["fold_sgn"])
            nb = k * code.R
            f = np.arange(1 << (nb - 1))[:, None]
            bits = (f >> (nb - 1 - np.arange(nb))[None, :]) & 1
            np.testing.assert_array_equal(2.0 * bits - 1.0, code.folded_matrix_codeword_signs(k))


def _model_forward_matrix(y, code, k, mode):
    """numpy model of csrc/acs_core.cuh::forward_acs_matrix, one thread at a
    time: y (T, R, B) → (sp (T, W, B) int32, pm (N, B) int64)."""
    T, R, nb_ = y.shape
    N, W = code.n_states, -(-code.n_states // 32)
    ulog, nk, nb = code.v - k, 1 << k, k * R
    norm_every = norm_interval(code, mode, stages_per_step=k)
    qmax = metric_mode_qmax(code, mode) if norm_every else 0
    if qmax:
        y = np.clip(y, -qmax, qmax)
    y = y.astype(np.int64)
    table = acs.kernel_matrix_table(code, k).reshape(-1)
    labels = acs.kernel_labels(code)
    sp = np.zeros((T, W, nb_), np.int64)
    pm_out = np.zeros((N, nb_), np.int64)
    for b in range(nb_):
        pm = np.zeros(N, np.int64)
        n_steps, norm_left = T // k, norm_every
        for r in range(n_steps):
            t = r * k
            rows = [sum(y[t + i, rr, b] if (f >> (nb - 1 - (i * R + rr))) & 1 else -y[t + i, rr, b]
                        for i in range(k) for rr in range(R)) for f in range(1 << (nb - 1))]
            planes = np.zeros((k, W), np.int64)
            new = np.zeros(N, np.int64)
            for s in range(N):
                c, u = s >> ulog, s & ((1 << ulog) - 1)
                cand = []
                for j in range(nk):
                    e = int(table[(((c << k) + j) << ulog) | u])
                    cand.append(pm[(u << k) + j] + (-rows[e >> 1] if e & 1 else rows[e >> 1]))
                for i in range(k):
                    run = 0
                    for h in range(nk >> (i + 1)):
                        d = cand[2 * h + 1] < cand[2 * h]
                        cand[h] = cand[2 * h + 1] if d else cand[2 * h]
                        run |= int(d) << h
                    if c < (2 << i):
                        p = c * (N >> (i + 1)) + (u << (k - 1 - i))
                        planes[i, p >> 5] |= run << (p & 31)
                new[s] = cand[0]
            if norm_every:
                norm_left -= 1
                if norm_left == 0:
                    norm_left = norm_every
                    new -= new.min()
            pm = new
            sp[t : t + k, :, b] = planes
        for t in range(n_steps * k, T):  # the radix-2 stage body
            bm = [sum(y[t, rr, b] if (lab >> (R - 1 - rr)) & 1 else -y[t, rr, b]
                      for rr in range(R)) for lab in range(1 << R)]
            new = np.zeros(N, np.int64)
            word = np.zeros(W, np.int64)
            for s in range(N):
                pe = 2 * (s & (N // 2 - 1))
                m_even, m_odd = pm[pe] + bm[labels[s, 0]], pm[pe + 1] + bm[labels[s, 1]]
                new[s] = m_odd if m_odd < m_even else m_even
                word[s >> 5] |= int(m_odd < m_even) << (s & 31)
            pm = new - new.min() if norm_every else new
            sp[t, :, b] = word
        pm_out[:, b] = pm
    return np.where(sp >= 1 << 31, sp - (1 << 32), sp).astype(np.int32), pm_out


@pytest.mark.parametrize("name,k,mode,T", [("ccsds", 2, "i8", 11), ("ccsds", 4, "i8", 9),
                                           ("lte-1/3", 2, "i16", 5), ("k5", 3, "i16", 13)])
def test_cuda_matrix_loop_model_equals_plain(name, k, mode, T):
    code = (ConvCode(polys=((1, 0, 0, 1, 1), (1, 1, 1, 0, 1))) if name == "k5"
            else get_code_spec(name).code)
    y = np.random.default_rng(T).integers(-127, 128, (T, code.R, 3)).astype(np.int16)
    sp, pm = _model_forward_matrix(y, code, k, mode)
    want_sp, want_pm = ref.acs_forward_ref(torch.as_tensor(y), code, mode, impl="matrix",
                                           matrix_k=k)
    np.testing.assert_array_equal(sp, want_sp.numpy())
    np.testing.assert_array_equal(pm, want_pm.numpy())


@pytest.mark.parametrize("name,k,mode,tb_mode", [("ccsds", 3, "f32", "serial"),
                                                 ("is95-k9", 2, "i8", "prefix")])
def test_fused_plain_matrix_equals_reference_walk(name, k, mode, tb_mode):
    """The JAX fused matrix kernel does not run on this JAX (TPUMemorySpace),
    so the fused plain version is held against JAX ref ACS + serial walk."""
    code, jcode = get_code_spec(name).code, j_get_code_spec(name).code
    T, ds = 12, 2
    rng = np.random.default_rng(k + T)
    y = rng.integers(-127, 128, (T, code.R, 7)).astype(np.int8)
    st = rng.integers(0, code.n_states, 7).astype(np.int32)
    sp_j, _ = j_ref.acs_forward_ref(jnp.asarray(y), jcode, metric_mode=mode, impl="matrix",
                                    matrix_k=k)
    n_window = T - ds  # 10 of 32 packed bits exist; the rest stay 0
    bits = np.asarray(j_ref.traceback_ref(sp_j, jcode, ds, n_window, jnp.asarray(st)))
    bits = np.pad(bits, ((0, 32 - n_window), (0, 0))).astype(np.int64)
    words = (bits.reshape(1, 32, 7) << np.arange(32)[None, :, None]).sum(axis=1)
    want = np.where(words >= 1 << 31, words - (1 << 32), words).astype(np.int32)
    fused.launches = fused.matrix_launches = fused.prefix_launches = 0
    got = fused.pbvd_fused(torch.as_tensor(y), code, decode_start=ds, n_decode=32,
                           start_state=torch.as_tensor(st), metric_mode=mode, tb_mode=tb_mode,
                           tb_chunk=5, impl="matrix", k=k)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (fused.launches, fused.matrix_launches, fused.prefix_launches) == (0, 0, 0)


K31 = ((1,) + (0,) * 29 + (1,), (1,) * 31)  # v = 30: i8 takes k = 3, not 4


@pytest.mark.parametrize(
    "polys,kwargs",
    [(None, dict(acs_k=5)),  # k·R = 10 > 8
     (None, dict(acs_k=7)),  # k > v
     (None, dict(acs_k=0)),
     ("lte", dict(acs_k=3)),  # k·R = 9 > 8
     (K31, dict(acs_k=4, metric_mode="i8")),  # the i8 budget
     (None, dict(tb_chunk=0, tb_mode="prefix"))],
)
def test_knob_errors_match_the_reference(polys, kwargs):
    if polys == "lte":
        make = dict(spec=get_code_spec("lte-1/3")), dict(spec=j_get_code_spec("lte-1/3"))
    elif polys is None:
        make = {}, {}
    else:
        make = dict(code=ConvCode(polys=polys)), dict(code=JConvCode(polys=polys))
    kw = {"acs_impl": "matrix", **kwargs} if "acs_k" in kwargs else kwargs
    with pytest.raises(ValueError) as want:
        JConfig(backend="ref", **make[1], **kw)
    for backend in ("ref", "cuda", "fused"):
        with pytest.raises(ValueError) as got:
            PBVDConfig(backend=backend, **make[0], **kw)
        assert str(got.value) == str(want.value)
    code = PBVDConfig(backend="ref", **make[0]).code if polys else get_code_spec("ccsds").code
    jcode = JConfig(**make[1]).code if polys else j_get_code_spec("ccsds").code
    with pytest.raises(ValueError) as jd:
        j_decode_blocks(jnp.zeros((8, code.R, 1), jnp.int8), jcode, decode_start=0, n_decode=4,
                        backend="ref", **kw)
    with pytest.raises(ValueError) as pd:
        pbvd_decode_blocks(torch.zeros((8, code.R, 1), dtype=torch.int8), code,
                           decode_start=0, n_decode=4, backend="cuda", **kw)
    assert str(pd.value) == str(jd.value)


def test_matrix_ignores_the_radix_and_wrappers_refuse_other_devices():
    code = get_code_spec("ccsds").code
    y = torch.as_tensor(np.random.default_rng(9).integers(-9, 10, (12, 2, 3)).astype(np.int8))
    assert torch.equal(acs.acs_forward(y, code, radix=4, impl="matrix", k=3)[0],
                       acs.acs_forward(y, code, impl="matrix", k=3)[0])
    bits = pbvd_decode_blocks(y, code, decode_start=2, n_decode=8, backend="cuda",
                              acs_impl="matrix", acs_k=3, acs_radix=4)
    assert torch.equal(bits, pbvd_decode_blocks(y, code, decode_start=2, n_decode=8,
                                                backend="ref"))
    # meta tensors take the work counter's branch (launch/cost.py); another device raises
    elsewhere = types.SimpleNamespace(device=torch.device("xpu"))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        acs.acs_forward(elsewhere, code, impl="matrix")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused.pbvd_fused(elsewhere, code, decode_start=0, n_decode=32, impl="matrix")
    meta = torch.empty((12, 2, 3), dtype=torch.int8, device="meta")
    assert acs.acs_forward(meta, code, impl="matrix")[0].device.type == "meta"
    with pytest.raises(ValueError, match="impl must be"):
        acs.acs_forward(y, code, impl="systolic")
    assert traceback.traceback_prefix_plain is ref.traceback_prefix_chunked_ref
