"""A numpy model of the warp body of the port's forward ACS
(``csrc/acs_core.cuh::forward_acs_warp``), run lane by lane on the CPU.

The CUDA kernels cannot run here, so their index arithmetic is modelled the
way the C++ computes it: the compile-time labels of ``MotherCode::label``,
the slot map (slot ``q = sub << log2 S | i`` holds state ``rot(q, p)``
before the stage at phase ``p``), the folded (index, sign) of each label,
the per-lane label mask applied by negating symbols, the in-lane and
cross-lane butterflies with the tie-break, the survivor words assembled at
compile-time bit positions, shifted by the lane's share and or-ed over the
lanes that share them, the block minimum over registers and lanes, and the
fused kernel's ``[t][w][g]`` history walked by one thread per block. The
model is held against ``acs_forward_ref`` of the port and of ``repro`` and
against ``pbvd_fused_ref``; ``chip_smoke.py`` holds the kernels themselves
against the plain versions on the card.
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.kernels import ref as j_ref
from repro_torch.core.codespec import available_code_specs, get_code_spec
from repro_torch.core.quantize import metric_mode_qmax, norm_interval
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import acs, fused
from repro_torch.kernels.ref import acs_forward_ref, pbvd_fused_ref

K5 = ConvCode(polys=((1, 0, 0, 1, 1), (1, 1, 1, 0, 1)))  # (2,1,5): the runtime-table body
MOTHERS = {"ccsds": "ccsds", "is95-k9": "is95-k9", "lte-1/3": "lte-1/3"}
STATES = {"ccsds": (64, 32, 16), "is95-k9": (64, 32), "lte-1/3": (64, 32, 16)}
MODES = ["f32", "i16", "i8"]


# ---- the compile-time tables, written as the C++ computes them ---------------------


def poly_ints(code: ConvCode) -> list[int]:
    """Generator polynomials as integers, bit K-1 the input tap (the
    template arguments of ``MotherCode``)."""
    return [int(sum(bit << (code.K - 1 - i) for i, bit in enumerate(p))) for p in code.polys]


def parity(x: int) -> int:
    p = 0
    while x:
        p ^= x & 1
        x >>= 1
    return p


def label(code: ConvCode, s: int, bit: int) -> int:
    """``MotherCode::label``: the R-bit label of the branch into target s from
    its even (bit 0) or odd (bit 1) predecessor."""
    v, N = code.v, code.n_states
    pred = 2 * (s & (N // 2 - 1)) + bit
    x = s >> (v - 1)
    c = 0
    for g in poly_ints(code):
        c = (c << 1) | (parity(pred & g & (N - 1)) ^ (x & (g >> v) & 1))
    return c


def rot(code: ConvCode, q: int, k: int) -> int:
    """``MotherCode::rot``: q rotated right by k over v bits."""
    v, N = code.v, code.n_states
    k %= v
    return q if k == 0 else ((q >> k) | (q << (v - k))) & (N - 1)


def fold(R: int, c: int) -> tuple[int, int]:
    """``bm_of``: (folded row, sign) of label c."""
    nf = 1 << (R - 1)
    return (c, 1) if c < nf else (c ^ (2 * nf - 1), -1)


class WarpMap:
    """``WarpMap<Code, S>``."""

    def __init__(self, code: ConvCode, S: int):
        N = code.n_states
        if N < 32:
            raise ValueError("the word assembly assumes whole 32-bit words")
        if S & (S - 1) or not 2 <= S <= N or N // S > 32:
            raise ValueError(f"S={S} is not a power of two in [2, N] with N/S <= 32")
        self.code, self.S, self.L = code, S, N // S
        self.log_s, self.log_l = S.bit_length() - 1, (N // S).bit_length() - 1

    def sub_pos(self, k: int, p: int) -> int:
        return (self.log_s + k - p - 1) % self.code.v

    def below(self, p: int) -> int:
        return sum(1 << k for k in range(self.log_l) if self.sub_pos(k, p) < 5)

    def words(self, p: int) -> int:
        m = 0
        for i in range(self.S):
            m |= 1 << (rot(self.code, i, p + 1) >> 5)
        return m

    def lane(self, sub: int, p: int) -> tuple[int, int, int, int]:
        """(flip, shift, word offset, rank) of lane ``sub`` at phase p."""
        ls = rot(self.code, sub << self.log_s, p + 1)
        rank, j = 0, 0
        for k in range(self.log_l):
            if (self.below(p) >> k) & 1:
                rank |= ((sub >> k) & 1) << j
                j += 1
        return label(self.code, ls, 0), ls & 31, ls >> 5, rank


# ---- the warp body, lane by lane ----------------------------------------------------


def warp_forward(code, y, mode="f32", radix=2, S=32, store=None):
    """The warp body over y (T, R, B) numpy symbols. Returns (sp (T, W, B)
    int32, pm (N, B)) and calls ``store(t, w, sub, word)`` for each word a
    lane stores (word: (B,) uint32 of the blocks)."""
    m = WarpMap(code, S)
    T, R, B = y.shape
    N, v, W, L = code.n_states, code.v, -(-code.n_states // 32), m.L
    spp = 2 if radix == 4 else 1
    norm_every = norm_interval(code, mode, radix)
    y = y.astype(np.float32 if y.dtype == np.float32 else np.int64)
    if norm_every:  # clipped after widening
        qm = metric_mode_qmax(code, mode)
        y = np.clip(y, -qm, qm)
    acc = np.float32 if y.dtype == np.float32 else np.int64
    pm = np.zeros((L, S, B), dtype=acc)  # pm[sub, i]: register i of lane sub
    sp = np.zeros((T, W, B), dtype=np.int64)
    stored = np.zeros((T, W), dtype=np.int64)
    lanes = [[m.lane(sub, p) for p in range(v)] for sub in range(L)]

    def stage(p, yt, t):
        yy = np.stack([np.stack([-yt[r] if (lanes[sub][p][0] >> (R - 1 - r)) & 1 else yt[r]
                                 for r in range(R)]) for sub in range(L)])  # (L, R, B)
        rows = []
        for f in range(1 << (R - 1)):
            a = yy[:, 0] if (f >> (R - 1)) & 1 else -yy[:, 0]
            for r in range(1, R):
                a = a + (yy[:, r] if (f >> (R - 1 - r)) & 1 else -yy[:, r])
            rows.append(a)

        def bm(c):
            f, sgn = fold(R, c)
            return rows[f] if sgn > 0 else -rows[f]

        part = np.zeros((L, W, B), dtype=np.uint64)
        if p < m.log_s:  # both slots of each pair in the lane
            for h in range(S // 2):
                i0 = ((h >> p) << (p + 1)) | (h & ((1 << p) - 1))
                i1 = i0 | (1 << p)
                pe, po = pm[:, i0].copy(), pm[:, i1].copy()
                for slot in (i0, i1):
                    s = rot(code, slot, p + 1)
                    me, mo = pe + bm(label(code, s, 0)), po + bm(label(code, s, 1))
                    d = mo < me
                    pm[:, slot] = np.where(d, mo, me)
                    part[:, s >> 5] |= d.astype(np.uint64) << np.uint64(s & 31)
        else:  # the partner is register i of the lane across sub bit k
            k = p - m.log_s
            subs = np.arange(L)
            x = ((subs >> k) & 1).astype(bool)[:, None]
            for i in range(S):
                s = rot(code, i, p + 1)
                mine, theirs = pm[:, i], pm[subs ^ (1 << k), i]  # the shuffle
                pe, po = np.where(x, theirs, mine), np.where(x, mine, theirs)
                me, mo = pe + bm(label(code, s, 0)), po + bm(label(code, s, 1))
                d = mo < me
                pm[:, i] = np.where(d, mo, me)
                part[:, s >> 5] |= d.astype(np.uint64) << np.uint64(s & 31)
        words, below = m.words(p), m.below(p)
        gs = 1 << bin(below).count("1")
        for w in range(W):
            if not (words >> w) & 1:
                continue
            word = np.stack([part[sub, w] << np.uint64(lanes[sub][p][1]) for sub in range(L)])
            for kk in range(m.log_l):  # shuffle-xor over the lanes that share it
                if (below >> kk) & 1:
                    word = word | word[np.arange(L) ^ (1 << kk)]
            ord_ = bin(words & ((1 << w) - 1)).count("1")
            for sub in range(L):
                if lanes[sub][p][3] == ord_ % gs:
                    ww = w | lanes[sub][p][2]
                    assert int(word[sub].max(initial=0)) < 1 << 32
                    sp[t, ww] = word[sub]
                    stored[t, ww] += 1
                    if store is not None:
                        store(t, ww, sub, word[sub])

    def normalize():
        mn = pm.min(axis=1)  # over the lane's registers, then the shuffle rounds
        for kk in range(m.log_l):
            mn = np.minimum(mn, mn[np.arange(L) ^ (1 << kk)])
        assert (mn == mn[0]).all()
        pm[...] -= mn[:, None]

    norm_left = norm_every
    for t0 in range(0, T, v):  # blocks of v stages, the last one guarded
        for p0 in range(0, v, spp):
            t = t0 + p0
            if t + spp <= T:
                for i in range(spp):
                    stage(p0 + i, y[t + i], t + i)
                if norm_every:
                    norm_left -= 1
                    if norm_left == 0:
                        normalize()
                        norm_left = norm_every
            elif spp == 2 and t < T:  # trailing radix-2 stage; narrow normalizes
                stage(p0, y[t], t)
                if norm_every:
                    normalize()
    assert (stored == 1).all(), "each survivor word stored exactly once"
    out = np.zeros((N, B), dtype=acc)
    ph = T % v
    for sub in range(L):
        for i in range(S):
            out[rot(code, i, ph) | rot(code, sub << m.log_s, ph)] = pm[sub, i]
    sp = np.where(sp >= 1 << 31, sp - (1 << 32), sp).astype(np.int32)
    return sp, out


def _symbols(code, T, B, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.float32:
        return (rng.normal(size=(T, code.R, B)) * 2).astype(np.float32)
    return rng.integers(-127, 128, (T, code.R, B)).astype(dtype)


def _budget_refuses(code, mode, radix):
    try:
        norm_interval(code, mode, radix)
    except ValueError:
        return True
    return False


# ---- tests ------------------------------------------------------------------------------


@pytest.mark.parametrize("name", available_code_specs())
def test_compile_time_labels_equal_kernel_labels(name):
    """Every registered spec runs a mother code with a warp-body
    instantiation, and its derived labels are the kernel's and the
    reference's butterfly codewords."""
    code = get_code_spec(name).code
    assert acs.kernel_body(code) == "warp"
    mother = acs.WARP_CODES[acs.warp_code_id(code)]
    derived = np.array([[label(mother, s, b) for b in (0, 1)] for s in range(code.n_states)])
    np.testing.assert_array_equal(derived, acs.kernel_labels(code))
    jt = j_get_code_spec(name).code.acs_tables
    j_labels = np.stack([np.concatenate([jt["cw_top_even"], jt["cw_bot_even"]]),
                         np.concatenate([jt["cw_top_odd"], jt["cw_bot_odd"]])], axis=1)
    np.testing.assert_array_equal(derived, j_labels)
    # the folded (index, sign) of every label is the code's fold table
    for c in range(1 << code.R):
        assert fold(code.R, c) == (code.fold_index[c], code.fold_sign[c])


@pytest.mark.parametrize("polys", [K5.polys, ((1, 1, 0, 1, 1, 1), (1, 0, 1, 0, 0, 1)),
                                   ((1, 1, 1, 1, 0, 0, 1), (1, 0, 1, 1, 0, 1, 1),
                                    (1, 1, 1, 0, 1, 0, 1), (1, 0, 0, 0, 0, 0, 1))])
def test_other_codes_take_the_runtime_table_body(polys):
    code = ConvCode(polys=polys)
    assert acs.warp_code_id(code) == 0 and acs.kernel_body(code) == "table"
    with pytest.raises(ValueError, match="runtime-table"):
        acs.warp_states(code)
    if code.n_states < 32:
        with pytest.raises(ValueError, match="whole 32-bit words"):
            WarpMap(code, 16)


@pytest.mark.parametrize("name", list(MOTHERS))
def test_slot_map(name):
    """The in-place butterfly: each phase pairs the slots that differ in bit
    p, the even predecessor in the slot with bit p clear, both targets go
    back into the pair, and after v stages every state is home again."""
    code = get_code_spec(name).code
    N, v = code.n_states, code.v
    state = list(range(N))  # state[q] before phase 0
    for p in range(v):
        assert state == [rot(code, q, p) for q in range(N)]
        new = [None] * N
        for q in range(N):
            if q >> p & 1:
                continue
            q1 = q | 1 << p
            even, odd = state[q], state[q1]
            assert even % 2 == 0 and odd == even + 1
            for slot, x in ((q, 0), (q1, 1)):
                new[slot] = (x << (v - 1)) | (even >> 1)
                assert new[slot] == rot(code, slot, p + 1)
                assert 2 * (new[slot] & (N // 2 - 1)) == even
        state = new
    assert state == list(range(N))


@pytest.mark.parametrize("name", list(MOTHERS))
def test_lane_masks_and_word_groups(name):
    """A label is linear in the target state, so a lane's share adds one
    mask per phase; the lanes that share a word are those that differ in
    the sub bits landing below bit 5, and one of them stores it."""
    code = get_code_spec(name).code
    rng = np.random.default_rng(3)
    for S in STATES[name]:
        m = WarpMap(code, S)
        for p in range(code.v):
            for sub in range(m.L):
                flip, shift, woff, _ = m.lane(sub, p)
                ls = rot(code, sub << m.log_s, p + 1)
                assert shift | woff << 5 == ls
                for i in rng.integers(0, S, 8):
                    s_reg = rot(code, int(i), p + 1)
                    assert s_reg & ls == 0 and rot(code, (sub << m.log_s) | int(i), p + 1) == s_reg | ls
                    for bit in (0, 1):
                        assert label(code, s_reg | ls, bit) == label(code, s_reg, bit) ^ flip


@pytest.mark.parametrize("radix", [2, 4])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(MOTHERS))
def test_warp_model_equals_reference(name, mode, radix):
    """Every S variant, odd T (radix 4 ends in a trailing radix-2 stage), a
    batch that is no multiple of 32: survivor words and final metrics equal
    the port's plain version; the default S also equals ``repro``'s."""
    code = get_code_spec(name).code
    if _budget_refuses(code, mode, radix):
        with pytest.raises(ValueError):
            warp_forward(code, np.zeros((4, code.R, 3), np.int8), mode, radix)
        return
    T, B = (21 if radix == 4 else 19), 37
    dtype = np.float32 if mode == "f32" and name == "lte-1/3" else np.int8
    y = _symbols(code, T, B, dtype, seed=T + len(name))
    sp_p, pm_p = acs_forward_ref(torch.as_tensor(y), code, mode, radix)
    for S in STATES[name]:
        sp, pm = warp_forward(code, y, mode, radix, S)
        np.testing.assert_array_equal(sp, sp_p.numpy(), err_msg=f"S={S}")
        np.testing.assert_array_equal(pm, pm_p.numpy().astype(pm.dtype), err_msg=f"S={S}")
    sp_j, pm_j = j_ref.acs_forward_ref(jnp.asarray(y), j_get_code_spec(name).code,
                                       metric_mode=mode, radix=radix)
    np.testing.assert_array_equal(np.asarray(sp_j), sp_p.numpy())
    np.testing.assert_array_equal(np.asarray(pm_j).astype(pm.dtype), pm)


@pytest.mark.parametrize("T", [1, 2, 7])
def test_warp_model_short_blocks(T):
    """T below one block of v stages: every stage is in the guarded tail."""
    code = get_code_spec("ccsds").code
    y = _symbols(code, T, 5, np.int8, seed=T)
    sp_p, pm_p = acs_forward_ref(torch.as_tensor(y), code, "i8", 4)
    for S in STATES["ccsds"]:
        sp, pm = warp_forward(code, y, "i8", 4, S)
        np.testing.assert_array_equal(sp, sp_p.numpy())
        np.testing.assert_array_equal(pm, pm_p.numpy().astype(np.int64))


@pytest.mark.parametrize("S", [64, 32, 16])
def test_fused_history_layout(S):
    """The fused kernel's history, word (t, w) of block g at (t*W + w)*G + g:
    a warp's stores of one word fall on distinct banks, and one thread per
    block walking it gives ``pbvd_fused_ref``'s packed bits."""
    code = get_code_spec("ccsds").code
    N, W = code.n_states, 2
    T, ds, nd = 45, 6, 32
    G, smem = fused.smem_plan(T, N, decode_start=ds, n_decode=nd, lanes=N // S)
    B = 2 * G + 3  # two full CTAs and a ragged one
    y = _symbols(code, T, B, np.int8, seed=S)
    start = np.random.default_rng(S).integers(0, N, B)
    hist = np.zeros(((B + G - 1) // G, T * W * G), dtype=np.uint64)
    gw = min(G, 32 // (N // S))

    def store(t, w, sub, word):
        lanes = [sub * gw + g % gw for g in range(G)]  # the lanes storing this word
        banks = [((t * W + w) * G + g) % 32 for g in range(G)]
        assert len(set(zip(lanes, banks))) == G and len(set(banks)) == min(G, 32)
        for b in range(B):
            hist[b // G, (t * W + w) * G + b % G] = word[b]

    warp_forward(code, y, "f32", 2, S, store=store)
    want = pbvd_fused_ref(torch.as_tensor(y), code, decode_start=ds, n_decode=nd,
                          start_state=torch.as_tensor(start, dtype=torch.int32)).numpy()
    got = np.zeros((nd // 32, B), dtype=np.int64)
    for b in range(B):  # fused.cu::fused_tail, serial walk
        h, g = hist[b // G], b % G
        state, word = int(start[b]), 0
        for st in range(T - 1, ds - 1, -1):
            bi = st - ds
            if bi < nd:
                word |= (state >> (code.v - 1)) << (bi & 31)
                if bi & 31 == 0:
                    got[bi >> 5, b], word = word, 0
            if st == ds:
                break
            sw = int(h[(st * W + (state >> 5)) * G + g])
            state = ((state & (N // 2 - 1)) << 1) | ((sw >> (state & 31)) & 1)
    got = np.where(got >= 1 << 31, got - (1 << 32), got)
    np.testing.assert_array_equal(got, want)
    assert smem == 4 * G * T * W


@pytest.mark.parametrize("S, G, ctas", [(64, 16, 3), (32, 16, 3), (16, 4, 11)])
def test_fused_smem_plan_warp_body(S, G, ctas):
    """At the main shapes (CCSDS, T = 596) the planner keeps 44-48
    histories of 4,768 B resident per SM."""
    got_g, smem = fused.smem_plan(596, 64, lanes=64 // S)
    assert (got_g, smem) == (G, 4 * G * 596 * 2)
    assert fused.residency(got_g, smem, 64 // S)[0] == ctas
    with pytest.raises(ValueError, match="shared memory"):
        fused.smem_plan(30000, 256, lanes=4)


class _FakeLib:
    """A stand-in for the built library's label export."""

    _name = "fake"

    def __init__(self, labels):
        self.labels = labels

    def pbvd_acs_code_labels(self, cid, out):
        flat = self.labels.reshape(-1)
        for i, x in enumerate(flat):
            out[i] = int(x)
        return self.labels.shape[0]


def test_label_check_before_launch():
    """The wrapper holds the instantiation's labels against kernel_labels
    and raises on a difference; a code without an instantiation is id 0."""
    code = get_code_spec("lte-1/3").code
    acs._checked.clear()
    good = acs.kernel_labels(code)
    assert acs.check_warp_labels(_FakeLib(good), "pbvd_acs_code_labels", code) == 3
    acs._checked.clear()
    bad = good.copy()
    bad[5, 1] ^= 1
    with pytest.raises(RuntimeError, match="compile-time labels"):
        acs.check_warp_labels(_FakeLib(bad), "pbvd_acs_code_labels", code)
    assert acs.check_warp_labels(_FakeLib(bad), "pbvd_acs_code_labels", K5) == 0
    acs._checked.clear()


def test_states_per_thread_argument():
    code = get_code_spec("is95-k9").code
    assert acs.warp_states(code) == (64, 32)
    assert acs.warp_states_arg(code, None) == 64
    with pytest.raises(ValueError, match="built for S"):
        acs.warp_states_arg(code, 16)
    y = torch.zeros((5, 2, 3), dtype=torch.int8)  # CPU tensors run the plain version
    sp, _ = acs.acs_forward(y, code, states_per_thread=32)
    assert sp.shape == (5, 8, 3)
