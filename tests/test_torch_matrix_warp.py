"""A numpy model of the matrix warp body of the port's K1-matrix and fused
matrix variant (``csrc/acs_core.cuh::WarpMatrix``,
``forward_acs_matrix_warp``), run lane by lane on the CPU.

The CUDA kernels cannot run here, so their index arithmetic is modelled the
way the C++ computes it: the compile-time k-stage labels of
``MotherCode::mlabel`` (held against ``kernel_matrix_table``), the slot
groups of each phase (the 2^k slots that differ in slot bits p .. p+k-1 mod
v, register bits by renaming, lane bits by one shuffle per gathered metric),
candidate indices e with predecessor j = e ^ c_lane, the per-lane label mask
applied by negating the window's symbols, the folded rows, the suffix-min
tournament with its lane-bit orientation and strict ``<`` on the odd
candidate, the one decision each slot emits per round (the state the
butterfly's slot would hold, so the warp body's word assembly is reused),
the global min-subtract cadence of k-steps, the T mod k trailing radix-2
stages, and the fused kernel's ``[t][w][g]`` history walked by one thread
per block. The model is held against ``acs_forward_ref(impl="matrix")`` of
the port and of ``repro`` and against ``repro``'s ``traceback_ref``;
``chip_smoke.py`` phases 10, 12 and 13 hold the kernels themselves against
the plain versions on the card.
"""

from __future__ import annotations

import contextlib
import functools
from math import gcd

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.codespec import get_code_spec as j_get_code_spec
from repro.kernels import ref as j_ref
from repro_torch.core.codespec import get_code_spec
from repro_torch.core.quantize import metric_mode_qmax, norm_interval
from repro_torch.core.trellis import ConvCode
from repro_torch.kernels import acs, fused
from repro_torch.kernels.ref import acs_forward_ref
from test_torch_acs_layout import WarpMap, fold, label, rot

K5 = ConvCode(polys=((1, 0, 0, 1, 1), (1, 1, 1, 0, 1)))  # (2,1,5): the runtime-table body
MOTHERS = ("ccsds", "is95-k9", "lte-1/3")
MODES = ("f32", "i16", "i8")


def built_k(code: ConvCode) -> list[int]:
    """Every k that validate_matrix_k and the CUDA limit of 4 allow."""
    out = []
    for k in range(1, 5):
        try:
            code.validate_matrix_k(k)
        except ValueError:
            continue
        out.append(k)
    return out


CODE_K = [(name, k) for name in MOTHERS for k in built_k(get_code_spec(name).code)]


# ---- the compile-time tables, written as the C++ computes them ---------------------


def output(code: ConvCode, s: int, x: int) -> int:
    """``MotherCode::output``: the encoder output from state s with input x."""
    return label(code, (x << (code.v - 1)) | (s >> 1), s & 1)


def mlabel(code: ConvCode, k: int, c: int, j: int, u: int) -> int:
    """``MotherCode::mlabel``: the kR-bit label of the path from predecessor
    2^k·u + j into target c·U + u, stage t in the MSBs."""
    U, lab = code.n_states >> k, 0
    for i in range(k):
        s = ((c & ((1 << i) - 1)) * U + u) * (1 << (k - i)) + (j >> i)
        lab = (lab << code.R) | output(code, s, (c >> i) & 1)
    return lab


def matrix_table(code: ConvCode, k: int) -> np.ndarray:
    """``write_matrix_table``: [c][j][u] = 2·fold_idx + (fold_sgn < 0)."""
    nk, U, nb = 1 << k, code.n_states >> k, k * code.R
    out = np.zeros((nk, nk, U), dtype=np.int32)
    for c in range(nk):
        for j in range(nk):
            for u in range(U):
                f, sgn = fold(nb, mlabel(code, k, c, j, u))
                out[c, j, u] = 2 * f + (sgn < 0)
    return out


class MatrixMap:
    """The compile-time functions of ``WarpMatrix<Code, S, k>``."""

    def __init__(self, code: ConvCode, S: int, k: int):
        self.map = WarpMap(code, S)
        self.code, self.S, self.k = code, S, k
        self.v, self.L, self.log_s = code.v, self.map.L, self.map.log_s
        self.nk, self.nb, self.U = 1 << k, k * code.R, code.n_states >> k
        self.block = code.v // gcd(code.v, k) * k

    def pos(self, P, i):
        return (P + i) % self.v

    def lane_bit(self, P, i):
        return self.pos(P, i) >= self.log_s

    def step_regs(self, P):
        return sum(1 << self.pos(P, i) for i in range(self.k) if not self.lane_bit(P, i))

    def n_groups(self, P):
        return self.S >> bin(self.step_regs(P)).count("1")

    def reg_of(self, P, g, e):
        r, b = 0, 0
        for bit in range(self.log_s):
            if not (self.step_regs(P) >> bit) & 1:
                r |= ((g >> b) & 1) << bit
                b += 1
        for i in range(self.k):
            if not self.lane_bit(P, i):
                r |= ((e >> i) & 1) << self.pos(P, i)
        return r

    def dsub_of(self, P, e):
        return sum(((e >> i) & 1) << (self.pos(P, i) - self.log_s)
                   for i in range(self.k) if self.lane_bit(P, i))

    def c_of(self, P, I):
        return rot(self.code, I, P + self.k) >> (self.v - self.k)

    def mlab(self, P, I, e):
        n = rot(self.code, I, P + self.k)
        return mlabel(self.code, self.k, n >> (self.v - self.k), e, n & (self.U - 1))

    def lane_mflip(self, sub, P):
        n = rot(self.code, sub << self.log_s, P + self.k)
        c = n >> (self.v - self.k)
        return mlabel(self.code, self.k, c, c, n & (self.U - 1))


# ---- the matrix warp body, lane by lane ----------------------------------------------


def matrix_warp_forward(code, y, k, mode="f32", S=None, store=None):
    """The matrix warp body over y (T, R, B) integer numpy symbols. Returns
    (sp (T, W, B) int32, pm (N, B)) and calls ``store(t, w, sub, word)`` for
    each word a lane stores (word: (B,) of the blocks)."""
    S = acs.matrix_states(code, k) if S is None else S
    mm = MatrixMap(code, S, k)
    wm = mm.map
    T, R, B = y.shape
    N, v, W, L = code.n_states, code.v, -(-code.n_states // 32), mm.L
    subs = np.arange(L)
    norm_every = norm_interval(code, mode, stages_per_step=k)
    y = y.astype(np.int64)
    if norm_every:  # clipped after widening
        qm = metric_mode_qmax(code, mode)
        y = np.clip(y, -qm, qm)
    pm = np.zeros((L, S, B), dtype=np.int64)  # pm[sub, i]: register i of lane sub
    sp = np.zeros((T, W, B), dtype=np.int64)
    stored = np.zeros((T, W), dtype=np.int64)
    lanes = [[wm.lane(sub, p) for p in range(v)] for sub in range(L)]

    def rows_of(yy, nb):
        """row f of (L, nb, B) signed symbols: ± y_q in q order."""
        rows = []
        for f in range(1 << (nb - 1)):
            a = yy[:, 0] if (f >> (nb - 1)) & 1 else -yy[:, 0]
            for q in range(1, nb):
                a = a + (yy[:, q] if (f >> (nb - 1 - q)) & 1 else -yy[:, q])
            rows.append(a)
        return rows

    def bm(rows, nb, cc):
        f, sgn = fold(nb, cc)
        return rows[f] if sgn > 0 else -rows[f]

    def emit(p, part, t):
        """``WarpAcs::emit<p>``: the words of a phase-p plane, shifted by each
        lane's share, or-ed over the lanes that share them, one store each."""
        words, below = wm.words(p), wm.below(p)
        gs = 1 << bin(below).count("1")
        for w in range(W):
            if not (words >> w) & 1:
                continue
            word = np.stack([part[sub, w] << np.uint64(lanes[sub][p][1]) for sub in range(L)])
            for kk in range(wm.log_l):
                if (below >> kk) & 1:
                    word = word | word[subs ^ (1 << kk)]
            ord_ = bin(words & ((1 << w) - 1)).count("1")
            for sub in range(L):
                if lanes[sub][p][3] == ord_ % gs:
                    ww = w | lanes[sub][p][2]
                    assert int(word[sub].max(initial=0)) < 1 << 32
                    sp[t, ww] = word[sub]
                    stored[t, ww] += 1
                    if store is not None:
                        store(t, ww, sub, word[sub])

    def stage(p, yt, t):
        """``WarpAcs::stage<p>`` (a trailing radix-2 stage)."""
        yy = np.stack([np.stack([-yt[r] if (lanes[sub][p][0] >> (R - 1 - r)) & 1 else yt[r]
                                 for r in range(R)]) for sub in range(L)])
        rows = rows_of(yy, R)
        part = np.zeros((L, W, B), dtype=np.uint64)
        if p < wm.log_s:
            for h in range(S // 2):
                i0 = ((h >> p) << (p + 1)) | (h & ((1 << p) - 1))
                i1 = i0 | (1 << p)
                pe, po = pm[:, i0].copy(), pm[:, i1].copy()
                for slot in (i0, i1):
                    s = rot(code, slot, p + 1)
                    me = pe + bm(rows, R, label(code, s, 0))
                    mo = po + bm(rows, R, label(code, s, 1))
                    d = mo < me
                    pm[:, slot] = np.where(d, mo, me)
                    part[:, s >> 5] |= d.astype(np.uint64) << np.uint64(s & 31)
        else:
            kk = p - wm.log_s
            x = ((subs >> kk) & 1).astype(bool)[:, None]
            for i in range(S):
                s = rot(code, i, p + 1)
                mine, theirs = pm[:, i], pm[subs ^ (1 << kk), i]
                pe, po = np.where(x, theirs, mine), np.where(x, mine, theirs)
                me = pe + bm(rows, R, label(code, s, 0))
                mo = po + bm(rows, R, label(code, s, 1))
                d = mo < me
                pm[:, i] = np.where(d, mo, me)
                part[:, s >> 5] |= d.astype(np.uint64) << np.uint64(s & 31)
        emit(p, part, t)

    def step(P, ywin, t):
        """``WarpMatrix::step<P>``: one k-stage (min,+) step from stage t."""
        flat = ywin.reshape(mm.nb, B)  # stage-major window
        yy = np.stack([np.stack([-flat[q] if (mm.lane_mflip(sub, P) >> (mm.nb - 1 - q)) & 1
                                 else flat[q] for q in range(mm.nb)]) for sub in range(L)])
        rows = rows_of(yy, mm.nb)
        part = np.zeros((k, L, W, B), dtype=np.uint64)
        for g in range(mm.n_groups(P)):
            # gather: register E of lane sub ^ dsub (the shuffle)
            m = [pm[subs ^ mm.dsub_of(P, e), mm.reg_of(P, g, e)] for e in range(mm.nk)]
            out = {}
            for et in range(mm.nk):
                if mm.dsub_of(P, et):
                    continue
                I = mm.reg_of(P, g, et)
                c = [m[e] + bm(rows, mm.nb, mm.mlab(P, I, e)) for e in range(mm.nk)]
                for rd in range(k):
                    hstar = mm.c_of(P, I) >> (rd + 1)
                    s = rot(code, I, P + rd + 1)
                    if mm.lane_bit(P, rd):
                        x = ((subs >> (mm.pos(P, rd) - wm.log_s)) & 1).astype(bool)[:, None]
                    else:
                        x = np.zeros((L, 1), dtype=bool)
                    nxt = []
                    for h in range(len(c) // 2):
                        pe = np.where(x, c[2 * h + 1], c[2 * h])
                        po = np.where(x, c[2 * h], c[2 * h + 1])
                        d = po < pe
                        nxt.append(np.where(d, po, pe))
                        if h == hstar:
                            part[rd, :, s >> 5] |= d.astype(np.uint64) << np.uint64(s & 31)
                    c = nxt
                out[et] = c[0]
            for et, val in out.items():  # after the group's gathers
                pm[:, mm.reg_of(P, g, et)] = val
        for rd in range(k):
            emit(mm.pos(P, rd), part[rd], t + rd)

    def normalize():
        mn = pm.min(axis=1)  # over the lane's registers, then the shuffle rounds
        for kk in range(wm.log_l):
            mn = np.minimum(mn, mn[subs ^ (1 << kk)])
        assert (mn == mn[0]).all()
        pm[...] -= mn[:, None]

    n_load = v if mm.block == v else k  # ``kLoad``: stages per fetch

    def load(t0):
        """the n_load stages from t0, zero past T"""
        out = np.zeros((n_load, R, B), dtype=np.int64)
        n = max(0, min(n_load, T - t0))
        out[:n] = y[t0:t0 + n]
        return out

    yc = load(0)
    norm_left = norm_every
    for t0 in range(0, T, mm.block):  # blocks of lcm(v, k) stages
        for J in range(mm.block // k):
            t, off = t0 + J * k, (J * k) % n_load
            if off == 0:  # the next fetch, one ahead
                yn = load(t + n_load)
            if t + k <= T:
                step((J * k) % v, yc[off:off + k], t)
                if norm_every:
                    norm_left -= 1
                    if norm_left == 0:
                        normalize()
                        norm_left = norm_every
            if off + k == n_load:
                yc = yn
    if T % k:
        yc = load(T - T % k)
    for t in range(T - T % k, T):  # trailing radix-2 stages; narrow normalizes
        stage(t % v, yc[0], t)
        if norm_every:
            normalize()
        yc = np.concatenate([yc[1:], yc[:1]])
    assert (stored == 1).all(), "each survivor word stored exactly once"
    out = np.zeros((N, B), dtype=np.int64)
    ph = T % v
    for sub in range(L):
        for i in range(S):
            out[rot(code, i, ph) | rot(code, sub << wm.log_s, ph)] = pm[sub, i]
    sp = np.where(sp >= 1 << 31, sp - (1 << 32), sp).astype(np.int32)
    return sp, out


def _symbols(code, T, B, seed):
    """int16 symbols beyond every narrow budget: the clip must catch them."""
    return np.random.default_rng(seed).integers(-300, 301, (T, code.R, B)).astype(np.int16)


def _refuses(code, mode, k):
    try:
        norm_interval(code, mode, stages_per_step=k)
    except ValueError:
        return True
    return False


@functools.lru_cache(maxsize=None)
def _jax_matrix(name, k, mode, T, seed):
    """JAX acs_forward_ref(impl="matrix") on a short block, stepping eagerly,
    which costs less than compiling the k-stage step (T < k has no step,
    which eager mode cannot scan)."""
    code = get_code_spec(name).code
    y = _symbols(code, T, 5, seed)
    with jax.disable_jit() if T >= k else contextlib.nullcontext():
        sp, pm = j_ref.acs_forward_ref(jnp.asarray(y), j_get_code_spec(name).code,
                                       metric_mode=mode, impl="matrix", matrix_k=k)
    return y, np.asarray(sp), np.asarray(pm)


def _t_long(code, k, mode):
    """T ≢ 0 mod k past the first narrow min-subtract (i8: past the second)
    and through at least two blocks of lcm(v, k) stages."""
    n = norm_interval(code, mode, stages_per_step=k)
    steps = max(2 * n if mode == "i8" else n, 2 * code.v // gcd(code.v, k))
    return steps * k + (k - 1 if k > 1 else 0)


# ---- tests ------------------------------------------------------------------------------


@pytest.mark.parametrize("name,k", CODE_K)
def test_compile_time_matrix_table_equals_kernel_matrix_table(name, k):
    """``MotherCode::mlabel`` folded as ``write_matrix_table`` writes it is
    the wrapper's table and the reference's ``matrix_acs_tables``."""
    code = get_code_spec(name).code
    np.testing.assert_array_equal(matrix_table(code, k), acs.kernel_matrix_table(code, k))
    jt = j_get_code_spec(name).code.matrix_acs_tables(k)
    np.testing.assert_array_equal(matrix_table(code, k),
                                  2 * jt["fold_idx"] + (jt["fold_sgn"] < 0))


@pytest.mark.parametrize("name,k", CODE_K)
def test_slot_groups(name, k):
    """Each phase's step partitions the slots into groups of 2^k that differ
    in slot bits p .. p+k-1 (mod v): before it candidate e of a group holds
    the predecessor 2^k·u + (e ^ c_lane), after it the lane's target slots
    hold c·U + u, the states the butterfly's slots would hold k stages on,
    each slot a target once; every label is its register-only part xor one
    mask per lane (linearity)."""
    code = get_code_spec(name).code
    mm = MatrixMap(code, acs.matrix_states(code, k), k)
    v, U = code.v, code.n_states >> k
    for J in range(mm.block // k):
        P = (J * k) % v
        targets = []
        for sub in range(mm.L):
            c_lane = rot(code, sub << mm.log_s, P + k) >> (v - k)
            for g in range(mm.n_groups(P)):
                slots = [(sub ^ mm.dsub_of(P, e)) << mm.log_s | mm.reg_of(P, g, e)
                         for e in range(mm.nk)]
                u = rot(code, slots[0], P) >> k
                assert [rot(code, q, P) for q in slots] == [(u << k) | (e ^ c_lane)
                                                            for e in range(mm.nk)]
                for et in range(mm.nk):
                    if mm.dsub_of(P, et):
                        continue
                    I = mm.reg_of(P, g, et)
                    q = sub << mm.log_s | I
                    n = rot(code, q, P + k)
                    assert n & (U - 1) == u and n >> (v - k) == mm.c_of(P, I) ^ c_lane
                    targets.append(q)
                    for e in range(mm.nk):
                        full = mlabel(code, k, n >> (v - k), e ^ c_lane, u)
                        assert full == mm.mlab(P, I, e) ^ mm.lane_mflip(sub, P)
        assert sorted(targets) == list(range(code.n_states))


@pytest.mark.parametrize("name,k", CODE_K)
def test_each_slot_emits_the_butterflys_state(name, k):
    """Round i's decision of the state rot(q, p + i + 1) lies in the
    tournament of slot q's own target (the balanced ownership), at
    candidate-index h = c_reg >> (i + 1): every state of each plane once, so
    the warp body's word masks, shifts and ranks serve every round."""
    code = get_code_spec(name).code
    mm = MatrixMap(code, acs.matrix_states(code, k), k)
    v, N, U = code.v, code.n_states, code.n_states >> k
    for J in range(mm.block // k):
        P = (J * k) % v
        for rd in range(k):
            states = set()
            for q in range(N):
                n = rot(code, q, P + k)
                c, u = n >> (v - k), n & (U - 1)
                h = c >> (rd + 1)
                s_ref = ((c & ((2 << rd) - 1)) * U + u) * (1 << (k - 1 - rd)) + h
                assert s_ref == rot(code, q, P + rd + 1)
                states.add(s_ref)
                I = q & (mm.S - 1)
                assert mm.c_of(P, I) >> (rd + 1) == (h ^ ((c ^ mm.c_of(P, I)) >> (rd + 1)))
            assert states == set(range(N))


@pytest.mark.parametrize("name,k", CODE_K)
def test_lane_masks_and_word_assembly(name, k):
    """The lane masks negate the symbols a lane's share names (BM(cc ^ m) is
    BM(cc) of the flipped window), and one model run stores every word
    exactly once with the warp body's word assembly."""
    code = get_code_spec(name).code
    mm = MatrixMap(code, acs.matrix_states(code, k), k)
    rng = np.random.default_rng(k)
    yw = rng.integers(-50, 51, mm.nb)
    for P in range(code.v):
        for sub in range(mm.L):
            m = mm.lane_mflip(sub, P)
            flipped = np.where([(m >> (mm.nb - 1 - q)) & 1 for q in range(mm.nb)], -yw, yw)
            for cc in rng.integers(0, 1 << mm.nb, 6):
                signs = [1 if (int(cc) >> (mm.nb - 1 - q)) & 1 else -1 for q in range(mm.nb)]
                signs_x = [1 if ((int(cc) ^ m) >> (mm.nb - 1 - q)) & 1 else -1
                           for q in range(mm.nb)]
                assert int(np.dot(signs_x, yw)) == int(np.dot(signs, flipped))
    y = _symbols(code, 2 * mm.block + 1, 3, seed=k)
    matrix_warp_forward(code, y, k)  # asserts one store per word


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,k", CODE_K)
def test_matrix_warp_model_equals_reference(name, k, mode):
    """Survivor words and final metrics of the model equal JAX's
    ``acs_forward_ref(impl="matrix")`` and the port's plain version (int32
    metrics; the narrow modes' values are equal after the cast) at T < k and
    at two steps and the T mod k trailing stages; and the port's plain
    version (held against JAX on long blocks in ``test_torch_matrix.py``) at
    a T ≢ 0 mod k through the narrow modes' min-subtracts and two blocks of
    lcm(v, k) stages."""
    code = get_code_spec(name).code
    if _refuses(code, mode, k):
        with pytest.raises(ValueError):
            matrix_warp_forward(code, np.zeros((k + 1, code.R, 2), np.int8), k, mode)
        return
    for T in sorted({max(1, k - 1), 3 * k - 1 if k > 1 else 3}):
        y, sp_j, pm_j = _jax_matrix(name, k, mode, T, seed=7 * k + T)
        sp, pm = matrix_warp_forward(code, y, k, mode)
        np.testing.assert_array_equal(sp, sp_j, err_msg=f"T={T}")
        np.testing.assert_array_equal(pm, pm_j.astype(np.int64), err_msg=f"T={T}")
    T = _t_long(code, k, mode)
    y = _symbols(code, T, 3, seed=T)
    sp, pm = matrix_warp_forward(code, y, k, mode)
    sp_p, pm_p = acs_forward_ref(torch.as_tensor(y), code, mode, impl="matrix", matrix_k=k)
    np.testing.assert_array_equal(sp, sp_p.numpy(), err_msg=f"T={T}")
    np.testing.assert_array_equal(pm, pm_p.numpy().astype(np.int64), err_msg=f"T={T}")


@pytest.mark.parametrize("S", [64, 32, 16, 8, 4, 2])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_matrix_warp_model_at_other_S(k, S):
    """The index arithmetic holds at every S a block's warp could take, not
    only the one built per (code, k): CCSDS (every split of the step's bits
    between registers and lanes) against the port's plain version."""
    code = get_code_spec("ccsds").code
    mode = "i16" if k % 2 else "f32"
    T = 4 * k + (k > 1)
    y = _symbols(code, T, 4, seed=S + k)
    sp, pm = matrix_warp_forward(code, y, k, mode, S=S)
    sp_p, pm_p = acs_forward_ref(torch.as_tensor(y), code, mode, impl="matrix", matrix_k=k)
    np.testing.assert_array_equal(sp, sp_p.numpy())
    np.testing.assert_array_equal(pm, pm_p.numpy().astype(np.int64))


@pytest.mark.parametrize("name,k,mode", [("ccsds", 2, "f32"), ("ccsds", 3, "i8"),
                                         ("is95-k9", 4, "i16"), ("lte-1/3", 2, "i8")])
def test_fused_history_walk_equals_reference(name, k, mode):
    """The fused kernel's history, word (t, w) of block g at (t*W + w)*G + g,
    filled by the matrix warp body's stores and walked by one thread per
    block, gives JAX ``acs_forward_ref(impl="matrix")`` plus ``traceback_ref``
    (``pbvd_fused_pallas`` with matrix does not run on the installed JAX)."""
    code, jcode = get_code_spec(name).code, j_get_code_spec(name).code
    N, W = code.n_states, -(-code.n_states // 32)
    S = acs.matrix_states(code, k)
    T, ds, nd = 4 * k + 3, 2, 32
    G, smem = fused.smem_plan(T, N, decode_start=ds, n_decode=nd, matrix_k=k, R=code.R,
                              lanes=N // S)
    assert smem == 4 * G * T * W  # nothing beside the history
    B = 2 * G + 1
    rng = np.random.default_rng(k)
    y = _symbols(code, T, B, seed=k + 1)
    start = rng.integers(0, N, B).astype(np.int32)
    hist = np.zeros(((B + G - 1) // G, T * W * G), dtype=np.uint64)

    def store(t, w, sub, word):
        for b in range(B):
            hist[b // G, (t * W + w) * G + b % G] = word[b]

    matrix_warp_forward(code, y, k, mode, store=store)
    with jax.disable_jit():
        sp_j, _ = j_ref.acs_forward_ref(jnp.asarray(y), jcode, metric_mode=mode, impl="matrix",
                                        matrix_k=k)
    n_window = T - ds
    bits = np.asarray(j_ref.traceback_ref(sp_j, jcode, ds, n_window, jnp.asarray(start)))
    bits = np.pad(bits, ((0, nd - n_window), (0, 0))).astype(np.int64)
    want = (bits.reshape(1, nd, B) << np.arange(nd)[None, :, None]).sum(axis=1)
    got = np.zeros((1, B), dtype=np.int64)
    for b in range(B):  # fused.cu::serial_walk
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
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,S,G,ctas", [(2, 32, 16, 3), (3, 32, 16, 3), (4, 16, 4, 11)])
def test_fused_smem_plan_matrix_warp_body(k, S, G, ctas):
    """At the main shapes (CCSDS, T = 596) the matrix warp body adds nothing
    per block: G and residency are the serial warp path's at the same S (48
    blocks per SM at S = 32), where the runtime-table matrix body adds its
    rows, planes and metric slots."""
    assert acs.matrix_states(get_code_spec("ccsds").code, k) == S
    got = fused.smem_plan(596, 64, matrix_k=k, R=2, lanes=64 // S)
    assert got == fused.smem_plan(596, 64, lanes=64 // S) == (G, 4 * G * 596 * 2)
    assert fused.residency(G, got[1], 64 // S)[0] == ctas
    table = fused.smem_plan(596, 64, matrix_k=k, R=2)
    assert table[1] // table[0] == 4 * (596 * 2 + 2 * 64 + 2 + (1 << (2 * k - 1)) + 2 * k)


def test_routing():
    """Which (code, k, tb_mode) takes which body: the mother codes' K1-matrix
    and fused matrix variant (serial or prefix walk) run the matrix warp body
    at its one S; (2,1,5) the runtime-table bodies; float symbols lower to
    the butterfly."""
    for name in MOTHERS:
        code = get_code_spec(name).code
        assert acs.kernel_body(code) == "warp"
        assert fused.kernel_body(code, "serial") == "warp"
        assert fused.kernel_body(code, "prefix") == "warp"
        for k in built_k(code):
            S = acs.matrix_states(code, k)
            assert code.n_states // S <= 32
            assert acs.matrix_states_arg(code, k, None) == acs.matrix_states_arg(code, k, S) == S
            with pytest.raises(ValueError, match="built for"):
                acs.matrix_states_arg(code, k, S // 2)
    assert acs.kernel_body(K5) == "table" and fused.kernel_body(K5) == "table"
    with pytest.raises(ValueError, match="runtime-table matrix body"):
        acs.matrix_states(K5, 2)
    with pytest.raises(ValueError, match="acs_k"):
        acs.matrix_states(get_code_spec("lte-1/3").code, 3)  # k·R = 9 > 8
    assert [built_k(get_code_spec(n).code) for n in MOTHERS] == [[1, 2, 3, 4]] * 2 + [[1, 2]]
    # CPU tensors run the plain versions and count nothing
    acs.matrix_launches = acs.matrix_table_launches = fused.matrix_table_launches = 0
    y = torch.zeros((7, 2, 3), dtype=torch.int8)
    acs.acs_forward(y, get_code_spec("ccsds").code, impl="matrix", k=3)
    fused.pbvd_fused(y, get_code_spec("ccsds").code, decode_start=1, n_decode=32,
                     impl="matrix", k=2)
    assert (acs.matrix_launches, acs.matrix_table_launches, fused.matrix_table_launches) == (0,) * 3


class _FakeLib:
    """A stand-in for the built library's matrix-table export."""

    _name = "fake-matrix"

    def __init__(self, table):
        self.table = table

    def pbvd_acs_code_matrix_table(self, cid, k, out):
        for i, x in enumerate(self.table.reshape(-1)):
            out[i] = int(x)
        return self.table.size


def test_matrix_table_check_before_launch():
    """The wrapper holds the instantiation's matrix table against
    kernel_matrix_table and raises on a difference; a code without an
    instantiation is id 0."""
    code = get_code_spec("is95-k9").code
    good = acs.kernel_matrix_table(code, 3)
    acs._checked.clear()
    assert acs.check_warp_matrix_table(_FakeLib(good), "pbvd_acs_code_matrix_table", code, 3) == 2
    acs._checked.clear()
    bad = good.copy()
    bad[1, 2, 3] ^= 1
    with pytest.raises(RuntimeError, match="compile-time matrix table"):
        acs.check_warp_matrix_table(_FakeLib(bad), "pbvd_acs_code_matrix_table", code, 3)
    assert acs.check_warp_matrix_table(_FakeLib(bad), "pbvd_acs_code_matrix_table", K5, 2) == 0
    acs._checked.clear()
