"""Plain PyTorch references for the port's PBVD kernels.

The counterpart of ``repro.kernels.ref`` on the slice the port covers:

1. ``viterbi_classic_np`` — textbook full-sequence Viterbi (numpy, per-state
   loops). Ground truth for everything.
2. ``acs_forward_ref`` / ``traceback_ref`` — vectorized torch versions of
   the paper's two phases (K1/K2), with the symmetry-folded branch metrics
   and bit-packed survivor words. They repeat the reference's arithmetic
   (same add order, same packing layout, same tie-break), so they are
   bit-exact to ``repro.kernels.ref`` on integer and float symbols, and they
   are the plain versions the CUDA kernels are held against.
3. ``pbvd_decode_ref`` — the block decoder composed of (2), and
   ``pbvd_fused_ref`` — the same decode with the fused kernel's output: the
   decoded bits of the window packed 32 to an int32 word.
4. The k-stage (min,+) matrix ACS (``_matrix_step``,
   ``acs_forward_ref(impl="matrix")``) and the prefix traceback: the
   log-depth oracle ``traceback_prefix_ref`` and the chunked three-phase
   walk ``traceback_prefix_chunked_ref``, the plain version of the CUDA
   prefix kernels.

The metric modes ``"f32"``, ``"i16"`` and ``"i8"``, the radix-2 and radix-4
butterflies, the matrix formulation and the prefix traceback are ported;
other knob values raise ``ValueError``.

Conventions:
  state ``d``; transition with input x: next = (x << (v-1)) | (d >> 1)
  butterfly j: sources 2j (even), 2j+1 (odd); targets j (x=0), j+N/2 (x=1)
  BM(c) = Σ_r y_r (2 c_r - 1)  — minimized (y: received soft symbols,
  BPSK map 0 → +1). Ties select the EVEN predecessor.
  Survivor word layout: SP[stage, word, block] int32, bit (state % 32) of
  word (state // 32) = 1 iff the ODD predecessor was selected for ``state``.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quantize import metric_mode_qmax, norm_interval
from repro_torch.core.trellis import ConvCode

__all__ = [
    "viterbi_classic_np",
    "branch_metric_table",
    "folded_branch_metric_table",
    "expand_folded_bm",
    "folded_radix4_bm_table",
    "expand_folded_radix4_bm",
    "folded_matrix_bm_table",
    "expand_folded_matrix_bm",
    "acs_forward_ref",
    "traceback_ref",
    "stage_maps_ref",
    "traceback_prefix_ref",
    "DEFAULT_TB_CHUNK",
    "prefix_chunk_geometry",
    "traceback_prefix_chunked_ref",
    "pbvd_decode_ref",
    "pbvd_fused_ref",
]


# ---------------------------------------------------------------------------
# Level 1: textbook Viterbi (numpy, slow, ground truth)
# ---------------------------------------------------------------------------
def viterbi_classic_np(
    y: np.ndarray, code: ConvCode, init_state: int | None = 0, final_state: int | None = 0
) -> np.ndarray:
    """Full-sequence ML Viterbi. y: (T, R) soft symbols. Returns (T,) bits.

    init_state/final_state None → unknown (uniform PM / argmin pick).
    """
    T = y.shape[0]
    N = code.n_states
    INF = 1e18
    pm = np.full(N, INF)
    if init_state is None:
        pm[:] = 0.0
    else:
        pm[init_state] = 0.0
    signs = code.codeword_signs  # (2^R, R)
    decisions = np.zeros((T, N), dtype=np.int8)
    for t in range(T):
        bm = signs @ y[t]  # (2^R,)
        new_pm = np.full(N, INF)
        dec = np.zeros(N, dtype=np.int8)
        for j in range(N // 2):
            for tgt, cw_even, cw_odd in (
                (j, code.butterfly_codewords[j, 0], code.butterfly_codewords[j, 2]),
                (j + N // 2, code.butterfly_codewords[j, 1], code.butterfly_codewords[j, 3]),
            ):
                m_even = pm[2 * j] + bm[cw_even]
                m_odd = pm[2 * j + 1] + bm[cw_odd]
                if m_odd < m_even:
                    new_pm[tgt] = m_odd
                    dec[tgt] = 1
                else:
                    new_pm[tgt] = m_even
                    dec[tgt] = 0
        pm = new_pm
        decisions[t] = dec
    state = int(np.argmin(pm)) if final_state is None else int(final_state)
    bits = np.zeros(T, dtype=np.int64)
    for t in range(T - 1, -1, -1):
        bits[t] = state >> (code.v - 1)  # MSB = input bit of transition t
        b = decisions[t, state]
        state = 2 * (state % (N // 2)) + b
    return bits


# ---------------------------------------------------------------------------
# Level 2: vectorized torch K1/K2 references (the kernels' plain versions)
# ---------------------------------------------------------------------------
def _signed_rows(y: torch.Tensor, svals: np.ndarray, dim: int) -> torch.Tensor:
    """Rows of static ±1 sign chains over ``dim``: row k is
    ±y_0 ± y_1 ... added in r order, with no multiply."""
    rows = []
    for k in range(svals.shape[0]):
        acc = None
        for r in range(svals.shape[1]):
            y_r = y.select(dim, r)
            term = y_r if svals[k, r] > 0 else -y_r
            acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows, dim=dim)


def _expand_signed(folded: torch.Tensor, index: np.ndarray, sign: np.ndarray, dim: int):
    gathered = folded.index_select(dim, torch.as_tensor(index, dtype=torch.long,
                                                        device=folded.device))
    shape = [1] * folded.dim()
    shape[dim] = -1
    neg = torch.as_tensor(sign < 0, device=folded.device).reshape(shape)
    return torch.where(neg, -gathered, gathered)


def branch_metric_table(y: torch.Tensor, code: ConvCode) -> torch.Tensor:
    """Full BM table for all 2^R codewords. y: (..., R) → (..., 2^R).

    The paper's group reduction: 2^R metrics per stage, not 2^K. Kept as
    the unfolded reference; the decode paths compute the symmetry-folded
    half table (:func:`folded_branch_metric_table`) and expand it with
    signs.
    """
    signs = torch.as_tensor(code.codeword_signs, device=y.device).to(y.dtype)  # (2^R, R)
    return torch.einsum("...r,cr->...c", y, signs)


def folded_branch_metric_table(y: torch.Tensor, code: ConvCode, dim: int = -1) -> torch.Tensor:
    """Symmetry-folded BM table along ``dim`` (length R → 2^(R-1)).

    The correlation metric is antipodal in the label (BM(~c) = -BM(c)), so
    only the 2^(R-1) fold representatives (labels with MSB 0) are computed,
    each as a static add/sub chain in ``r`` order — no multiplies, so the
    float path is bit-exact to the reference.
    """
    return _signed_rows(y, code.folded_codeword_signs, dim)


def expand_folded_bm(bm_folded: torch.Tensor, code: ConvCode, dim: int = -1) -> torch.Tensor:
    """Folded table (2^(R-1) along ``dim``) → full 2^R table by static signs."""
    return _expand_signed(bm_folded, code.fold_index, code.fold_sign, dim)


def folded_radix4_bm_table(y2: torch.Tensor, code: ConvCode, dim: int = -1) -> torch.Tensor:
    """Combined two-stage folded BM table along ``dim`` (2R → 2^(2R-1)).

    ``y2`` is the stage pair ``[y_t; y_{t+1}]`` concatenated along ``dim``.
    The combined label stays antipodal, so only the 2^(2R-1) fold
    representatives are computed, as static add/sub chains.
    """
    return _signed_rows(y2, code.folded_radix4_codeword_signs, dim)


def expand_folded_radix4_bm(bm2_folded: torch.Tensor, code: ConvCode, dim: int = -1):
    """(2^(2R-1) along ``dim``) combined folded table → full 2^(2R) table."""
    return _expand_signed(bm2_folded, code.fold_index4, code.fold_sign4, dim)


def folded_matrix_bm_table(yk: torch.Tensor, code: ConvCode, k: int, dim: int = -1):
    """Combined k-stage folded BM table along ``dim`` (kR → 2^(kR-1)).

    ``yk`` is the stage window ``[y_t; ...; y_{t+k-1}]`` stacked along
    ``dim``. The combined label stays antipodal, so only the 2^(kR-1) fold
    representatives are computed, as static add/sub chains.
    """
    return _signed_rows(yk, code.folded_matrix_codeword_signs(k), dim)


def expand_folded_matrix_bm(bmk_folded: torch.Tensor, code: ConvCode, k: int, dim: int = -1):
    """(2^(kR-1) along ``dim``) combined folded table → full 2^(kR) table."""
    return _expand_signed(bmk_folded, code.fold_index_matrix(k), code.fold_sign_matrix(k), dim)


def _pack_decisions(dec_bits: torch.Tensor) -> torch.Tensor:
    """dec_bits: (N, B) {0,1} → (ceil(N/32), B) int32, bit (n%32) of word n//32.

    Bit 31 is the int32 sign bit. The words are summed in int64 (exact) and
    wrapped to int32 explicitly, so states 31, 63, … round-trip.
    """
    n, b = dec_bits.shape
    pad = (-n) % 32
    if pad:
        dec_bits = torch.cat([dec_bits, dec_bits.new_zeros((pad, b))], 0)
    d = dec_bits.to(torch.int64).reshape(-1, 32, b)
    shifts = torch.arange(32, dtype=torch.int64, device=d.device)[None, :, None]
    words = (d << shifts).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def _acc_dtype_for(y_dtype: torch.dtype, metric_mode: str) -> torch.dtype:
    """Accumulator/storage dtype of the path metrics for a metric mode:
    ``"f32"`` keeps int32 for integer symbols and float32 for float ones;
    ``"i16"``/``"i8"`` store int16/int8 and need integer symbols."""
    if y_dtype in (torch.int8, torch.int16, torch.int32):
        integer = True
    elif y_dtype == torch.float32:
        integer = False
    else:
        raise ValueError(f"symbols must be int8/int16/int32/float32, got {y_dtype}")
    if metric_mode == "f32":
        return torch.int32 if integer else torch.float32
    if metric_mode not in ("i16", "i8"):
        raise ValueError(f"unknown metric_mode {metric_mode!r}")
    if not integer:
        raise ValueError(
            f"metric_mode={metric_mode!r} needs pre-quantized integer symbols "
            f"(got {str(y_dtype).removeprefix('torch.')}); the engine quantizes within "
            f"the saturation budget (see repro_torch.kernels.registry.METRIC_MODES)"
        )
    return torch.int16 if metric_mode == "i16" else torch.int8


def _radix2_stage(pm: torch.Tensor, bm: torch.Tensor, tabs: dict) -> tuple:
    """One radix-2 butterfly stage. pm (N, B) + bm table (2^R, B) →
    (new_pm (N, B), dec (N, B) int32 odd-predecessor decisions).

    ``tabs`` holds the four codeword index vectors of ``ConvCode.acs_tables``
    as long tensors on ``pm``'s device.
    """
    nb = pm.shape[0] // 2
    pairs = pm.reshape(nb, 2, pm.shape[-1])
    pm_even, pm_odd = pairs[:, 0], pairs[:, 1]
    # top targets j: even pred uses α, odd pred uses γ
    m_te = pm_even + bm[tabs["cw_top_even"]]
    m_to = pm_odd + bm[tabs["cw_top_odd"]]
    dec_top = (m_to < m_te).to(torch.int32)
    pm_top = torch.minimum(m_te, m_to)
    # bottom targets j+N/2: even pred uses β, odd pred uses θ
    m_be = pm_even + bm[tabs["cw_bot_even"]]
    m_bo = pm_odd + bm[tabs["cw_bot_odd"]]
    dec_bot = (m_bo < m_be).to(torch.int32)
    pm_bot = torch.minimum(m_be, m_bo)
    return torch.cat([pm_top, pm_bot], 0), torch.cat([dec_top, dec_bot], 0)


def _interleave_rows(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Q, B) pairs → (2Q, B): row 2q from ``a``, row 2q+1 from ``b``."""
    return torch.stack([a, b], dim=1).reshape(2 * a.shape[0], a.shape[1])


def _radix4_step(
    pm: torch.Tensor,
    bm_a: torch.Tensor,
    bm_b: torch.Tensor,
    y0: torch.Tensor,
    y1: torch.Tensor,
    code: ConvCode,
    tabs: dict,
    combine: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One stage-fused radix-4 ACS step (two trellis stages).

    pm (N, B) at time t; ``bm_a``/``bm_b`` the full branch-metric tables
    (2^R, B) of stages t and t+1, ``y0``/``y1`` their symbols (R, B), all in
    the accumulator dtype. Returns (new_pm at time t+2, dec1, dec2): the two
    STANDARD radix-2 survivor bit-planes of stages t and t+1.

    The staged form (default, and always for float) is the identical op
    sequence as two radix-2 stages — ``(pm + bm_a)``, compare-select, then
    ``+ bm_b`` — so it is bit-exact even in IEEE float. ``combine=True``
    (integer accumulators only) adds the combined 2^(2R-1)-folded two-stage
    metric once per candidate and runs the 4-way tournament: exact because
    integer addition is associative and, within a fixed intermediate, the
    stage-(t+1) term is a common offset to both compared candidates.
    """
    if not combine or pm.is_floating_point():
        pm1, dec1 = _radix2_stage(pm, bm_a, tabs)
        new_pm, dec2 = _radix2_stage(pm1, bm_b, tabs)
        return new_pm, dec1, dec2
    N, B = pm.shape
    pm4 = pm.reshape(N // 4, 4, B)
    y2 = torch.cat([y0, y1], dim=0)  # (2R, B)
    bm2 = expand_folded_radix4_bm(folded_radix4_bm_table(y2, code, dim=0), code, dim=0)
    cc = tabs["cc"]  # (4, 4, Q) combined labels
    d1, l1 = {}, {}
    for k in range(4):
        cand = [pm4[:, j] + bm2[cc[k, j]] for j in range(4)]
        for bm_bit in (0, 1):
            even, odd = cand[2 * bm_bit], cand[2 * bm_bit + 1]
            d1[k, bm_bit] = (odd < even).to(torch.int32)
            l1[k, bm_bit] = torch.minimum(even, odd)
    outs, d2 = [], []
    for k in range(4):
        d2.append((l1[k, 1] < l1[k, 0]).to(torch.int32))
        outs.append(torch.minimum(l1[k, 0], l1[k, 1]))
    # stage-t plane: groups k=0/1 cover intermediates [0, N/2)/[N/2, N)
    # (groups 2/3 would duplicate them); stage-(t+1) plane is in group order
    dec1 = torch.cat([_interleave_rows(d1[0, 0], d1[0, 1]),
                      _interleave_rows(d1[1, 0], d1[1, 1])], dim=0)
    return torch.cat(outs, dim=0), dec1, torch.cat(d2, dim=0)


def _matrix_step(pm: torch.Tensor, ys: torch.Tensor, code: ConvCode, k: int) -> tuple:
    """One k-stage (min,+) matrix ACS step (integer accumulators only).

    pm (N, B) at time t; ys (k, R, B) symbols of stages t..t+k-1 in the
    accumulator dtype. Returns (new_pm (N, B) at time t+k, [dec_0 ..
    dec_{k-1}]), dec_i the standard radix-2 survivor plane of stage t+i.

    Target ``n' = c·U + u`` (U = N/2^k) has the 2^k predecessors
    ``2^k·u + j``; its candidates are ``pm[2^k·u + j] + BMk(cc[c, j, u])``
    with BMk from the 2^(kR-1) folded combined metrics. A suffix-min
    tournament from j's LSB reduces them; round i compares ``j = 2h`` with
    ``2h + 1`` (strict ``<`` on the odd one, so ties keep the even) and its
    decisions are the stage-(t+i) plane, read off the groups c < 2^(i+1)
    at state ``c·N/2^(i+1) + u·2^(k-1-i) + h``. Exact because integer
    addition is associative and the later stages' terms are a common
    offset to both compared candidates; float never reaches here (the
    callers lower float to the radix-2 butterfly).
    """
    if pm.is_floating_point():
        raise ValueError("_matrix_step is integer-exact only; float lowers to radix 2")
    N, B = pm.shape
    nk = 1 << k
    U = N >> k
    yk = ys.reshape(k * code.R, B)  # stage-major stack [y_t; ...; y_{t+k-1}]
    bmk = expand_folded_matrix_bm(folded_matrix_bm_table(yk, code, k, dim=0), code, k, dim=0)
    cc = torch.as_tensor(code.matrix_acs_tables(k)["cc"], dtype=torch.long, device=pm.device)
    pmk = pm.reshape(U, nk, B).transpose(0, 1)  # [j, u] = pm[2^k·u + j]
    cand = pmk[None] + bmk[cc]  # (c, j, u, B)
    planes = []
    for i in range(k):
        even, odd = cand[:, 0::2], cand[:, 1::2]
        dec = (odd < even).to(torch.int32)  # (c, h, u, B)
        cand = torch.minimum(even, odd)
        # groups c < 2^(i+1) cover every intermediate state exactly once
        planes.append(dec[: 2 << i].permute(0, 2, 1, 3).reshape(N, B))
    return cand[:, 0].reshape(N, B), planes


def _min_subtract(pm: torch.Tensor) -> torch.Tensor:
    return pm - pm.min(dim=0, keepdim=True).values


def acs_forward_ref(
    y: torch.Tensor,
    code: ConvCode,
    metric_mode: str = "f32",
    radix: int = 2,
    impl: str = "butterfly",
    r4_combine: bool = False,
    matrix_k: int = 2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward ACS over a batch of parallel blocks (paper K1).

    y: (T, R, B) soft symbols, int8/int16/int32 or float32. Integer symbols
    accumulate exactly: int32 for ``metric_mode="f32"``, int16/int8 for
    ``"i16"``/``"i8"``, which clip the symbols to ±``metric_mode_qmax`` and
    min-subtract every ``norm_every`` ACS steps (the step count is global:
    ``step % norm_every == norm_every - 1``; ``norm_every`` is
    ``norm_interval(code, mode, radix)``, or ``stages_per_step=matrix_k``
    for the matrix impl). Symbols are widened to the accumulator type
    before any negation, as in the reference.

    ``radix=4`` runs ceil(T/2) stage-fused steps (odd T: one trailing
    radix-2 step, min-subtracted unconditionally in narrow modes) and emits
    the same two radix-2 survivor planes per step, so ``sp`` equals radix
    2's; ``r4_combine`` picks the combined-metric form of the step (see
    :func:`_radix4_step`). ``impl="matrix"`` runs T // matrix_k k-stage
    (min,+) steps (:func:`_matrix_step`) and then the T mod k trailing
    stages radix 2, each min-subtracted unconditionally in narrow modes;
    ``radix`` is ignored. Float accumulators lower the matrix impl to the
    radix-2 butterfly (IEEE addition is not associative), so ``sp`` and
    ``pm`` are the butterfly's. Returns (sp, pm_final):
      sp: (T, ceil(N/32), B) int32 bit-packed survivor decisions
      pm_final: (N, B) final path metrics (float32/int32, or int16/int8
      normalized in the narrow modes).
    """
    if impl not in ("butterfly", "matrix"):
        raise ValueError(f"impl must be 'butterfly' or 'matrix', got {impl!r}")
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    T, R, B = y.shape
    if R != code.R:
        raise ValueError(f"symbol rank {R} != code R {code.R}")
    if impl == "butterfly" and radix == 4 and code.n_states < 4:
        raise ValueError(f"radix-4 ACS needs K >= 3 (got K={code.K})")
    acc_dtype = _acc_dtype_for(y.dtype, metric_mode)
    if impl == "matrix":
        code.validate_matrix_k(matrix_k)
        if acc_dtype.is_floating_point:
            impl, radix = "butterfly", 2  # the float lowering
    if impl == "matrix":
        norm_every = norm_interval(code, metric_mode, stages_per_step=matrix_k)
    else:
        norm_every = norm_interval(code, metric_mode, radix)  # 0 → never (f32)
    if norm_every:
        # saturate out-of-budget pre-quantized symbols on ingestion: the
        # no-saturation guarantee assumes |y| ≤ metric_mode_qmax
        qm = metric_mode_qmax(code, metric_mode)
        y = torch.clamp(y, -qm, qm)
    dev = y.device
    tabs = {
        k: torch.as_tensor(code.acs_tables[k], dtype=torch.long, device=dev)
        for k in ("cw_top_even", "cw_top_odd", "cw_bot_even", "cw_bot_odd")
    }
    if impl == "butterfly" and radix == 4:
        tabs["cc"] = torch.as_tensor(code.radix4_acs_tables["cc"], dtype=torch.long, device=dev)
    y = y.to(acc_dtype)
    # every stage's folded table at once: elementwise, so the same arithmetic
    bm_all = expand_folded_bm(folded_branch_metric_table(y, code, dim=1), code, dim=1)
    pm = torch.zeros((code.n_states, B), dtype=acc_dtype, device=dev)
    sp = torch.empty((T, -(-code.n_states // 32), B), dtype=torch.int32, device=dev)

    def norm(pm, step):
        if norm_every and step % norm_every == norm_every - 1:
            return _min_subtract(pm)
        return pm

    if impl == "matrix":
        n_steps = T // matrix_k
        for r in range(n_steps):
            t = r * matrix_k
            pm, planes = _matrix_step(pm, y[t : t + matrix_k], code, matrix_k)
            pm = norm(pm, r)
            for i, dec in enumerate(planes):
                sp[t + i] = _pack_decisions(dec)
        for t in range(n_steps * matrix_k, T):
            # trailing radix-2 stages (T mod k); narrow modes normalize here
            # unconditionally — a uniform shift, decision- and argmin-invariant
            pm, dec = _radix2_stage(pm, bm_all[t], tabs)
            if norm_every:
                pm = _min_subtract(pm)
            sp[t] = _pack_decisions(dec)
        return sp, pm
    if radix == 2:
        for t in range(T):
            pm, dec = _radix2_stage(pm, bm_all[t], tabs)
            pm = norm(pm, t)
            sp[t] = _pack_decisions(dec)
        return sp, pm
    for r in range(T // 2):
        t = 2 * r
        pm, dec1, dec2 = _radix4_step(pm, bm_all[t], bm_all[t + 1], y[t], y[t + 1], code,
                                      tabs, r4_combine)
        pm = norm(pm, r)
        sp[t] = _pack_decisions(dec1)
        sp[t + 1] = _pack_decisions(dec2)
    if T % 2:
        # trailing radix-2 step (odd T); narrow modes normalize here
        # unconditionally — a uniform shift, decision- and argmin-invariant
        pm, dec = _radix2_stage(pm, bm_all[T - 1], tabs)
        if norm_every:
            pm = _min_subtract(pm)
        sp[T - 1] = _pack_decisions(dec)
    return sp, pm


def traceback_ref(
    sp: torch.Tensor,
    code: ConvCode,
    decode_start: int,
    n_decode: int,
    start_state: torch.Tensor | int = 0,
) -> torch.Tensor:
    """Traceback + decode (paper K2).

    sp: (T, W, B) packed survivor words from :func:`acs_forward_ref`. The
    walk starts after stage T-1 in ``start_state`` (an int or a (B,) tensor
    of states in [0, N)) and emits the state's MSB for stages
    [decode_start, decode_start + n_decode). Stages below ``decode_start``
    emit nothing and feed nothing, so the walk stops there.
    Returns (n_decode, B) decoded bits (int32), in forward order.
    """
    T, W, B = sp.shape
    if not 0 <= decode_start <= T - n_decode:
        raise ValueError(
            f"decode region [{decode_start}, {decode_start + n_decode}) outside [0, {T})"
        )
    half = code.n_states // 2
    v = code.v
    state = torch.as_tensor(start_state, dtype=torch.int32, device=sp.device)
    state = state.broadcast_to((B,)).clone()
    bits = torch.empty((n_decode, B), dtype=torch.int32, device=sp.device)
    for s in range(T - 1, decode_start - 1, -1):
        if s < decode_start + n_decode:
            bits[s - decode_start] = state >> (v - 1)  # MSB = input bit of stage s
        word = sp[s].gather(0, (state >> 5).long()[None])[0]
        bit = (word >> (state & 31)) & 1
        state = 2 * (state % half) + bit
    return bits


def stage_maps_ref(sp: torch.Tensor, code: ConvCode) -> torch.Tensor:
    """Per-stage predecessor maps from packed survivor words.

    sp: (T, W, B) → f: (T, N, B) int32, ``f[t, n]`` the state the walk moves
    to from state ``n`` after stage t: ``2·(n mod N/2) + sp_bit_t(n)``.
    """
    N = code.n_states
    states = torch.arange(N, dtype=torch.int32, device=sp.device)
    words = sp[:, (states >> 5).long(), :]  # (T, N, B)
    bits = (words >> (states & 31)[None, :, None]) & 1  # arithmetic >> then & 1
    return 2 * (states % (N // 2))[None, :, None] + bits


def traceback_prefix_ref(
    sp: torch.Tensor,
    code: ConvCode,
    decode_start: int,
    n_decode: int,
    start_state: torch.Tensor | int = 0,
) -> torch.Tensor:
    """Parallel-prefix traceback, the log-depth oracle: bits equal
    :func:`traceback_ref`'s for any survivor history.

    The stage maps reversed in time, ``x[i] = f_{T-1-i}``, are scanned with
    the composition ``compose(a, b) = b.gather(1, a)`` ("b after a"), by
    Hillis–Steele doubling: after the round of distance d, ``x[i]`` is the
    composition of the 2d maps ending at i. That is exact, since it
    composes integer maps. Prefix i applied to the start state is the walk
    state at time T-1-i; the bit of stage t is the MSB of the state at time
    t+1. Returns (n_decode, B) int32 bits of [decode_start, +n_decode).
    """
    T, W, B = sp.shape
    if not 0 <= decode_start <= T - n_decode:
        raise ValueError(
            f"decode region [{decode_start}, {decode_start + n_decode}) outside [0, {T})"
        )
    x = stage_maps_ref(sp, code).flip(0)
    d = 1
    while d < T:
        nxt = x.clone()
        nxt[d:] = x[d:].gather(1, x[:-d].long())
        x, d = nxt, 2 * d
    start = torch.as_tensor(start_state, dtype=torch.int32, device=sp.device)
    start = start.broadcast_to((B,))
    walked = x.gather(1, start.long().broadcast_to((T, 1, B)))[:, 0]  # (T, B)
    # states at times [T, T-1, ..., 1]; bit t = MSB of the state at time t+1
    states_desc = torch.cat([start[None], walked[: T - 1]], dim=0)
    bits = (states_desc >> (code.v - 1)).flip(0)
    return bits[decode_start : decode_start + n_decode].contiguous()


#: stages per chunk of the prefix traceback unless the caller says otherwise
DEFAULT_TB_CHUNK = 64


def prefix_chunk_geometry(T: int, decode_start: int, n_decode: int, tb_chunk: int):
    """Static chunk geometry of the prefix traceback, as the reference's.

    Returns ``(C, P, n_chunks, c_lo, c_hi)``: the chunk size ``min(tb_chunk,
    T)``, the padding below stage 0 that makes ``T + P`` a chunk multiple
    (the top stage stays T-1), the chunk count, and the first and last chunk
    (after padding) that touch the decode region. Chunks below ``c_lo`` are
    skipped; chunks above ``c_hi`` are composed and walked, not expanded.
    """
    if tb_chunk < 1:
        raise ValueError(f"tb_chunk must be >= 1, got {tb_chunk}")
    if not 0 <= decode_start <= T - n_decode:
        raise ValueError(
            f"decode region [{decode_start}, {decode_start + n_decode}) "
            f"outside [0, {T})"
        )
    C = min(tb_chunk, T)
    P = (-T) % C
    n_chunks = (T + P) // C
    ds = decode_start + P
    c_lo = ds // C
    c_hi = (ds + n_decode - 1) // C
    return C, P, n_chunks, c_lo, c_hi


def traceback_prefix_chunked_ref(
    sp: torch.Tensor,
    code: ConvCode,
    decode_start: int,
    n_decode: int,
    start_state: torch.Tensor | int = 0,
    tb_chunk: int = DEFAULT_TB_CHUNK,
) -> torch.Tensor:
    """The chunked prefix traceback in three phases, as the reference's
    ``_prefix_traceback_phases``: the plain version of the CUDA kernels.

    sp (T, W, B) gets P zero stages *below* stage 0 and is cut into chunks
    of C stages; chunks below ``c_lo`` are skipped. Phase A composes each
    active chunk's C stage maps, top down, into one N-entry map; phase B
    walks the composed maps from ``start_state`` (the only serial chain,
    ``n_chunks - c_lo`` steps) and records each expansion chunk's entry
    state; phase C re-walks the expansion chunks ``c_lo..c_hi`` in parallel
    and emits their bits. Returns (n_decode, B) int32, equal to
    :func:`traceback_ref`'s bits.
    """
    T, W, B = sp.shape
    C, P, n_chunks, c_lo, c_hi = prefix_chunk_geometry(T, decode_start, n_decode, tb_chunk)
    N, v, dev = code.n_states, code.v, sp.device
    half = N // 2
    if P:
        sp = torch.cat([sp.new_zeros((P, W, B)), sp], dim=0)
    spr = sp.reshape(n_chunks, C, W, B)[c_lo:]  # the active chunks
    n_act, nc_e = n_chunks - c_lo, c_hi - c_lo + 1
    # ---- phase A: compose, all active chunks x states at once ----
    maps = torch.arange(N, dtype=torch.int32, device=dev)[None, :, None]
    maps = maps.expand(n_act, N, B).contiguous()
    for row in range(C - 1, -1, -1):  # stages top down within each chunk
        word = spr[:, row].gather(1, (maps >> 5).long())  # (n_act, N, B)
        maps = 2 * (maps % half) + ((word >> (maps & 31)) & 1)
    # ---- phase B: walk the composed maps, record entry states ----
    state = torch.as_tensor(start_state, dtype=torch.int32, device=dev)
    state = state.broadcast_to((B,)).clone()
    entry = torch.empty((nc_e, B), dtype=torch.int32, device=dev)
    for c in range(n_act - 1, -1, -1):
        if c < nc_e:
            entry[c] = state  # walk state at the top of chunk c
        state = maps[c].gather(0, state.long()[None])[0]
    # ---- phase C: expand the decode chunks in parallel ----
    bits = torch.empty((nc_e, C, B), dtype=torch.int32, device=dev)
    state = entry
    for row in range(C - 1, -1, -1):
        bits[:, row] = state >> (v - 1)
        word = spr[:nc_e, row].gather(1, (state >> 5).long()[:, None])[:, 0]
        state = 2 * (state % half) + ((word >> (state & 31)) & 1)
    ds_local = decode_start + P - c_lo * C
    return bits.reshape(nc_e * C, B)[ds_local : ds_local + n_decode].contiguous()


def pbvd_decode_ref(
    y_blocks: torch.Tensor,
    code: ConvCode,
    n_decode: int,
    n_traceback: int,
    start_state: int = 0,
    metric_mode: str = "f32",
    radix: int = 2,
) -> torch.Tensor:
    """Decode framed parallel blocks: y_blocks (T, R, B) → (D, B) bits."""
    sp, _ = acs_forward_ref(y_blocks, code, metric_mode=metric_mode, radix=radix)
    return traceback_ref(sp, code, n_traceback, n_decode, start_state)


def pbvd_fused_ref(
    y: torch.Tensor,
    code: ConvCode,
    *,
    decode_start: int,
    n_decode: int,
    start_state: torch.Tensor | int | None = None,
    metric_mode: str = "f32",
    radix: int = 2,
    tb_mode: str = "serial",
    tb_chunk: int = DEFAULT_TB_CHUNK,
    impl: str = "butterfly",
    k: int = 2,
) -> torch.Tensor:
    """The fused decode: y (T, R, B) → packed bits (n_decode/32, B) int32.

    Forward ACS (butterfly at ``radix``, or the k-stage matrix impl), the
    walk from ``start_state`` (zeros by default) — serial, or the chunked
    prefix walk (:func:`traceback_prefix_chunked_ref`, chunk geometry over
    the bits that exist) — and the packing: bit ``b & 31`` of word
    ``b >> 5`` is the decoded bit of stage ``decode_start + b``, bit 31
    being the int32 sign bit. ``n_decode`` must be a multiple of 32; bits
    of stages at or beyond T (a packed width that overhangs the block)
    stay 0.
    """
    T = y.shape[0]
    if n_decode % 32:
        raise ValueError("n_decode must be a multiple of 32")
    if not 0 <= decode_start < T:
        raise ValueError(f"decode_start {decode_start} outside [0, {T})")
    if tb_mode not in ("serial", "prefix"):
        raise ValueError(f"unknown tb_mode {tb_mode!r}")
    sp, _ = acs_forward_ref(y, code, metric_mode=metric_mode, radix=radix, impl=impl,
                            matrix_k=k)
    n_window = min(n_decode, T - decode_start)
    start = 0 if start_state is None else start_state
    if tb_mode == "prefix":
        bits = traceback_prefix_chunked_ref(sp, code, decode_start, n_window, start, tb_chunk)
    else:
        bits = traceback_ref(sp, code, decode_start, n_window, start)
    if n_window < n_decode:
        bits = torch.cat([bits, bits.new_zeros((n_decode - n_window, bits.shape[1]))])
    return _pack_decisions(bits)
