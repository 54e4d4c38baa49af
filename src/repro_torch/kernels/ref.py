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

The metric modes ``"f32"``, ``"i16"`` and ``"i8"`` and the radix-2 and
radix-4 butterflies are ported; the matrix formulation and other knob
values raise ``ValueError``.

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
    "folded_branch_metric_table",
    "expand_folded_bm",
    "folded_radix4_bm_table",
    "expand_folded_radix4_bm",
    "acs_forward_ref",
    "traceback_ref",
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


def _min_subtract(pm: torch.Tensor) -> torch.Tensor:
    return pm - pm.min(dim=0, keepdim=True).values


def acs_forward_ref(
    y: torch.Tensor,
    code: ConvCode,
    metric_mode: str = "f32",
    radix: int = 2,
    impl: str = "butterfly",
    r4_combine: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward ACS over a batch of parallel blocks (paper K1).

    y: (T, R, B) soft symbols, int8/int16/int32 or float32. Integer symbols
    accumulate exactly: int32 for ``metric_mode="f32"``, int16/int8 for
    ``"i16"``/``"i8"``, which clip the symbols to ±``metric_mode_qmax`` and
    min-subtract every ``norm_interval(code, mode, radix)`` ACS steps (the
    step count is global: ``step % norm_every == norm_every - 1``). Symbols
    are widened to the accumulator type before any negation, as in the
    reference.

    ``radix=4`` runs ceil(T/2) stage-fused steps (odd T: one trailing
    radix-2 step, min-subtracted unconditionally in narrow modes) and emits
    the same two radix-2 survivor planes per step, so ``sp`` equals radix
    2's; ``r4_combine`` picks the combined-metric form of the step (see
    :func:`_radix4_step`). Returns (sp, pm_final):
      sp: (T, ceil(N/32), B) int32 bit-packed survivor decisions
      pm_final: (N, B) final path metrics (float32/int32, or int16/int8
      normalized in the narrow modes).
    """
    if impl != "butterfly":
        raise ValueError(f"acs impl {impl!r} is not ported yet; supported: ('butterfly',)")
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    T, R, B = y.shape
    if R != code.R:
        raise ValueError(f"symbol rank {R} != code R {code.R}")
    if radix == 4 and code.n_states < 4:
        raise ValueError(f"radix-4 ACS needs K >= 3 (got K={code.K})")
    acc_dtype = _acc_dtype_for(y.dtype, metric_mode)
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
    if radix == 4:
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
) -> torch.Tensor:
    """The fused decode: y (T, R, B) → packed bits (n_decode/32, B) int32.

    Forward ACS, the serial walk from ``start_state`` (zeros by default)
    and the packing: bit ``b & 31`` of word ``b >> 5`` is the decoded bit
    of stage ``decode_start + b``, bit 31 being the int32 sign bit.
    ``n_decode`` must be a multiple of 32; bits of stages at or beyond T
    (a packed width that overhangs the block) stay 0.
    """
    T = y.shape[0]
    if n_decode % 32:
        raise ValueError("n_decode must be a multiple of 32")
    if not 0 <= decode_start < T:
        raise ValueError(f"decode_start {decode_start} outside [0, {T})")
    sp, _ = acs_forward_ref(y, code, metric_mode=metric_mode, radix=radix)
    n_window = min(n_decode, T - decode_start)
    bits = traceback_ref(sp, code, decode_start, n_window,
                         0 if start_state is None else start_state)
    if n_window < n_decode:
        bits = torch.cat([bits, bits.new_zeros((n_decode - n_window, bits.shape[1]))])
    return _pack_decisions(bits)
