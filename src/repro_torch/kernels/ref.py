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
3. ``pbvd_decode_ref`` — the block decoder composed of (2).

Only radix 2, the butterfly formulation and ``metric_mode="f32"`` are
ported; other knob values raise ``ValueError``.

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

from repro_torch.core.trellis import ConvCode

__all__ = [
    "viterbi_classic_np",
    "folded_branch_metric_table",
    "expand_folded_bm",
    "acs_forward_ref",
    "traceback_ref",
    "pbvd_decode_ref",
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
def folded_branch_metric_table(y: torch.Tensor, code: ConvCode, dim: int = -1) -> torch.Tensor:
    """Symmetry-folded BM table along ``dim`` (length R → 2^(R-1)).

    The correlation metric is antipodal in the label (BM(~c) = -BM(c)), so
    only the 2^(R-1) fold representatives (labels with MSB 0) are computed,
    each as a static add/sub chain in ``r`` order — no multiplies, so the
    float path is bit-exact to the reference.
    """
    rows = []
    svals = code.folded_codeword_signs  # (2^(R-1), R) static ±1
    for k in range(code.n_folded):
        acc = None
        for r in range(code.R):
            y_r = y.select(dim, r)
            term = y_r if svals[k, r] > 0 else -y_r
            acc = term if acc is None else acc + term
        rows.append(acc)
    return torch.stack(rows, dim=dim)


def expand_folded_bm(bm_folded: torch.Tensor, code: ConvCode, dim: int = -1) -> torch.Tensor:
    """Folded table (2^(R-1) along ``dim``) → full 2^R table by static signs."""
    index = torch.as_tensor(code.fold_index, dtype=torch.long, device=bm_folded.device)
    gathered = bm_folded.index_select(dim, index)
    shape = [1] * bm_folded.dim()
    shape[dim] = -1
    neg = torch.as_tensor(code.fold_sign < 0, device=bm_folded.device).reshape(shape)
    return torch.where(neg, -gathered, gathered)


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
    """Accumulator dtype of the path metrics: int32 for integer symbols,
    float32 for float ones (``metric_mode="f32"``, the only mode ported)."""
    if metric_mode != "f32":
        raise ValueError(
            f"metric_mode {metric_mode!r} is not ported yet; supported: ('f32',)"
        )
    if y_dtype in (torch.int8, torch.int16, torch.int32):
        return torch.int32
    if y_dtype == torch.float32:
        return torch.float32
    raise ValueError(f"symbols must be int8/int16/int32/float32, got {y_dtype}")


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


def acs_forward_ref(
    y: torch.Tensor,
    code: ConvCode,
    metric_mode: str = "f32",
    radix: int = 2,
    impl: str = "butterfly",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward ACS over a batch of parallel blocks (paper K1).

    y: (T, R, B) soft symbols, int8/int16/int32 (exact int32 accumulation)
    or float32. Symbols are widened to the accumulator type before any
    negation, as in the reference. Returns (sp, pm_final):
      sp: (T, ceil(N/32), B) int32 bit-packed survivor decisions
      pm_final: (N, B) final path metrics (int32 or float32).
    """
    if radix != 2:
        raise ValueError(f"acs radix {radix} is not ported yet; supported: (2,)")
    if impl != "butterfly":
        raise ValueError(f"acs impl {impl!r} is not ported yet; supported: ('butterfly',)")
    T, R, B = y.shape
    if R != code.R:
        raise ValueError(f"symbol rank {R} != code R {code.R}")
    acc_dtype = _acc_dtype_for(y.dtype, metric_mode)
    dev = y.device
    tabs = {
        k: torch.as_tensor(code.acs_tables[k], dtype=torch.long, device=dev)
        for k in ("cw_top_even", "cw_top_odd", "cw_bot_even", "cw_bot_odd")
    }
    # every stage's folded table at once: elementwise, so the same arithmetic
    bm_all = expand_folded_bm(folded_branch_metric_table(y.to(acc_dtype), code, dim=1), code, dim=1)
    pm = torch.zeros((code.n_states, B), dtype=acc_dtype, device=dev)
    sp = torch.empty((T, -(-code.n_states // 32), B), dtype=torch.int32, device=dev)
    for t in range(T):
        pm, dec = _radix2_stage(pm, bm_all[t], tabs)
        sp[t] = _pack_decisions(dec)
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
) -> torch.Tensor:
    """Decode framed parallel blocks: y_blocks (T, R, B) → (D, B) bits."""
    sp, _ = acs_forward_ref(y_blocks, code, metric_mode=metric_mode)
    return traceback_ref(sp, code, n_traceback, n_decode, start_state)
