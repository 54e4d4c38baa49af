"""Trellis description of an (R, 1, K) convolutional code.

The port's own copy of ``repro.core.trellis`` (NumPy only, so the port
never imports the JAX package): every table here must equal the
reference's, which ``tests/test_torch_core.py`` checks for every
registered code.

Implements the paper's state/butterfly formalism (§II, §III-B):

* state ``d = (D_{v-1} ... D_0)_2`` with ``v = K-1`` memory cells; ``D_{v-1}``
  is the most recently shifted-in bit, ``D_0`` the oldest.
* encoder output for input bit ``x`` at state ``S_d`` (eq. 2)::

      c^{(r)} = (x · g^{(r)}_{K-1}) ⊕ (D_{K-2} · g^{(r)}_{K-2}) ⊕ ... ⊕ (D_0 · g^{(r)}_0)

* transition: ``next = (x << (v-1)) | (d >> 1)``.
* butterfly ``j`` (``j = 0 .. N/2-1``): source states ``2j, 2j+1``; target
  ``j`` for input 0 and ``j + N/2`` for input 1. Butterfly outputs (eqs. 3-6)::

      α = c(S_{2j}, 0)      β = α ⊕ g_{K-1}      γ = α ⊕ g_0      θ = α ⊕ g_{K-1} ⊕ g_0

  (XORs applied per filter r; as R-bit integers the masks are ``x_mask``
  = bits ``g^{(r)}_{K-1}`` and ``l_mask`` = bits ``g^{(r)}_0``.)

The group classification (§III-B / Table II) groups butterflies by ``α``:
at most ``2^R`` groups, hence only ``2^R`` distinct branch metrics per stage.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property, lru_cache
from typing import Tuple

import numpy as np

__all__ = ["ConvCode", "CCSDS_27", "MATRIX_MAX_LABEL_BITS", "parity"]

# Cap on k·R for the k-stage (min,+) matrix ACS: the folded combined-metric
# table has 2^(kR-1) rows, each a static add/sub chain over k·R symbol rows,
# and the kernels keep the whole table resident (as matmul operand columns or
# unrolled register rows). 8 label bits → at most 128 folded metrics, the
# same ceiling as one MXU/VPU lane tile.
MATRIX_MAX_LABEL_BITS = 8


def parity(x: np.ndarray | int) -> np.ndarray | int:
    """Bitwise parity (popcount mod 2) of non-negative ints, vectorized."""
    x = np.asarray(x)
    out = np.zeros_like(x)
    while np.any(x):
        out ^= x & 1
        x = x >> 1
    return out


@dataclasses.dataclass(frozen=True)
class ConvCode:
    """An (R, 1, K) convolutional code described by generator polynomials.

    ``polys[r]`` is the r-th generator polynomial as a bit sequence
    ``[g_{K-1}, g_{K-2}, ..., g_0]`` (paper order — MSB = input tap).
    """

    polys: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        ks = {len(p) for p in self.polys}
        if len(ks) != 1:
            raise ValueError(f"all generator polynomials must share K, got {ks}")
        if not all(b in (0, 1) for p in self.polys for b in p):
            raise ValueError("generator polynomials must be binary")

    # ---- scalar shape parameters -------------------------------------------------
    @property
    def R(self) -> int:
        return len(self.polys)

    @property
    def K(self) -> int:
        return len(self.polys[0])

    @property
    def v(self) -> int:  # number of memory cells
        return self.K - 1

    @property
    def n_states(self) -> int:
        return 1 << self.v

    @property
    def n_butterflies(self) -> int:
        return self.n_states // 2

    @property
    def rate(self) -> float:
        return 1.0 / self.R

    # ---- integer-mask views of the polynomials -----------------------------------
    @cached_property
    def poly_ints(self) -> np.ndarray:
        """polys as integers with bit i = g^{(r)}_i (so bit K-1 = input tap)."""
        out = []
        for p in self.polys:
            val = 0
            for i, bit in enumerate(p):  # p[0] = g_{K-1}
                val |= bit << (self.K - 1 - i)
            out.append(val)
        return np.array(out, dtype=np.int64)

    @cached_property
    def x_mask(self) -> int:
        """R-bit integer whose bit r (MSB-first) = g^{(r)}_{K-1} (input tap)."""
        m = 0
        for r in range(self.R):
            m = (m << 1) | ((self.poly_ints[r] >> (self.K - 1)) & 1)
        return int(m)

    @cached_property
    def l_mask(self) -> int:
        """R-bit integer whose bit r (MSB-first) = g^{(r)}_0 (oldest-bit tap)."""
        m = 0
        for r in range(self.R):
            m = (m << 1) | (self.poly_ints[r] & 1)
        return int(m)

    # ---- encoder output tables ----------------------------------------------------
    def output_bits(self, state: np.ndarray | int, x: np.ndarray | int) -> np.ndarray:
        """Per-filter output bits c^{(r)}(S_state, x): shape (..., R)."""
        state = np.asarray(state, dtype=np.int64)
        x = np.asarray(x, dtype=np.int64)
        lows = self.poly_ints & ((1 << self.v) - 1)  # memory taps
        tap_x = (self.poly_ints >> (self.K - 1)) & 1  # input tap
        mem = parity(state[..., None] & lows)  # (..., R)
        return (mem ^ (x[..., None] * tap_x)).astype(np.int64)

    def output_int(self, state: np.ndarray | int, x: np.ndarray | int) -> np.ndarray:
        """Encoder output as an R-bit integer, c^{(1)} in the MSB (paper order)."""
        bits = self.output_bits(state, x)
        val = np.zeros(bits.shape[:-1], dtype=np.int64)
        for r in range(self.R):
            val = (val << 1) | bits[..., r]
        return val

    # ---- butterfly group classification (§III-B) ----------------------------------
    @cached_property
    def alpha(self) -> np.ndarray:
        """α for each butterfly j: output int of source state 2j with input 0."""
        j = np.arange(self.n_butterflies)
        return self.output_int(2 * j, 0)

    @cached_property
    def butterfly_codewords(self) -> np.ndarray:
        """(n_butterflies, 4) int codewords [α, β, γ, θ] per butterfly."""
        a = self.alpha
        return np.stack(
            [a, a ^ self.x_mask, a ^ self.l_mask, a ^ self.x_mask ^ self.l_mask],
            axis=1,
        )

    @cached_property
    def n_groups(self) -> int:
        return len(np.unique(self.alpha))

    @cached_property
    def groups(self) -> list[dict]:
        """Paper Table II: one entry per distinct α, with member source states.

        Each dict has keys ``alpha, beta, gamma, theta`` (R-bit ints) and
        ``states`` (sorted source-state indices 2j, 2j+1 of member butterflies).
        """
        out = []
        for a in sorted(np.unique(self.alpha)):
            js = np.nonzero(self.alpha == a)[0]
            states = sorted(np.concatenate([2 * js, 2 * js + 1]).tolist())
            out.append(
                dict(
                    alpha=int(a),
                    beta=int(a ^ self.x_mask),
                    gamma=int(a ^ self.l_mask),
                    theta=int(a ^ self.x_mask ^ self.l_mask),
                    states=states,
                )
            )
        return out

    # ---- ACS constant tables (consumed by kernels/ref) ----------------------------
    @cached_property
    def acs_tables(self) -> dict:
        """Static per-butterfly codeword indices for the vectorized ACS update.

        For target state j (top half):    predecessors 2j (codeword α_j)
                                          and 2j+1 (codeword γ_j).
        For target state j+N/2 (bottom):  predecessors 2j (codeword β_j)
                                          and 2j+1 (codeword θ_j).

        Returns int32 arrays of shape (n_butterflies,):
          ``cw_top_even, cw_top_odd, cw_bot_even, cw_bot_odd``
        plus ``onehot_{...}`` float32 one-hot matrices (n_butterflies, 2^R)
        used by the Pallas kernel to expand the 2^R-entry BM table with a
        static matmul (the TPU-native form of the paper's group lookup).
        """
        cw = self.butterfly_codewords
        tabs = dict(
            cw_top_even=cw[:, 0].astype(np.int32),  # α
            cw_bot_even=cw[:, 1].astype(np.int32),  # β
            cw_top_odd=cw[:, 2].astype(np.int32),  # γ
            cw_bot_odd=cw[:, 3].astype(np.int32),  # θ
        )
        n_cw = 1 << self.R
        for key in list(tabs):
            idx = tabs[key]
            oh = np.zeros((self.n_butterflies, n_cw), dtype=np.float32)
            oh[np.arange(self.n_butterflies), idx] = 1.0
            tabs["onehot_" + key[3:]] = oh
        return tabs

    # ---- codeword ±1 sign table (for correlation branch metrics) ------------------
    @cached_property
    def codeword_signs(self) -> np.ndarray:
        """(2^R, R) float32: row c = (2·bits(c) - 1), c^{(1)} at column 0.

        Branch metric (to MINIMIZE) for received soft symbols y (BPSK map
        bit b → 1-2b, i.e. 0 → +1): BM(c) = Σ_r y_r · (2 c_r - 1).
        """
        n_cw = 1 << self.R
        rows = []
        for c in range(n_cw):
            bits = [(c >> (self.R - 1 - r)) & 1 for r in range(self.R)]
            rows.append([2.0 * b - 1.0 for b in bits])
        return np.array(rows, dtype=np.float32)

    # ---- symmetry-folded branch metrics (antipodal label structure) ----------------
    # The correlation metric is antipodal in the label: complementing every
    # output bit flips every sign row entry, so BM(~c) = -BM(c). The 2^R
    # labels therefore pair into 2^(R-1) ± pairs and only 2^(R-1) distinct
    # branch metrics exist per stage — half the paper's 2^R group metrics.
    # The canonical representative of a pair is the label whose MSB (stream
    # c^{(1)}) is 0, i.e. c < 2^(R-1); the other member is its complement.
    @property
    def n_folded(self) -> int:
        """Distinct folded branch metrics per stage: 2^(R-1)."""
        return 1 << (self.R - 1)

    @cached_property
    def fold_index(self) -> np.ndarray:
        """(2^R,) int32: folded-table row of each label (its ± representative)."""
        c = np.arange(1 << self.R)
        mask = (1 << self.R) - 1
        return np.where(c < self.n_folded, c, c ^ mask).astype(np.int32)

    @cached_property
    def fold_sign(self) -> np.ndarray:
        """(2^R,) int32 ±1: BM(c) = fold_sign[c] · BM_folded[fold_index[c]]."""
        c = np.arange(1 << self.R)
        return np.where(c < self.n_folded, 1, -1).astype(np.int32)

    @cached_property
    def folded_codeword_signs(self) -> np.ndarray:
        """(2^(R-1), R) float32 sign rows of the fold representatives.

        ``BM_folded = folded_codeword_signs @ y`` is the folded table;
        expansion to the full 2^R table is ``fold_sign · BM_folded[fold_index]``
        (exact in both IEEE float — negation and round-to-nearest are
        sign-symmetric — and integer arithmetic).
        """
        return self.codeword_signs[: self.n_folded]

    # ---- collapsed two-stage (radix-4) trellis tables ------------------------------
    # Two consecutive trellis stages collapse into one radix-4 step: every
    # state n at time t+2 has the FOUR predecessors ``4·(n mod N/4) + j``
    # (j = 2·b_m + b_p) at time t, reached through the intermediate state
    # ``m = 2·(n mod N/2) + b_m`` at time t+1. The combined 2-symbol branch
    # label is the 2R-bit concatenation ``cc = (c1 << R) | c2`` of the two
    # stage labels, and the correlation metric stays antipodal in cc
    # (BM2(~cc) = −BM2(cc)), so only 2^(2R−1) distinct combined metrics
    # exist per fused step — the one-stage fold composed over the pair.
    #
    # Target states group by ``k = n >> (v-2)`` (the two MSBs of n): group k
    # covers targets ``n = k·N/4 + q``; its stage-(t+1) input bit is
    # ``x2 = k >> 1`` and its stage-t input bit is ``x1 = k & 1`` (the two
    # decoded bits the fused step emits). Groups k and k+2 share their
    # stage-t sub-problem (same x1, same intermediates), which is what lets
    # the kernels run the 4-way compare-select as a tournament whose first
    # round is computed once per x1.
    @property
    def n_folded4(self) -> int:
        """Distinct folded combined (2-stage) branch metrics: 2^(2R-1)."""
        return 1 << (2 * self.R - 1)

    @cached_property
    def fold_index4(self) -> np.ndarray:
        """(2^(2R),) int32: folded-table row of each combined label."""
        cc = np.arange(1 << (2 * self.R))
        mask = (1 << (2 * self.R)) - 1
        return np.where(cc < self.n_folded4, cc, cc ^ mask).astype(np.int32)

    @cached_property
    def fold_sign4(self) -> np.ndarray:
        """(2^(2R),) int32 ±1: BM2(cc) = fold_sign4[cc] · BM2_folded[fold_index4[cc]]."""
        cc = np.arange(1 << (2 * self.R))
        return np.where(cc < self.n_folded4, 1, -1).astype(np.int32)

    @cached_property
    def folded_radix4_codeword_signs(self) -> np.ndarray:
        """(2^(2R-1), 2R) float32 sign rows of the combined-label fold reps.

        Row cc = signs of the 2R bits of cc, stage-t label first:
        ``BM2_folded = folded_radix4_codeword_signs @ [y_t; y_{t+1}]``. Every
        representative has MSB 0 (stage-t label < 2^(R-1)), so each row is
        ``[+folded stage row i | ± full stage row j]`` — 2^(R-1)·2^(R-1)·2
        = 2^(2R-1) distinct static add/sub chains.
        """
        n = self.n_folded4
        R2 = 2 * self.R
        rows = []
        for cc in range(n):
            bits = [(cc >> (R2 - 1 - r)) & 1 for r in range(R2)]
            rows.append([2.0 * b - 1.0 for b in bits])
        return np.array(rows, dtype=np.float32)

    @cached_property
    def radix4_preds(self) -> np.ndarray:
        """(N, 4) int32: the four predecessors of each state two stages back,
        ordered by j = 2·b_m + b_p (b_m = stage-(t+1) survivor bit, b_p =
        stage-t survivor bit)."""
        if self.v < 2:
            raise ValueError(f"radix-4 tables need K >= 3 (got K={self.K})")
        n = np.arange(self.n_states)
        quarter = self.n_states // 4
        return (4 * (n[:, None] % quarter) + np.arange(4)[None, :]).astype(np.int32)

    @cached_property
    def radix4_acs_tables(self) -> dict:
        """Static per-quad label/fold tables for the radix-4 ACS kernels.

        A radix-4 "quad" q ∈ [0, N/4) is the complete bipartite unit of 4
        source states {4q+j} and 4 target states {k·N/4 + q}. Arrays (all
        int32, last axis length N/4):

          ``c1[x1, j]``  stage-t label of pred j under stage-t input x1
                         (shared by target groups k and k+2, x1 = k & 1)
          ``c2[k, bm]``  stage-(t+1) label of intermediate b_m for group k
          ``cc[k, j]``   combined 2R-bit label (c1 << R) | c2
          ``fold_c1_idx/sgn``, ``fold_c2_idx/sgn``: the per-stage fold
                         (2^(R-1) rows) of c1/c2 — the f32 staged path
          ``fold_cc_idx/sgn``: the combined fold (2^(2R-1) rows) of cc —
                         the exact integer path
        """
        if self.v < 2:
            raise ValueError(f"radix-4 tables need K >= 3 (got K={self.K})")
        N = self.n_states
        Q = N // 4
        half = N // 2
        q = np.arange(Q)
        c1 = np.zeros((2, 4, Q), dtype=np.int64)
        c2 = np.zeros((4, 2, Q), dtype=np.int64)
        cc = np.zeros((4, 4, Q), dtype=np.int64)
        for k in range(4):
            x1, x2 = k & 1, k >> 1
            n = k * Q + q
            for bm in (0, 1):
                m = 2 * (n % half) + bm
                c2[k, bm] = self.output_int(m, x2)
                for bp in (0, 1):
                    j = 2 * bm + bp
                    p = 4 * q + j
                    c1[x1, j] = self.output_int(p, x1)
                    cc[k, j] = (c1[x1, j] << self.R) | c2[k, bm]
        return dict(
            c1=c1.astype(np.int32),
            c2=c2.astype(np.int32),
            cc=cc.astype(np.int32),
            fold_c1_idx=self.fold_index[c1].astype(np.int32),
            fold_c1_sgn=self.fold_sign[c1].astype(np.int32),
            fold_c2_idx=self.fold_index[c2].astype(np.int32),
            fold_c2_sgn=self.fold_sign[c2].astype(np.int32),
            fold_cc_idx=self.fold_index4[cc].astype(np.int32),
            fold_cc_sgn=self.fold_sign4[cc].astype(np.int32),
        )

    @cached_property
    def folded_acs_tables(self) -> dict:
        """Static per-butterfly folded lookups for the ACS kernels.

        For each of the four butterfly codeword rows (α top/even, γ top/odd,
        β bottom/even, θ bottom/odd — the order the kernels consume):
          ``fold_cw_*``:  (n_butterflies,) int32 folded-table row indices
          ``fold_sgn_*``: (n_butterflies,) int32 ±1 signs
        so each per-butterfly metric row is a sign-flip of one of the
        2^(R-1) folded entries — the signs are static and applied in-register.
        """
        cw = self.butterfly_codewords  # (nb, 4) as [α, β, γ, θ]
        order = dict(te=0, to=2, be=1, bo=3)  # kernel row order α, γ, β, θ
        out = {}
        for key, col in order.items():
            labels = cw[:, col]
            out["fold_cw_" + key] = self.fold_index[labels].astype(np.int32)
            out["fold_sgn_" + key] = self.fold_sign[labels].astype(np.int32)
        return out

    # ---- k-stage (min,+) matrix trellis tables -------------------------------------
    # k consecutive trellis stages collapse into ONE transition of the
    # (min,+) semiring: new_pm[n'] = min_n (A[n', n] + pm[n]) with
    # A[n', n] = Σ_i BM_i over the unique k-stage path n → n' (+∞ when no
    # path exists). Every target n' has exactly 2^k predecessors
    # ``pred(n', j) = 2^k·u + j`` where ``u = n' mod N/2^k`` and j's bit i
    # is the survivor bit of stage t+i; the k input bits are the top k bits
    # of n', ``c = n' >> (v-k)``, with bit i of c = the stage-(t+i) input.
    # The intermediate state after i stages is
    #     s_i = ((c mod 2^i)·U + u) · 2^(k-i) + (j >> i),   U = N / 2^k,
    # and the combined label is the k·R-bit concatenation of the per-stage
    # labels, stage t in the MSBs. The correlation metric stays antipodal in
    # the combined label (complementing all k·R bits flips every sign), so
    # only 2^(kR-1) distinct combined metrics exist per collapsed step —
    # the one-stage fold composed over the whole k-stage window. k=2 reproduces
    # ``radix4_acs_tables`` exactly (c ↔ target group, u ↔ quad).
    def validate_matrix_k(self, k: int) -> None:
        """Raise ValueError unless k is a usable matrix-ACS fusion depth."""
        if not isinstance(k, int) or k < 1:
            raise ValueError(f"acs_k must be a positive int, got {k!r}")
        if k > self.v:
            raise ValueError(
                f"acs_k={k} exceeds the trellis memory v={self.v} (K={self.K}); "
                f"a k-stage transition matrix needs 2^k <= N={self.n_states} "
                f"predecessors per state"
            )
        if k * self.R > MATRIX_MAX_LABEL_BITS:
            raise ValueError(
                f"acs_k={k} needs 2^(kR-1)={1 << (k * self.R - 1)} folded "
                f"combined metrics (k*R = {k * self.R} label bits > "
                f"{MATRIX_MAX_LABEL_BITS}); reduce acs_k"
            )

    def n_folded_matrix(self, k: int) -> int:
        """Distinct folded combined (k-stage) branch metrics: 2^(kR-1)."""
        return 1 << (k * self.R - 1)

    @lru_cache(maxsize=None)
    def fold_index_matrix(self, k: int) -> np.ndarray:
        """(2^(kR),) int32: folded-table row of each combined k-stage label."""
        cc = np.arange(1 << (k * self.R))
        mask = (1 << (k * self.R)) - 1
        return np.where(cc < self.n_folded_matrix(k), cc, cc ^ mask).astype(np.int32)

    @lru_cache(maxsize=None)
    def fold_sign_matrix(self, k: int) -> np.ndarray:
        """(2^(kR),) int32 ±1: BMk(cc) = sign[cc] · BMk_folded[index[cc]]."""
        cc = np.arange(1 << (k * self.R))
        return np.where(cc < self.n_folded_matrix(k), 1, -1).astype(np.int32)

    @lru_cache(maxsize=None)
    def folded_matrix_codeword_signs(self, k: int) -> np.ndarray:
        """(2^(kR-1), kR) float32 sign rows of the combined-label fold reps.

        ``BMk_folded = folded_matrix_codeword_signs @ [y_t; ...; y_{t+k-1}]``
        — every representative has MSB 0, so each row is a static add/sub
        chain over the k·R stacked symbol streams (stage t first).
        """
        nb = k * self.R
        rows = []
        for cc in range(self.n_folded_matrix(k)):
            bits = [(cc >> (nb - 1 - r)) & 1 for r in range(nb)]
            rows.append([2.0 * b - 1.0 for b in bits])
        return np.array(rows, dtype=np.float32)

    @lru_cache(maxsize=None)
    def matrix_acs_tables(self, k: int) -> dict:
        """Static label/fold tables of the k-stage (min,+) transition matrix.

        Arrays of shape (2^k, 2^k, U) with U = N/2^k, indexed [c, j, u]
        (c = target input-bit group = n' >> (v-k), j = predecessor survivor
        bits, u = n' mod U):

          ``cc``        combined k·R-bit label of the path
                        pred(n', j) = 2^k·u + j  →  n' = c·U + u
          ``fold_idx``  folded-table row of cc (2^(kR-1) rows)
          ``fold_sgn``  ±1 expansion sign of cc

        The finite entries of A are exactly ``BMk(cc[c, j, u])`` at
        A[c·U + u, 2^k·u + j]; everything else is +∞ (never materialized —
        the kernels contract only over the 2^k real predecessors).
        """
        self.validate_matrix_k(k)
        U = self.n_states >> k
        u = np.arange(U)
        nk = 1 << k
        cc = np.zeros((nk, nk, U), dtype=np.int64)
        for c in range(nk):
            for j in range(nk):
                lab = np.zeros(U, dtype=np.int64)
                for i in range(k):
                    s_i = ((c & ((1 << i) - 1)) * U + u) * (1 << (k - i)) + (j >> i)
                    lab = (lab << self.R) | self.output_int(s_i, (c >> i) & 1)
                cc[c, j] = lab
        return dict(
            cc=cc.astype(np.int32),
            fold_idx=self.fold_index_matrix(k)[cc].astype(np.int32),
            fold_sgn=self.fold_sign_matrix(k)[cc].astype(np.int32),
        )

    @lru_cache(maxsize=None)
    def matrix_expansion(self, k: int) -> np.ndarray:
        """(2^k·N, 2^(kR-1)) float32 signed one-hot expansion matrix E.

        Row (c, j, u) — flattened in that order — holds a single ±1 at the
        fold row of ``cc[c, j, u]``, so ``E @ BMk_folded`` assembles every
        finite entry of the k-stage transition matrix as ONE dense matmul
        (MXU-shaped: 2^(kR-1) ≤ 128 contraction columns). Exact in float:
        one nonzero per row means no accumulation, and |BMk| ≤ k·R·q_max is
        far inside f32's integer range.
        """
        t = self.matrix_acs_tables(k)
        idx = t["fold_idx"].reshape(-1)
        sgn = t["fold_sgn"].reshape(-1)
        E = np.zeros((idx.size, self.n_folded_matrix(k)), dtype=np.float32)
        E[np.arange(idx.size), idx] = sgn
        return E


# The paper's reference code: CCSDS (2,1,7), g1 = 1111001, g2 = 1011011.
CCSDS_27 = ConvCode(polys=((1, 1, 1, 1, 0, 0, 1), (1, 0, 1, 1, 0, 1, 1)))
