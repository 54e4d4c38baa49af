// The forward add-compare-select loops of the parallel block-based Viterbi
// decoder, shared by K1 (acs.cu, survivor words to global memory) and the
// fused kernel (fused.cu, survivor words to shared memory). One copy of the
// stage arithmetic keeps the two kernels bit-exact to each other and to the
// plain version (repro_torch/kernels/ref.py::acs_forward_ref). Four bodies:
//
// 1. forward_acs_warp, the warp body: the registered mother codes (CCSDS
//    (2,1,7) 171/133, IS-95 (2,1,9) 753/561, LTE (3,1,7) 133/171/165),
//    each a MotherCode instantiation whose trellis tables are fixed at
//    compile time. It replaces the TPU kernel's radix-2 and radix-4 stage
//    loop (repro/kernels/acs.py::_acs_kernel, radix2_stage:330 with the
//    trace-time tables folded_bm_rows / butterfly_bm_row) in its own
//    layout: the TPU puts parallel blocks on lanes and states on sublanes,
//    and so does this body.
// 2. forward_acs_table, the runtime-table body: any other code (a user's
//    ConvCode, (2,1,5), every N up to 1024). It is the port's first
//    thread-per-state body, kept as it was: labels from a table in global
//    memory, PM ping-pong in shared memory, one barrier per stage.
// 3. forward_acs_matrix, the runtime-table matrix body: the k-stage
//    (min,+) steps of K1-matrix and the fused matrix variant for any other
//    code, on the table body's layout (below).
// 4. forward_acs_matrix_warp, the matrix warp body: the k-stage (min,+)
//    steps of K1-matrix and the fused matrix variant (either walk) for the
//    three mother codes, on the warp body's layout (below). It replaces the TPU
//    kernels repro/kernels/acs.py::_acs_matrix_kernel (matrix_step) and
//    repro/kernels/fused.py::_acs_phase_mat_dbuf for those codes.
//
// What bounds the warp body on the H100 80GB HBM3 (700 W limit). Per stage
// and parallel block it must do about 4N integer operations (two adds, a
// compare and a select per state) and move R symbol bytes in and 4*W
// survivor bytes out: at CCSDS, N = 64, that is ~256 operations per 10
// bytes, so the INT32 issue rate bounds it (132 SMs x 64 lanes x 1.98 GHz),
// not HBM. The table body spent about ten times that: each thread rebuilt
// its two branch metrics from the symbols with runtime label bit tests,
// and paid two shared loads, a ballot, a store, a CTA-wide barrier and a
// symbol fetch with its own address arithmetic on every stage. The warp
// body spends a handful of instructions per state and stage and no
// barrier, and runs K1 at about a third of the bound on that card
// (chip_smoke.py phase 6; PERF.md).
//
// Layout. A parallel block's N states live in L = N/S lanes of one warp,
// S path metrics per lane in registers; neighbouring lanes hold
// neighbouring blocks (lane = sub * Gw + gi, Gw blocks per warp, sub the
// lane's rank inside its block), so every load and store of a warp spans
// neighbouring b. Slot q = sub << log2(S) | i (register i of lane sub)
// holds, before the stage at phase p = t mod v, the state rot(q, p): q
// rotated right by p over v = K - 1 bits. The stage at phase p pairs the
// two slots that differ in bit p (the even and odd predecessor) and writes
// both targets back into the same two slots (the in-place butterfly), so
// after v stages every state is home again and nothing moves but values.
// A bit p below log2(S) is a register bit: the butterfly is register
// renaming in a fully unrolled body. Above it, the partner slot is in
// another lane: one __shfl_xor_sync per state, log2(L) stages in v.
// No barrier: a block never leaves its warp.
//
// Branch metrics once per stage and lane. Each stage forms the 2^(R-1)
// folded rows +-y_0 +- y_1 ... (R - 1 adds each, in r order, no multiply,
// so no FMA contraction can change a float sum) and each state's metric is
// + or - one row, chosen by an (index, sign) that MotherCode::label
// derives at compile time. A label is linear over GF(2) in the target
// state, so a lane's share of the state bits (rot(sub << log2 S, p + 1))
// adds one XOR mask per phase to every label of the lane; the body applies
// it by negating the symbols it names (BM(c ^ m) is BM(c) of the symbols
// with the signs of m flipped; negation commutes with rounding, so float
// stays bit-exact).
//
// ACS. A compare and a select per target (ptxas lowers the pair to
// VIMNMX); ties keep the even predecessor. Where the partner sits in the
// other lane, the lane that holds the odd predecessor swaps the pair
// before the compare, so the tie-break stays the reference's. (The DPX
// intrinsic __vibmin_s32 was tried in its place; see acs_select.)
//
// Survivor words. A decision of target s is bit s % 32 of word s / 32.
// Each lane ors its decisions into words at compile-time bit positions,
// shifts them by its share of the state's low five bits, and ors them over
// the lanes that share a word with shuffles; one lane of each group
// stores each word, chosen by a select and stored with one predicated
// instruction (no branch), so a warp stores Gw neighbouring b of a (t, w)
// row: 128 contiguous bytes at S = N.
//
// Narrow modes (i16/i8, kNarrow) keep int32 registers, as the TPU kernels
// do: the saturation budget keeps every value inside the narrow dtype, so
// int32 arithmetic gives the narrow dtype's values. Every norm_every-th
// ACS step (counted globally: step % norm_every == norm_every - 1)
// subtracts the minimum over the block's N states: over the lane's
// registers, then by shuffle-xor over its L lanes. kNarrow is a template
// parameter so that the f32 loop carries no clip, countdown or reduction.
// Symbols are read in their wire dtype, widened, then clipped to +-qmax.
//
// Radix 4 (kStagesPerStep = 2): two radix-2 sub-stages per step with one
// normalization round per step, as the TPU kernel's staged radix-4 step
// (radix4_stage_pair without combine), which is the op sequence of two
// radix-2 stages and so bit-exact in float too. At odd T a trailing
// radix-2 stage follows, min-subtracted unconditionally in narrow modes.
//
// The stage loop runs blocks of v stages (the phase is then a compile-time
// constant), fetching the next block's symbols into registers while the
// current block computes; the steps are guarded by t < T, so the last
// block may be partial. (A second, unguarded copy of the block body for
// the whole blocks was tried; nvcc 12.9 crashed on it.)
// The final metrics leave through the slot map of phase T mod v.
//
// Matrix warp body (forward_acs_matrix_warp<Code, S, k>, WarpMatrix): the
// k-stage (min,+) step of the TPU's matrix_step in its VPU form (e = None,
// the form of its fused _acs_phase_mat_dbuf), on the warp body's slot map
// unchanged. A step from phase p covers, for each group, the 2^k slots that
// differ in slot bits p .. p+k-1 (mod v): their metrics are the
// predecessors 2^k*u + j, and the step writes the 2^k targets c*U + u back
// into the same slots, where the butterfly would have them k stages on
// (the in-place radix-2^k butterfly). A bit below log2 S is register
// renaming; a lane bit costs one __shfl_xor_sync per gathered metric. No
// shared memory, no barrier, no atomics. Once per step and lane the
// 2^(kR-1) folded k-stage rows are formed from the kR-symbol window
// (kR - 1 adds each, in the reference's order; rows no label of the phase
// names are dead code), and each of a target's 2^k candidates adds + or -
// one row, its (index, sign) fixed at compile time by MotherCode::mlabel
// (the constexpr counterpart of ConvCode.matrix_acs_tables(k), held
// against kernel_matrix_table before a launch). A combined label is linear
// over GF(2) in (c, j, u), so with candidate index e (j = e ^ the lane's c
// bits) every label is a register-only constant xor one mask per lane and
// phase, applied by negating the window's symbols it names. k rounds of
// compare and select (strict < on the odd candidate; in a round whose bit
// is a lane bit, the lane whose c has that bit swaps the pair first, as the
// butterfly's cross-lane stage does) reduce the candidates; round i's
// decisions are the radix-2 plane of stage t+i, and each slot emits the
// one decision of the state the butterfly's slot would hold after stage
// t+i (a compile-time choice), so the warp body's word assembly and
// predicated stores serve every round. The step loop runs blocks of
// lcm(v, k) stages (the phase a compile-time constant), fetching the next
// v stages (k | v) or the next step one fetch ahead into registers;
// min-subtract on the global k-step cadence; the T mod k trailing stages
// run the warp body's radix-2 stage, min-subtracted unconditionally in the
// narrow modes. One instantiation per (code, k) at one S
// (matrix_warp_states), the narrow modes a run-time property.
//
// What bounds it on the H100 80GB HBM3 (700 W limit): the function is
// K1's (the INT32 issue rate, 0.0753 ms at the main shapes); the
// algorithm's own work per k-step and target is 2^k adds and 2^k - 1
// compare-selects, K1's work times 1.29, 2.02 and 3.72 at k = 2, 3, 4
// (chip_smoke.py k1_matrix_cost: 0.0969, 0.1523 and 0.2802 ms), so the
// matrix form cannot beat the butterfly on this card, whose bound is the
// operation count: a chain k times shorter buys nothing with 8,192 blocks
// in flight. On that card K1-matrix on this body takes about 0.31, 0.34
// and 0.44 ms at k = 2, 3, 4 and the fused serial matrix variant 0.54 ms
// at k = 2 (the table body: 1.92 and 1.98 ms at k = 2; PERF.md,
// chip_smoke.py phase 14 and launch/kernel_times.py).
//
// Matrix table body (forward_acs_matrix<k>): the k-stage (min,+) step of the TPU's
// matrix_step (repro/kernels/acs.py), in the gather-and-sign form of its
// fused body _acs_phase_mat_dbuf. One thread per target state
// n' = c*U + u (U = N >> k): the threads of a block first write the step's
// 2^(kR-1) folded combined rows to shared memory; each thread then forms
// its 2^k candidates pm[2^k*u + j] +- row[fold_idx[c][j][u]] and runs k
// suffix-min rounds (strict < on the odd candidate, so ties keep the even
// predecessor). Round i's decisions are the radix-2 plane of stage t+i;
// the threads with c < 2^(i+1) own it, each a run of 2^(k-1-i) bits at
// state c*N/2^(i+1) + u*2^(k-1-i), or-ed into a shared word with
// atomicOr. Two barriers per step (metrics and words, then the next rows).
// The T mod k trailing stages run the table body's radix-2 stage,
// min-subtracted unconditionally in the narrow modes. Integer symbols
// only: the callers lower float to the radix-2 butterfly, as the
// reference does.
//
// Table body (forward_acs_table). One thread per target state s; G =
// blockDim.x / N parallel blocks per CTA, block g on threads [g*N,
// (g+1)*N). Path metrics ping-pong in shared memory, one __syncthreads()
// per stage. Each warp's 32 decisions are one survivor word (bit = lane =
// s % 32), packed with __ballot_sync; for N < 32 a warp holds 32/N blocks
// and each block's word is its N-bit slice. Radix 4 runs two radix-2
// sub-stages per step, as the warp body; narrow modes reduce the minimum
// by warp shuffles, then shared memory for N > 32. Build without
// --use_fast_math.

#pragma once

#include <cstddef>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace pbvd {

constexpr int kMaxR = 4;

// Branch metric of R-bit label c, as the reference builds it: folded row
// k = c (MSB 0) or its complement, chained in r order, then the fold sign.
template <typename Acc>
__device__ __forceinline__ Acc label_metric(const Acc (&y)[kMaxR], int c, int R) {
  const int full = (1 << R) - 1;
  const bool neg = c >= (1 << (R - 1));
  const int k = neg ? (c ^ full) : c;
  Acc acc = ((k >> (R - 1)) & 1) ? y[0] : -y[0];
#pragma unroll
  for (int r = 1; r < kMaxR; ++r) {
    if (r < R) {
      const Acc term = ((k >> (R - 1 - r)) & 1) ? y[r] : -y[r];
      acc = acc + term;
    }
  }
  return neg ? -acc : acc;
}

template <typename Acc>
__device__ __forceinline__ Acc acc_min(Acc a, Acc b) {
  return b < a ? b : a;
}

// Stage t's symbols of block b, widened and (qmax > 0) clipped to +-qmax.
template <typename Sym, typename Acc>
__device__ __forceinline__ void load_stage(const Sym* __restrict__ y, int t, int R, int B, int b,
                                           int qmax, Acc (&out)[kMaxR]) {
  const size_t base = static_cast<size_t>(t) * R * B + b;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r < R) {
      Acc v = static_cast<Acc>(y[base + static_cast<size_t>(r) * B]);
      if (qmax) {
        const Acc hi = static_cast<Acc>(qmax);
        v = v > hi ? hi : (v < -hi ? -hi : v);
      }
      out[r] = v;
    }
  }
}

// The lanes of this warp that exist: a CTA of fewer than 32 threads (the
// fused kernel at G = 1 and N < 32) fills one warp only partly.
__device__ __forceinline__ unsigned warp_lanes() {
  return blockDim.x >= 32 ? 0xffffffffu : ((1u << blockDim.x) - 1u);
}

// Minimum of m over the N threads of this thread's parallel block. Every
// thread of the CTA must call it (it holds a barrier for N > 32). `red`
// holds G * N / 32 slots; the caller's per-stage barrier separates one
// call's reads from the next call's writes.
template <typename Acc>
__device__ __forceinline__ Acc block_min(Acc m, int log2n, Acc* red) {
  const int N = 1 << log2n;
  const int span = N < 32 ? N : 32;
  for (int off = span >> 1; off > 0; off >>= 1) {
    m = acc_min(m, __shfl_xor_sync(warp_lanes(), m, off));
  }
  if (N <= 32) return m;
  const int tid = threadIdx.x;
  const int warps = N >> 5;  // warps per parallel block
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  const Acc* r = red + (tid >> log2n) * warps;
  Acc out = r[0];
  for (int w = 1; w < warps; ++w) out = acc_min(out, r[w]);
  return out;
}

// Shared-memory slots (in Acc units) the forward loop needs: two PM planes
// and the min-reduction slots.
__host__ __device__ inline int forward_smem_slots(int G, int log2n) {
  const int N = 1 << log2n;
  return 2 * G * N + G * (N >= 32 ? N / 32 : 1);
}

// The 4-byte slots the matrix loop needs beyond forward_smem_slots: per
// parallel block, the 2^(kR-1) folded combined rows of a step and k
// decision planes of ceil(N/32) words.
__host__ __device__ inline int matrix_smem_slots(int G, int log2n, int k, int R) {
  const int W = ((1 << log2n) + 31) >> 5;
  return G * ((1 << (k * R - 1)) + k * W);
}

// This thread's view of the radix-2 stage: its state s and parallel block,
// its even/odd predecessor labels, the PM ping-pong and the min slots in
// shared memory (the first forward_smem_slots of smem).
template <typename Acc>
struct Radix2 {
  Acc* pm_cur;
  Acc* pm_nxt;
  Acc* red;
  int R, log2n, tid, s, lane, pe, lab_even, lab_odd;
  bool valid, stores;
  unsigned slice;

  __device__ __forceinline__ Radix2(const int* __restrict__ labels, int R_, int B, int log2n_,
                                    Acc* smem) {
    const int N = 1 << log2n_;
    const int G = blockDim.x >> log2n_;
    R = R_;
    log2n = log2n_;
    tid = threadIdx.x;
    const int g = tid >> log2n;
    s = tid & (N - 1);
    lane = tid & 31;
    valid = static_cast<int>(blockIdx.x) * G + g < B;
    pe = g * N + 2 * (s & ((N >> 1) - 1));  // even predecessor slot
    lab_even = labels[2 * s];
    lab_odd = labels[2 * s + 1];
    stores = N >= 32 ? lane == 0 : s == 0;
    slice = N >= 32 ? 0xffffffffu : ((1u << N) - 1u);
    pm_cur = smem;
    pm_nxt = smem + G * N;
    red = smem + 2 * G * N;
  }

  // one radix-2 stage: compare-select, store the survivor word, optionally
  // normalize, write the new metric, barrier
  template <typename Store>
  __device__ __forceinline__ void stage(int t, const Acc (&yt)[kMaxR], bool normalize,
                                        Store& store) {
    const int N = 1 << log2n;
    const Acc m_even = pm_cur[pe] + label_metric(yt, lab_even, R);
    const Acc m_odd = pm_cur[pe + 1] + label_metric(yt, lab_odd, R);
    const bool dec = m_odd < m_even;
    Acc m = dec ? m_odd : m_even;
    const unsigned ballot = __ballot_sync(warp_lanes(), dec);
    if (stores && valid) {
      store(t, s >> 5, N >= 32 ? ballot : (ballot >> lane) & slice);
    }
    if (normalize) m = m - block_min(m, log2n, red);
    pm_nxt[tid] = m;
    __syncthreads();
    Acc* tmp = pm_cur;
    pm_cur = pm_nxt;
    pm_nxt = tmp;
  }
};

// The table body: the forward ACS of this thread's state over T stages. store(t, w, word)
// is called by one thread per (valid block, stage, survivor word). Returns
// this thread's final path metric. Ends with a __syncthreads(), so what the
// stores wrote to shared memory is visible to the whole CTA. norm_every and
// qmax are read only when kNarrow.
template <int kStagesPerStep, bool kNarrow, typename Sym, typename Acc, typename Store>
__device__ __forceinline__ Acc forward_acs_table(const Sym* __restrict__ y,
                                           const int* __restrict__ labels, int T, int R, int B,
                                           int log2n, int norm_every, int qmax, Acc* smem,
                                           Store store) {
  const int G = blockDim.x >> log2n;
  const int b = blockIdx.x * G + (static_cast<int>(threadIdx.x) >> log2n);
  Radix2<Acc> st(labels, R, B, log2n, smem);
  st.pm_cur[st.tid] = Acc(0);

  if (!kNarrow) qmax = 0;
  const int n_steps = T / kStagesPerStep;
  Acc yc[kStagesPerStep][kMaxR] = {};
  Acc yn[kStagesPerStep][kMaxR] = {};
  if (st.valid && n_steps > 0) {
#pragma unroll
    for (int i = 0; i < kStagesPerStep; ++i) load_stage(y, i, R, B, b, qmax, yc[i]);
  }
  __syncthreads();

  // steps left until the next min-subtract: it falls after step r exactly
  // when r % norm_every == norm_every - 1, with no division in the loop
  int norm_left = norm_every;
  for (int r = 0; r < n_steps; ++r) {
    if (st.valid && r + 1 < n_steps) {  // fetch the next step's symbols now
#pragma unroll
      for (int i = 0; i < kStagesPerStep; ++i) {
        load_stage(y, (r + 1) * kStagesPerStep + i, R, B, b, qmax, yn[i]);
      }
    }
    bool normalize = false;
    if (kNarrow && --norm_left == 0) {
      normalize = true;
      norm_left = norm_every;
    }
#pragma unroll
    for (int i = 0; i < kStagesPerStep; ++i) {
      st.stage(r * kStagesPerStep + i, yc[i], normalize && i == kStagesPerStep - 1, store);
    }
#pragma unroll
    for (int i = 0; i < kStagesPerStep; ++i) {
#pragma unroll
      for (int k = 0; k < kMaxR; ++k) yc[i][k] = yn[i][k];
    }
  }
  if (kStagesPerStep == 2 && (T & 1)) {
    // trailing radix-2 stage (odd T); narrow modes normalize unconditionally
    Acc yl[kMaxR] = {};
    if (st.valid) load_stage(y, T - 1, R, B, b, qmax, yl);
    st.stage(T - 1, yl, kNarrow, store);
  }
  return st.pm_cur[st.tid];
}

// The k-stage (min,+) forward ACS of this thread's target state over T
// stages (T / kK matrix steps, then T mod kK radix-2 stages). mtab holds,
// for [c][j][u] flattened, 2*fold_idx + (fold_sgn < 0). smem holds
// forward_smem_slots + matrix_smem_slots ints. Same contract as
// forward_acs_table: store(t, w, word) per (valid block, stage, word), returns
// the final path metric, ends with a __syncthreads(). Needs kK <= log2n and
// kK * R <= 8 (the callers validate it).
template <int kK, bool kNarrow, typename Sym, typename Store>
__device__ __forceinline__ int forward_acs_matrix(const Sym* __restrict__ y,
                                                  const int* __restrict__ labels,
                                                  const int* __restrict__ mtab, int T, int R,
                                                  int B, int log2n, int norm_every, int qmax,
                                                  int* smem, Store store) {
  constexpr int kNk = 1 << kK;
  const int N = 1 << log2n;
  const int W = (N + 31) >> 5;
  const int G = blockDim.x >> log2n;
  Radix2<int> st(labels, R, B, log2n, smem);  // PM ping-pong, min slots, trailing stages
  const int s = st.s;
  const int g = st.tid >> log2n;
  const int b = blockIdx.x * G + g;
  const int ulog = log2n - kK;
  const int c = s >> ulog;               // target group: the k input bits
  const int u = s & ((1 << ulog) - 1);   // its predecessors are 2^k*u + j
  const int nb = kK * R;                 // label bits of a k-stage window
  const int nf = 1 << (nb - 1);          // folded combined rows
  int* rows = smem + forward_smem_slots(G, log2n) + g * nf;
  unsigned* planes = reinterpret_cast<unsigned*>(smem + forward_smem_slots(G, log2n) + G * nf) +
                     g * kK * W;
  int sel[kNk];
#pragma unroll
  for (int j = 0; j < kNk; ++j) sel[j] = mtab[(((c << kK) + j) << ulog) | u];
  const int pbase = g * N + (u << kK);
  for (int q = s; q < kK * W; q += N) planes[q] = 0u;
  st.pm_cur[st.tid] = 0;

  // row f = sum over the window's symbols r (stage-major) of +y_r where bit
  // nb-1-r of f is 1, -y_r where it is 0 (folded_matrix_codeword_signs)
  auto make_rows = [&](const int (&yk)[kK][kMaxR]) {
    for (int f = s; f < nf; f += N) {
      int acc = 0;
#pragma unroll
      for (int i = 0; i < kK; ++i) {
#pragma unroll
        for (int r = 0; r < kMaxR; ++r) {
          if (r < R) {
            const int bit = (f >> (nb - 1 - (i * R + r))) & 1;
            acc += bit ? yk[i][r] : -yk[i][r];
          }
        }
      }
      rows[f] = acc;
    }
  };

  if (!kNarrow) qmax = 0;
  const int n_steps = T / kK;
  const bool loads = st.valid && s < nf;  // only the row makers read symbols
  int yc[kK][kMaxR] = {};
  int yn[kK][kMaxR] = {};
  if (loads && n_steps > 0) {
#pragma unroll
    for (int i = 0; i < kK; ++i) load_stage(y, i, R, B, b, qmax, yc[i]);
  }
  make_rows(yc);
  __syncthreads();

  int norm_left = norm_every;  // countdown to the next min-subtract, as forward_acs_table
  for (int r = 0; r < n_steps; ++r) {
    const int t = r * kK;
    if (loads && r + 1 < n_steps) {
#pragma unroll
      for (int i = 0; i < kK; ++i) load_stage(y, t + kK + i, R, B, b, qmax, yn[i]);
    }
    int cand[kNk];
#pragma unroll
    for (int j = 0; j < kNk; ++j) {
      const int e = sel[j];
      const int v = rows[e >> 1];
      cand[j] = st.pm_cur[pbase + j] + ((e & 1) ? -v : v);
    }
#pragma unroll
    for (int i = 0; i < kK; ++i) {
      unsigned run = 0u;
#pragma unroll
      for (int h = 0; h < (kNk >> (i + 1)); ++h) {
        const bool d = cand[2 * h + 1] < cand[2 * h];
        cand[h] = d ? cand[2 * h + 1] : cand[2 * h];
        run |= static_cast<unsigned>(d) << h;
      }
      if (c < (2 << i)) {  // groups c < 2^(i+1) cover stage t+i's plane once
        const int p = c * (N >> (i + 1)) + (u << (kK - 1 - i));
        atomicOr(&planes[i * W + (p >> 5)], run << (p & 31));
      }
    }
    int m = cand[0];
    if (kNarrow && --norm_left == 0) {
      norm_left = norm_every;
      m -= block_min(m, log2n, st.red);
    }
    st.pm_nxt[st.tid] = m;
    __syncthreads();  // metrics and decision words complete; rows read
    for (int q = s; q < kK * W; q += N) {
      const unsigned word = planes[q];
      planes[q] = 0u;
      if (st.valid) store(t + q / W, q % W, word);
    }
    if (r + 1 < n_steps) make_rows(yn);
    int* tmp = st.pm_cur;
    st.pm_cur = st.pm_nxt;
    st.pm_nxt = tmp;
#pragma unroll
    for (int i = 0; i < kK; ++i) {
#pragma unroll
      for (int k = 0; k < kMaxR; ++k) yc[i][k] = yn[i][k];
    }
    __syncthreads();  // next rows written, planes cleared
  }
  for (int t = n_steps * kK; t < T; ++t) {
    // trailing radix-2 stages (T mod k); narrow modes normalize unconditionally
    int yl[kMaxR] = {};
    if (st.valid) load_stage(y, t, R, B, b, qmax, yl);
    st.stage(t, yl, kNarrow, store);
  }
  return st.pm_cur[st.tid];
}


// ---------------------------------------------------------------------------
// The warp body: compile-time mother codes, a block's states in one warp
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int parity_of(unsigned x) {
  int p = 0;
  for (; x; x >>= 1) p ^= static_cast<int>(x & 1u);
  return p;
}

__host__ __device__ constexpr int popcount_of(unsigned x) {
  int n = 0;
  for (; x; x >>= 1) n += static_cast<int>(x & 1u);
  return n;
}

__host__ __device__ constexpr int log2_of(int x) {
  int k = 0;
  while ((1 << k) < x) ++k;
  return k;
}

// An (R, 1, K) mother code with its generator polynomials as integers, bit
// K-1 the input tap (repro_torch.core.trellis.ConvCode.poly_ints).
template <int kK, unsigned kG0, unsigned kG1, unsigned kG2 = 0u>
struct MotherCode {
  static constexpr int K = kK;
  static constexpr int R = kG2 ? 3 : 2;
  static constexpr int v = kK - 1;
  static constexpr int N = 1 << v;
  static constexpr int W = (N + 31) / 32;  // survivor words per stage
  static constexpr int NF = 1 << (R - 1);  // folded rows per stage

  __host__ __device__ static constexpr unsigned poly(int r) {
    return r == 0 ? kG0 : (r == 1 ? kG1 : kG2);
  }

  // R-bit label (filter 0 in the MSB) of the branch into target state s
  // from its even (bit = 0) or odd (bit = 1) predecessor 2*(s mod N/2) +
  // bit: the encoder output of that state with input x = s >> (v-1),
  // ConvCode.output_int. It is linear over GF(2) in (s, bit).
  __host__ __device__ static constexpr int label(int s, int bit) {
    const unsigned pred = 2u * static_cast<unsigned>(s & (N / 2 - 1)) + static_cast<unsigned>(bit);
    const unsigned x = static_cast<unsigned>(s) >> (v - 1);
    int c = 0;
    for (int r = 0; r < R; ++r) {
      const unsigned g = poly(r);
      c = (c << 1) | (parity_of(pred & g & (N - 1u)) ^ static_cast<int>(x & (g >> v) & 1u));
    }
    return c;
  }

  // q rotated right by k over v bits
  __host__ __device__ static constexpr int rot(int q, int k) {
    k %= v;
    return k == 0 ? q : (((q >> k) | (q << (v - k))) & (N - 1));
  }

  // R-bit encoder output from state s with input x (ConvCode.output_int):
  // the label of the branch from s into (x << (v-1)) | (s >> 1)
  __host__ __device__ static constexpr int output(int s, int x) {
    return label((x << (v - 1)) | (s >> 1), s & 1);
  }

  // kR-bit combined label of the k-stage path from predecessor 2^k*u + j
  // into target c*U + u (U = N >> k), stage t in the MSBs:
  // ConvCode.matrix_acs_tables(k)["cc"][c, j, u]. Linear over GF(2) in
  // (c, j, u), as label is in (s, bit).
  __host__ __device__ static constexpr int mlabel(int k, int c, int j, int u) {
    const int U = N >> k;
    int lab = 0;
    for (int i = 0; i < k; ++i) {
      const int s = ((c & ((1 << i) - 1)) * U + u) * (1 << (k - i)) + (j >> i);
      lab = (lab << R) | output(s, (c >> i) & 1);
    }
    return lab;
  }

  // the k that the matrix warp body is built for: validate_matrix_k and
  // the CUDA limit of 4
  __host__ __device__ static constexpr bool matrix_k_ok(int k) {
    return k >= 1 && k <= 4 && k <= v && k * R <= 8;
  }
};

using Ccsds = MotherCode<7, 0171u, 0133u>;
using Is95 = MotherCode<9, 0753u, 0561u>;
using Lte = MotherCode<7, 0133u, 0171u, 0165u>;

// The code ids of the C interfaces: 0 is the runtime-table body.
enum : int { kCodeTable = 0, kCodeCcsds = 1, kCodeIs95 = 2, kCodeLte = 3 };

// Writes the (N, 2) even/odd labels of code id `code` to out (2N ints) and
// returns N, or -1 for an id without an instantiation. The wrappers hold
// them against kernel_labels(code) before any launch.
template <class Code>
inline int write_labels(int* out) {
  for (int s = 0; s < Code::N; ++s) {
    out[2 * s] = Code::label(s, 0);
    out[2 * s + 1] = Code::label(s, 1);
  }
  return Code::N;
}

inline int code_labels(int code, int* out) {
  switch (code) {
    case kCodeCcsds: return write_labels<Ccsds>(out);
    case kCodeIs95: return write_labels<Is95>(out);
    case kCodeLte: return write_labels<Lte>(out);
    default: return -1;
  }
}

// Writes the (2^k, 2^k, N >> k) matrix table [c][j][u] of code id `code`
// as the matrix warp body derives it at compile time, 2 * fold_idx +
// (fold_sgn < 0) (kernel_matrix_table), and returns its length, or -1 for
// an id or k without an instantiation. The wrappers hold it against
// kernel_matrix_table(code, k) before any launch.
template <class Code>
inline int write_matrix_table(int k, int* out) {
  if (!Code::matrix_k_ok(k)) return -1;
  const int nk = 1 << k, U = Code::N >> k, nf = 1 << (k * Code::R - 1);
  for (int c = 0; c < nk; ++c) {
    for (int j = 0; j < nk; ++j) {
      for (int u = 0; u < U; ++u) {
        const int cc = Code::mlabel(k, c, j, u);
        out[(c * nk + j) * U + u] = cc < nf ? 2 * cc : 2 * (cc ^ (2 * nf - 1)) + 1;
      }
    }
  }
  return nk * nk * U;
}

inline int code_matrix_table(int code, int k, int* out) {
  switch (code) {
    case kCodeCcsds: return write_matrix_table<Ccsds>(k, out);
    case kCodeIs95: return write_matrix_table<Is95>(k, out);
    case kCodeLte: return write_matrix_table<Lte>(k, out);
    default: return -1;
  }
}

// The S (path metrics per lane) of the matrix warp body's one
// instantiation per (code, k); 0 where none is built. Beyond k = 2 the
// S·2^k labels of a lane span every one of the 2^(kR-1) folded rows, which
// stay in registers beside the S metrics, so k = 4 halves S; IS-95 (N =
// 256) runs S = 32 at every k: at S = 64 its metrics alone fill a quarter
// of the registers, and its k = 1 and k = 2 builds spilled.
template <class Code>
__host__ __device__ constexpr int matrix_warp_states(int k) {
  if (!Code::matrix_k_ok(k)) return 0;
  if (Code::N == 256) return 32;
  if (Code::R == 3) return 16;
  return k == 4 ? 16 : 32;
}

// The slot map of the warp body for S states per lane (see the header).
template <class Code, int kS>
struct WarpMap {
  static constexpr int S = kS;
  static constexpr int L = Code::N / kS;  // lanes per parallel block
  static constexpr int kLogS = log2_of(kS);
  static constexpr int kLogL = log2_of(L);
  static_assert((1 << kLogS) == kS && kS >= 2 && kS <= Code::N, "S: a power of two <= N");
  static_assert(L <= 32, "a parallel block must fit in one warp");
  static_assert(Code::N >= 32, "the word assembly assumes whole 32-bit words");

  // state-bit position of the lane's sub bit k in the targets of phase p
  __host__ __device__ static constexpr int sub_pos(int k, int p) {
    return ((kLogS + k - p - 1) % Code::v + Code::v) % Code::v;
  }
  // sub bits that land in the targets' low five bits (the bit position
  // inside a word) at phase p: the lanes that differ in them share words
  __host__ __device__ static constexpr unsigned below(int p) {
    unsigned m = 0;
    for (int k = 0; k < kLogL; ++k) {
      if (sub_pos(k, p) < 5) m |= 1u << k;
    }
    return m;
  }
  // words (as w' = rot(i, p + 1) >> 5) that the registers fill at phase p
  __host__ __device__ static constexpr unsigned words(int p) {
    unsigned m = 0;
    for (int i = 0; i < kS; ++i) m |= 1u << (Code::rot(i, p + 1) >> 5);
    return m;
  }
};

// min(m_even, m_odd) and the decision "odd strictly smaller" (ties keep the
// even predecessor), as a compare and a select; ptxas lowers the pair to
// VIMNMX on sm_90. Hopper's DPX intrinsic __vibmin_s32(a, b, &pred) (CUDA
// 12.9: crt/device_functions.hpp, inline PTX setp.le + two selp on sm_90,
// which ptxas also turns into VIMNMX with a predicate out) was tried in its
// place: it was a few percent faster at S = 32 and 16 on the H100 80GB
// HBM3 (700 W), but the S = 64 instantiations of CCSDS, LTE and IS-95
// built with it wrote wrong survivor bits, in groups of eight (the
// predicates packed with P2R), while this form was right at every S.
template <typename Acc>
__device__ __forceinline__ Acc acs_select(Acc m_even, Acc m_odd, bool& dec) {
  dec = m_odd < m_even;
  return dec ? m_odd : m_even;
}

// The branch metric of compile-time label C: + or - one folded row.
template <int C, int NF, typename Acc>
__device__ __forceinline__ Acc bm_of(const Acc (&row)[NF]) {
  if constexpr (C < NF) {
    return row[C];
  } else {
    return -row[C ^ (2 * NF - 1)];
  }
}

// load_block of the warp body for symbols y (T, R, B) of dtype 0 = int8,
// 1 = int16, 2 = int32, 3 = float32 (the float instantiation reads float
// only): stage t0 + p's symbol r of block b, widened and, in the narrow
// modes, clipped to +-qmax after widening; 0 past T or for b >= B. One
// switch per block of stages keeps the symbol dtype out of the templates.
template <typename Sym, bool kNarrow, typename Acc, int V, int R>
__device__ __forceinline__ void load_block_as(const Sym* __restrict__ y, int t0, int T, int B,
                                              int b, bool valid, int qmax, Acc (&dst)[V][R]) {
#pragma unroll
  for (int p = 0; p < V; ++p) {
    const bool live = valid && t0 + p < T;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Acc x = Acc(0);
      if (live) {
        x = static_cast<Acc>(y[(static_cast<size_t>(t0 + p) * R + r) * B + b]);
        if (kNarrow) {
          const Acc hi = static_cast<Acc>(qmax);
          x = x > hi ? hi : (x < -hi ? -hi : x);
        }
      }
      dst[p][r] = x;
    }
  }
}

template <bool kNarrow, typename Acc, int V, int R>
__device__ __forceinline__ void load_block(const void* y, int dtype, int t0, int T, int B, int b,
                                           bool valid, int qmax, Acc (&dst)[V][R]) {
  if constexpr (std::is_same<Acc, float>::value) {
    load_block_as<float, false>(static_cast<const float*>(y), t0, T, B, b, valid, qmax, dst);
  } else {
    if (dtype == 0) {
      load_block_as<int8_t, kNarrow>(static_cast<const int8_t*>(y), t0, T, B, b, valid, qmax,
                                     dst);
    } else if (dtype == 1) {
      load_block_as<int16_t, kNarrow>(static_cast<const int16_t*>(y), t0, T, B, b, valid, qmax,
                                      dst);
    } else {
      load_block_as<int32_t, kNarrow>(static_cast<const int32_t*>(y), t0, T, B, b, valid, qmax,
                                      dst);
    }
  }
}

// One lane of the warp body: its S path metrics in registers and its share
// of the slot map per phase. The member templates recurse over the
// compile-time phase P, pair H, register I and word Wd, so every register
// index and every label is a constant.
template <class Code, int kS, int kStagesPerStep, bool kNarrow, typename Acc>
struct WarpAcs {
  using Map = WarpMap<Code, kS>;
  static constexpr int v = Code::v, R = Code::R, W = Code::W, NF = Code::NF;
  static constexpr int S = kS, L = Map::L, kLogS = Map::kLogS, kLogL = Map::kLogL;
  static_assert(v % kStagesPerStep == 0, "a block of v stages holds whole steps");
  static_assert(!kNarrow || std::is_same<Acc, int>::value, "narrow modes are integer");

  Acc pm[S];
  // this lane's share of the targets of phase p (rot(sub << log2 S, p + 1)):
  // its label mask, bit shift and word offset, and its rank among the
  // lanes that share its words (read only when L > 1)
  int lane_flip[v], lane_shift[v], lane_woff[v], lane_rank[v];
  int sub, gw;
  unsigned lanes;

  __device__ __forceinline__ WarpAcs(int sub_, int gw_, unsigned lanes_)
      : sub(sub_), gw(gw_), lanes(lanes_) {
#pragma unroll
    for (int i = 0; i < S; ++i) pm[i] = Acc(0);
    if constexpr (L > 1) {
#pragma unroll
      for (int p = 0; p < v; ++p) {
        const int ls = Code::rot(sub << kLogS, p + 1);
        lane_flip[p] = Code::label(ls, 0);
        lane_shift[p] = ls & 31;
        lane_woff[p] = ls >> 5;
        const unsigned below = Map::below(p);
        int rank = 0, j = 0;
#pragma unroll
        for (int k = 0; k < kLogL; ++k) {
          if ((below >> k) & 1u) {
            rank |= ((sub >> k) & 1) << j;
            ++j;
          }
        }
        lane_rank[p] = rank;
      }
    }
  }

  // phase P < log2 S: pair H, slots i0 and i1 (bit P clear / set) of this lane
  template <int P, int H>
  __device__ __forceinline__ void pairs(const Acc (&row)[NF], unsigned (&part)[W]) {
    if constexpr (H < S / 2) {
      constexpr int i0 = ((H >> P) << (P + 1)) | (H & ((1 << P) - 1));
      constexpr int i1 = i0 | (1 << P);
      constexpr int s0 = Code::rot(i0, P + 1);  // x = 0: target into slot i0
      constexpr int s1 = Code::rot(i1, P + 1);  // x = 1: target into slot i1
      const Acc pe = pm[i0];
      const Acc po = pm[i1];
      bool d0, d1;
      pm[i0] = acs_select(pe + bm_of<Code::label(s0, 0)>(row),
                                po + bm_of<Code::label(s0, 1)>(row), d0);
      pm[i1] = acs_select(pe + bm_of<Code::label(s1, 0)>(row),
                                po + bm_of<Code::label(s1, 1)>(row), d1);
      if (d0) part[s0 >> 5] |= 1u << (s0 & 31);
      if (d1) part[s1 >> 5] |= 1u << (s1 & 31);
      pairs<P, H + 1>(row, part);
    }
  }

  // phase P >= log2 S: register I against register I of the lane across
  // sub bit P - log2 S; x: this lane holds the odd predecessor
  template <int P, int I>
  __device__ __forceinline__ void cross(const Acc (&row)[NF], unsigned (&part)[W], bool x) {
    if constexpr (I < S) {
      constexpr int k = P - kLogS;
      constexpr int s = Code::rot(I, P + 1);
      const Acc mine = pm[I];
      const Acc theirs = __shfl_xor_sync(lanes, mine, gw << k);
      const Acc pe = x ? theirs : mine;
      const Acc po = x ? mine : theirs;
      bool d;
      pm[I] = acs_select(pe + bm_of<Code::label(s, 0)>(row),
                               po + bm_of<Code::label(s, 1)>(row), d);
      if (d) part[s >> 5] |= 1u << (s & 31);
      cross<P, I + 1>(row, part, x);
    }
  }

  // reduce survivor word Wd (as w') of phase P into red[ord]: shift it by
  // the lane's share of the bit position, or it over the lanes that share it
  template <int P, int Wd, int kN>
  __device__ __forceinline__ void reduce_words(const unsigned (&part)[W], unsigned (&red)[kN],
                                               int (&widx)[kN]) {
    if constexpr (Wd < W) {
      constexpr unsigned kWords = Map::words(P);
      constexpr unsigned kBelow = Map::below(P);
      if constexpr ((kWords >> Wd) & 1u) {
        constexpr int ord = popcount_of(kWords & ((1u << Wd) - 1u));
        unsigned word = part[Wd];
        if constexpr (kBelow != 0u) {
          word <<= lane_shift[P];
#pragma unroll
          for (int k = 0; k < kLogL; ++k) {
            if ((kBelow >> k) & 1u) word |= __shfl_xor_sync(lanes, word, gw << k);
          }
        }
        red[ord] = word;
        widx[ord] = Wd;
      }
      reduce_words<P, Wd + 1>(part, red, widx);
    }
  }

  // the survivor words of phase P: the gs lanes that share a set of words
  // hold them all after the reduction; the lane of rank r stores entries
  // r, r + gs, ... (a select, not a branch, picks its entry), so every
  // store of the warp is one predicated instruction
  template <int P, typename Store>
  __device__ __forceinline__ void emit(const unsigned (&part)[W], int t, Store& store) {
    constexpr unsigned kWords = Map::words(P);
    constexpr int kN = popcount_of(kWords);
    constexpr int gs = 1 << popcount_of(Map::below(P));
    unsigned red[kN];
    int widx[kN];
    reduce_words<P, 0>(part, red, widx);
    const int woff = L > 1 ? lane_woff[P] : 0;
    if constexpr (gs == 1) {
#pragma unroll
      for (int k = 0; k < kN; ++k) store(t, widx[k] | woff, red[k], true);
    } else {
      const int rank = lane_rank[P];
#pragma unroll
      for (int j = 0; j < kN; j += gs) {
        unsigned word = red[j];
        int w = widx[j];
#pragma unroll
        for (int q = 1; q < gs; ++q) {
          if (j + q < kN) {
            word = rank == q ? red[j + q] : word;
            w = rank == q ? widx[j + q] : w;
          }
        }
        store(t, w | woff, word, j + rank < kN);
      }
    }
  }

  // one radix-2 stage t at phase P with the stage's symbols y
  template <int P, typename Store>
  __device__ __forceinline__ void stage(const Acc (&y)[R], int t, Store& store) {
    Acc yy[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (L > 1) {
        yy[r] = ((lane_flip[P] >> (R - 1 - r)) & 1) ? -y[r] : y[r];
      } else {
        yy[r] = y[r];
      }
    }
    Acc row[NF];  // row f: + y_r where bit R-1-r of f is 1, - y_r where 0, in r order
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      Acc acc = ((f >> (R - 1)) & 1) ? yy[0] : -yy[0];
#pragma unroll
      for (int r = 1; r < R; ++r) acc = acc + (((f >> (R - 1 - r)) & 1) ? yy[r] : -yy[r]);
      row[f] = acc;
    }
    unsigned part[W];
#pragma unroll
    for (int w = 0; w < W; ++w) part[w] = 0u;
    if constexpr (P < kLogS) {
      pairs<P, 0>(row, part);
    } else {
      cross<P, 0>(row, part, ((sub >> (P - kLogS)) & 1) != 0);
    }
    emit<P>(part, t, store);
  }

  // subtract the minimum over the block's N states
  __device__ __forceinline__ void normalize() {
    Acc mn = pm[0];
#pragma unroll
    for (int i = 1; i < S; ++i) mn = pm[i] < mn ? pm[i] : mn;
#pragma unroll
    for (int k = 0; k < kLogL; ++k) {
      const Acc o = __shfl_xor_sync(lanes, mn, gw << k);
      mn = o < mn ? o : mn;
    }
#pragma unroll
    for (int i = 0; i < S; ++i) pm[i] -= mn;
  }

  // step J of the block of v stages from t0 (the last block's steps are
  // guarded by t < T); norm_left counts steps to the next min-subtract
  template <int J, typename Store>
  __device__ __forceinline__ void block_steps(const Acc (&yc)[v][R], int t0, int T, int norm_every,
                                              int& norm_left, Store& store) {
    if constexpr (J < v / kStagesPerStep) {
      constexpr int p0 = J * kStagesPerStep;
      const int t = t0 + p0;
      if (t + kStagesPerStep <= T) {
        stage<p0>(yc[p0], t, store);
        if constexpr (kStagesPerStep == 2) stage<p0 + 1>(yc[p0 + 1], t + 1, store);
        if constexpr (kNarrow) {
          if (--norm_left == 0) {
            normalize();
            norm_left = norm_every;
          }
        }
      } else if constexpr (kStagesPerStep == 2) {
        if (t < T) {  // trailing radix-2 stage (odd T); narrow modes normalize unconditionally
          stage<p0>(yc[p0], t, store);
          if constexpr (kNarrow) normalize();
        }
      }
      block_steps<J + 1>(yc, t0, T, norm_every, norm_left, store);
    }
  }

  // after T stages slot q holds state rot(q, T mod v): ph = T mod v
  template <int P, typename PmOut>
  __device__ __forceinline__ void out(int ph, PmOut& pm_out) {
    if constexpr (P < v) {
      if (ph == P) {
        const int lane_s = Code::rot(sub << kLogS, P);
#pragma unroll
        for (int i = 0; i < S; ++i) pm_out(Code::rot(i, P) | lane_s, pm[i]);
      }
      out<P + 1>(ph, pm_out);
    }
  }
};

// The forward ACS of the warp body over T stages for one lane: rank `sub`
// (0 <= sub < L) inside its parallel block, `gw` blocks per warp (the
// shuffle distance between the lanes of a block), `lanes` the lanes of
// the warp that exist. Every lane of the warp calls it, whether its block
// exists or not (the shuffles need them all).
//   load_block(t0, y): y[p][r] = stage t0 + p's symbol r, widened to Acc,
//     clipped in the narrow modes, 0 past T or for a block that does not
//     exist;
//   store(t, w, word, ok): survivor word w of stage t where ok, once per
//     word over the lanes of the block (it must also skip blocks that do
//     not exist);
//   pm_out(s, m): the final path metric of state s, once per state.
// norm_every is read only when kNarrow. The stage loop runs blocks of v
// stages, so that the phase is a compile-time constant, and fetches the
// next block's symbols into registers while the current block computes.
template <class Code, int kS, int kStagesPerStep, bool kNarrow, typename Acc,
          typename LoadBlock, typename Store, typename PmOut>
__device__ __forceinline__ void forward_acs_warp(int T, int norm_every, int sub, int gw,
                                                 unsigned lanes, LoadBlock load_block,
                                                 Store store, PmOut pm_out) {
  using Body = WarpAcs<Code, kS, kStagesPerStep, kNarrow, Acc>;
  constexpr int v = Code::v, R = Code::R;
  Body body(sub, gw, lanes);
  Acc yc[v][R];
  Acc yn[v][R] = {};
  load_block(0, yc);
  // steps left until the next min-subtract: it falls after step r exactly
  // when r % norm_every == norm_every - 1, with no division in the loop
  int norm_left = norm_every;
  const int n_blocks = (T + v - 1) / v;
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int t0 = blk * v;
    if (blk + 1 < n_blocks) load_block(t0 + v, yn);  // the next block's symbols, now
    body.template block_steps<0>(yc, t0, T, norm_every, norm_left, store);
#pragma unroll
    for (int p = 0; p < v; ++p) {
#pragma unroll
      for (int r = 0; r < R; ++r) yc[p][r] = yn[p][r];
    }
  }
  body.template out<0>(T % v, pm_out);
}

// ---------------------------------------------------------------------------
// The matrix warp body: k-stage (min,+) steps on the warp body's slot map
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int gcd_of(int a, int b) { return b == 0 ? a : gcd_of(b, a % b); }

// One lane of the matrix warp body (see the header): the warp body's
// registers, slot map, survivor-word assembly and radix-2 stage (the T mod
// k trailing stages), plus the k-stage step. Bit i of a candidate index e
// stands for slot bit pos(P, i) = (P + i) mod v; a candidate e of a target
// slot with lane bits c_lane is its predecessor j = e ^ c_lane, so every
// register index, label and emitted bit below is a compile-time constant
// and only the orientation of the lane-bit rounds is not.
template <class Code, int kS, int kK>
struct WarpMatrix : WarpAcs<Code, kS, 1, false, int> {
  using Base = WarpAcs<Code, kS, 1, false, int>;
  using Base::gw;
  using Base::lanes;
  using Base::pm;
  using Base::sub;
  static constexpr int v = Code::v, R = Code::R, W = Code::W, U = Code::N >> kK;
  static constexpr int S = kS, L = Base::L, kLogS = Base::kLogS;
  static constexpr int kNk = 1 << kK, kNb = kK * R, kNf = 1 << (kNb - 1);
  static constexpr int kBlock = v / gcd_of(v, kK) * kK;  // lcm(v, k) stages
  // stages fetched at a time, one fetch ahead: a block of v stages where k
  // divides v, as the warp body does, else one step (whose own work then
  // covers the load's latency)
  static constexpr int kLoad = kBlock == v ? v : kK;
  static_assert(Code::matrix_k_ok(kK), "k <= min(v, 4) and kR <= 8");

  // this lane's share of the combined labels of the step at phase p: the
  // label of its lane-only slot sub << log2 S with its own predecessor
  // (j = c), applied by negating the window's symbols it names
  int lane_mflip[v];

  __device__ __forceinline__ WarpMatrix(int sub_, int gw_, unsigned lanes_)
      : Base(sub_, gw_, lanes_) {
    if constexpr (L > 1) {
#pragma unroll
      for (int p = 0; p < v; ++p) {
        const int n = Code::rot(sub_ << kLogS, p + kK);
        const int c = n >> (v - kK);
        lane_mflip[p] = Code::mlabel(kK, c, c, n & (U - 1));
      }
    }
  }

  __host__ __device__ static constexpr int pos(int P, int i) { return (P + i) % v; }
  __host__ __device__ static constexpr bool lane_bit(int P, int i) { return pos(P, i) >= kLogS; }
  // register bits that the step at phase P spans
  __host__ __device__ static constexpr int step_regs(int P) {
    int m = 0;
    for (int i = 0; i < kK; ++i) m |= lane_bit(P, i) ? 0 : 1 << pos(P, i);
    return m;
  }
  // groups of 2^k slots per lane: the register patterns outside the step
  __host__ __device__ static constexpr int n_groups(int P) {
    return kS >> popcount_of(static_cast<unsigned>(step_regs(P)));
  }
  // register index of candidate (or target) e of group g: g's bits in the
  // register bits outside the step, e's register-position bits in theirs
  __host__ __device__ static constexpr int reg_of(int P, int g, int e) {
    int r = 0, b = 0;
    for (int bit = 0; bit < kLogS; ++bit) {
      if (!((step_regs(P) >> bit) & 1)) r |= ((g >> b++) & 1) << bit;
    }
    for (int i = 0; i < kK; ++i) {
      if (!lane_bit(P, i)) r |= ((e >> i) & 1) << pos(P, i);
    }
    return r;
  }
  // the sub bits that e's lane-position bits select (the shuffle distance)
  __host__ __device__ static constexpr int dsub_of(int P, int e) {
    int d = 0;
    for (int i = 0; i < kK; ++i) {
      if (lane_bit(P, i)) d |= ((e >> i) & 1) << (pos(P, i) - kLogS);
    }
    return d;
  }
  // target c of register-only slot I, in candidate-index bits
  __host__ __device__ static constexpr int c_of(int P, int I) {
    return Code::rot(I, P + kK) >> (v - kK);
  }
  // combined label of register-only target slot I and candidate e
  __host__ __device__ static constexpr int mlab(int P, int I, int e) {
    const int n = Code::rot(I, P + kK);
    return Code::mlabel(kK, n >> (v - kK), e, n & (U - 1));
  }

  // the predecessors' metrics of group Gi, by candidate index: in this
  // lane's registers or, across a lane bit, one shuffle each
  template <int P, int Gi, int E>
  __device__ __forceinline__ void gather(int (&m)[kNk]) {
    if constexpr (E < kNk) {
      constexpr int I = reg_of(P, Gi, E);
      constexpr int d = dsub_of(P, E);
      if constexpr (d == 0) {
        m[E] = pm[I];
      } else {
        m[E] = __shfl_xor_sync(lanes, pm[I], gw * d);
      }
      gather<P, Gi, E + 1>(m);
    }
  }

  // candidate E of target slot I: predecessor metric + or - one folded row
  template <int P, int I, int E>
  __device__ __forceinline__ void cands(const int (&row)[kNf], const int (&m)[kNk],
                                        int (&c)[kNk]) {
    if constexpr (E < kNk) {
      c[E] = m[E] + bm_of<mlab(P, I, E), kNf>(row);
      cands<P, I, E + 1>(row, m, c);
    }
  }

  // round Rd of target slot I's suffix-min tournament over nk >> Rd
  // candidates: pairs (2h, 2h+1) in candidate index, the even predecessor
  // first (swapped where this lane's c has bit Rd set: a lane-bit round),
  // strict < on the odd one. Its decisions are the radix-2 plane of stage
  // t + Rd; the slot emits the one of h = c >> (Rd + 1), the state
  // rot(I, P + Rd + 1) that the butterfly's slot would hold.
  template <int P, int I, int Rd>
  __device__ __forceinline__ void rounds(int (&c)[kNk], unsigned (&part)[kK][W]) {
    if constexpr (Rd < kK) {
      constexpr int hstar = c_of(P, I) >> (Rd + 1);
      constexpr int s = Code::rot(I, P + Rd + 1);
      bool x = false;
      if constexpr (lane_bit(P, Rd)) x = ((sub >> (pos(P, Rd) - kLogS)) & 1) != 0;
#pragma unroll
      for (int h = 0; h < (kNk >> (Rd + 1)); ++h) {
        const int pe = x ? c[2 * h + 1] : c[2 * h];
        const int po = x ? c[2 * h] : c[2 * h + 1];
        bool d;
        c[h] = acs_select(pe, po, d);
        if (h == hstar && d) part[Rd][s >> 5] |= 1u << (s & 31);
      }
      rounds<P, I, Rd + 1>(c, part);
    }
  }

  // this lane's targets of group Gi: the candidate indices with no lane bit
  template <int P, int Gi, int Et>
  __device__ __forceinline__ void targets(const int (&row)[kNf], const int (&m)[kNk],
                                          int (&out)[kNk], unsigned (&part)[kK][W]) {
    if constexpr (Et < kNk) {
      if constexpr (dsub_of(P, Et) == 0) {
        constexpr int I = reg_of(P, Gi, Et);
        int c[kNk];
        cands<P, I, 0>(row, m, c);
        rounds<P, I, 0>(c, part);
        out[Et] = c[0];
      }
      targets<P, Gi, Et + 1>(row, m, out, part);
    }
  }

  template <int P, int Gi, int Et>
  __device__ __forceinline__ void write_back(const int (&out)[kNk]) {
    if constexpr (Et < kNk) {
      if constexpr (dsub_of(P, Et) == 0) pm[reg_of(P, Gi, Et)] = out[Et];
      write_back<P, Gi, Et + 1>(out);
    }
  }

  template <int P, int Gi>
  __device__ __forceinline__ void groups(const int (&row)[kNf], unsigned (&part)[kK][W]) {
    if constexpr (Gi < n_groups(P)) {
      int m[kNk];
      gather<P, Gi, 0>(m);
      int out[kNk];
      targets<P, Gi, 0>(row, m, out, part);
      write_back<P, Gi, 0>(out);  // after the group's gathers: the partner lanes read these
      groups<P, Gi + 1>(row, part);
    }
  }

  template <int P, int Rd, typename Store>
  __device__ __forceinline__ void emits(const unsigned (&part)[kK][W], int t, Store& store) {
    if constexpr (Rd < kK) {
      this->template emit<pos(P, Rd)>(part[Rd], t + Rd, store);
      emits<P, Rd + 1>(part, t, store);
    }
  }

  // the k-stage step at phase P from stage t, its symbols y[Off ...]
  template <int P, int Off, typename Store>
  __device__ __forceinline__ void step(const int (&y)[kLoad][R], int t, Store& store) {
    int yy[kNb];  // the window, stage-major, with this lane's signs
#pragma unroll
    for (int q = 0; q < kNb; ++q) {
      const int x = y[Off + q / R][q % R];
      if constexpr (L > 1) {
        yy[q] = ((lane_mflip[P] >> (kNb - 1 - q)) & 1) ? -x : x;
      } else {
        yy[q] = x;
      }
    }
    // row f: + y_q where bit kR-1-q of f is 1, - y_q where 0, in q order
    // (folded_matrix_codeword_signs); the rows no label of this phase
    // names are dead code
    int row[kNf];
#pragma unroll
    for (int f = 0; f < kNf; ++f) {
      int acc = ((f >> (kNb - 1)) & 1) ? yy[0] : -yy[0];
#pragma unroll
      for (int q = 1; q < kNb; ++q) acc += ((f >> (kNb - 1 - q)) & 1) ? yy[q] : -yy[q];
      row[f] = acc;
    }
    unsigned part[kK][W];
#pragma unroll
    for (int i = 0; i < kK; ++i) {
#pragma unroll
      for (int w = 0; w < W; ++w) part[i][w] = 0u;
    }
    groups<P, 0>(row, part);
    emits<P, 0>(part, t, store);
  }

  // step J of the block of lcm(v, k) stages from t0, while a whole step
  // remains; the first step of each fetch of kLoad stages fetches the next
  template <int J, typename LoadStep, typename Store>
  __device__ __forceinline__ void block_steps(int (&yc)[kLoad][R], int (&yn)[kLoad][R], int t0,
                                              int T, int norm_every, int& norm_left,
                                              LoadStep& load, Store& store) {
    if constexpr (J < kBlock / kK) {
      constexpr int off = (J * kK) % kLoad;
      const int t = t0 + J * kK;
      if constexpr (off == 0) load(t + kLoad, yn);
      if (t + kK <= T) {
        step<pos(J * kK, 0), off>(yc, t, store);
        if (norm_every && --norm_left == 0) {
          this->normalize();
          norm_left = norm_every;
        }
      }
      if constexpr (off + kK == kLoad) {
#pragma unroll
        for (int i = 0; i < kLoad; ++i) {
#pragma unroll
          for (int r = 0; r < R; ++r) yc[i][r] = yn[i][r];
        }
      }
      block_steps<J + 1>(yc, yn, t0, T, norm_every, norm_left, load, store);
    }
  }

  // a trailing radix-2 stage t at the runtime phase ph = t mod v
  template <int P, typename Store>
  __device__ __forceinline__ void tail(int ph, const int (&y)[R], int t, Store& store) {
    if constexpr (P < v) {
      if (ph == P) this->template stage<P>(y, t, store);
      tail<P + 1>(ph, y, t, store);
    }
  }
};

// The matrix warp body's forward ACS over T stages for one lane: T / k
// k-stage (min,+) steps, then T mod k radix-2 stages, min-subtracted
// unconditionally in the narrow modes. The contract of forward_acs_warp,
// except that load_step(t0, y) fills y[i][r] for the Body::kLoad stages
// t0 + i (0 past T or for a block that does not exist), and that the
// narrow modes are norm_every > 0 at run time (their clip is the
// loader's): one instantiation per (code, k) serves f32, i16 and i8, which
// halves the build of these fully unrolled bodies. Integer symbols and
// int32 metrics only: the callers lower float to the butterfly.
template <class Code, int kS, int kK, typename LoadStep, typename Store, typename PmOut>
__device__ __forceinline__ void forward_acs_matrix_warp(int T, int norm_every, int sub, int gw,
                                                        unsigned lanes, LoadStep load_step,
                                                        Store store, PmOut pm_out) {
  using Body = WarpMatrix<Code, kS, kK>;
  constexpr int v = Code::v, R = Code::R;
  Body body(sub, gw, lanes);
  constexpr int kLoad = Body::kLoad;
  int yc[kLoad][R];
  int yn[kLoad][R];
  load_step(0, yc);
  // steps left until the next min-subtract: it falls after step r exactly
  // when r % norm_every == norm_every - 1
  int norm_left = norm_every;
  const int n_blocks = (T + Body::kBlock - 1) / Body::kBlock;
  for (int blk = 0; blk < n_blocks; ++blk) {
    body.template block_steps<0>(yc, yn, blk * Body::kBlock, T, norm_every, norm_left,
                                 load_step, store);
  }
  int t = T - T % kK;
  if (t < T) load_step(t, yc);  // the trailing stages' symbols
#pragma unroll 1
  for (; t < T; ++t) {
    body.template tail<0>(t % v, yc[0], t, store);
    if (norm_every) body.normalize();
#pragma unroll
    for (int i = 0; i + 1 < kK; ++i) {
#pragma unroll
      for (int r = 0; r < R; ++r) yc[i][r] = yc[i + 1][r];
    }
  }
  body.template out<0>(T % v, pm_out);
}

}  // namespace pbvd
