// The forward add-compare-select loop of the parallel block-based Viterbi
// decoder, shared by K1 (acs.cu, survivor words to global memory) and the
// fused kernel (fused.cu, survivor words to shared memory). One copy of the
// stage arithmetic keeps the two kernels bit-exact to each other and to the
// plain version (repro_torch/kernels/ref.py::acs_forward_ref).
//
// Layout. One thread per target state s; G = blockDim.x / N parallel blocks
// per CTA, block g on threads [g*N, (g+1)*N). Path metrics ping-pong in
// shared memory, one __syncthreads() per stage. Each warp's 32 decisions are
// one survivor word (bit = lane = s % 32), packed with __ballot_sync; for
// N < 32 a warp holds 32/N blocks and each block's word is its N-bit slice.
//
// Arithmetic, as the reference's: symbols are read in their wire dtype,
// widened to the accumulator (int32, or float32 for float symbols) and, in
// the narrow metric modes, clipped to +-qmax after widening. Each folded row
// is +-y_0 +- y_1 ... added in r order with no multiply (so no FMA
// contraction can change a float sum); each branch metric is +- one folded
// row; the tie-break is m_odd < m_even, so ties keep the even predecessor.
// Build without --use_fast_math.
//
// Narrow modes (i16/i8, kNarrow) keep int32 registers, as the TPU kernels
// do: the saturation budget keeps every value inside the narrow dtype, so
// int32 arithmetic gives the narrow dtype's values. Every norm_every-th ACS
// step (counted globally: step % norm_every == norm_every - 1) subtracts the
// minimum over the block's N states: warp shuffles, then shared memory for
// N > 32. kNarrow is a template parameter so that the f32 loop carries no
// clip, countdown or reduction.
//
// Radix 4 (kStagesPerStep = 2). The TPU kernel runs the staged radix-4 step
// (radix4_stage_pair without combine): the stage-t tournament round shared
// between the two target groups with the same stage-t input bit, then
// + the stage-(t+1) metric. That op sequence is two radix-2 stages, so this
// kernel takes design (a): each loop step runs two radix-2 sub-stages, with
// one symbol fetch for both stages, one normalization round (on the step
// count) and two survivor-word stores. It is bit-exact in float as well,
// keeps the one-thread-per-state layout of radix 2 and needs no new tables.
// Design (b), one thread per target running its quad's 4-way tournament
// from radix4_acs_tables, would trade the second barrier for recomputing
// the shared intermediates; that is a later measurement. At odd T a
// trailing radix-2 stage follows, min-subtracted unconditionally in narrow
// modes, as in the reference.
//
// Matrix (forward_acs_matrix<k>): the k-stage (min,+) step of the TPU's
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
// The T mod k trailing stages run the radix-2 stage body, min-subtracted
// unconditionally in the narrow modes. Integer symbols only: the callers
// lower float to the radix-2 butterfly, as the reference does.

#pragma once

#include <cstddef>
#include <cstdint>
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

// The forward ACS of this thread's state over T stages. store(t, w, word)
// is called by one thread per (valid block, stage, survivor word). Returns
// this thread's final path metric. Ends with a __syncthreads(), so what the
// stores wrote to shared memory is visible to the whole CTA. norm_every and
// qmax are read only when kNarrow.
template <int kStagesPerStep, bool kNarrow, typename Sym, typename Acc, typename Store>
__device__ __forceinline__ Acc forward_acs(const Sym* __restrict__ y,
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
// forward_acs: store(t, w, word) per (valid block, stage, word), returns
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

  int norm_left = norm_every;  // countdown to the next min-subtract, as forward_acs
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

}  // namespace pbvd
