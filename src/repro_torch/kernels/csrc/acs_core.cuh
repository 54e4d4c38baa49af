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
  const int N = 1 << log2n;
  const int G = blockDim.x >> log2n;
  const int tid = threadIdx.x;
  const int g = tid >> log2n;
  const int s = tid & (N - 1);
  const int lane = tid & 31;
  const int b = blockIdx.x * G + g;
  const bool valid = b < B;
  const int pe = g * N + 2 * (s & ((N >> 1) - 1));  // even predecessor slot
  const int lab_even = labels[2 * s];
  const int lab_odd = labels[2 * s + 1];
  const bool stores = N >= 32 ? lane == 0 : s == 0;
  const unsigned slice = N >= 32 ? 0xffffffffu : ((1u << N) - 1u);

  Acc* pm_cur = smem;
  Acc* pm_nxt = smem + G * N;
  Acc* red = smem + 2 * G * N;
  pm_cur[tid] = Acc(0);

  // one radix-2 stage: compare-select, store the survivor word, optionally
  // normalize, write the new metric, barrier
  auto stage = [&](int t, const Acc (&yt)[kMaxR], bool normalize) {
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
  };

  if (!kNarrow) qmax = 0;
  const int n_steps = T / kStagesPerStep;
  Acc yc[kStagesPerStep][kMaxR] = {};
  Acc yn[kStagesPerStep][kMaxR] = {};
  if (valid && n_steps > 0) {
#pragma unroll
    for (int i = 0; i < kStagesPerStep; ++i) load_stage(y, i, R, B, b, qmax, yc[i]);
  }
  __syncthreads();

  // steps left until the next min-subtract: it falls after step r exactly
  // when r % norm_every == norm_every - 1, with no division in the loop
  int norm_left = norm_every;
  for (int r = 0; r < n_steps; ++r) {
    if (valid && r + 1 < n_steps) {  // fetch the next step's symbols now
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
      stage(r * kStagesPerStep + i, yc[i], normalize && i == kStagesPerStep - 1);
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
    if (valid) load_stage(y, T - 1, R, B, b, qmax, yl);
    stage(T - 1, yl, kNarrow);
  }
  return pm_cur[tid];
}

}  // namespace pbvd
