// K1: forward add-compare-select of the parallel block-based Viterbi decoder.
//
// Replaces the TPU kernel repro/kernels/acs.py::_acs_kernel (radix-2 branch,
// driven by acs_forward_pallas, with radix2_stage, folded_bm_rows,
// butterfly_bm_row and _pack_plane). It computes the same function:
// for every parallel block b and stage t, the 2^(R-1) symmetry-folded branch
// metrics, the alpha/gamma/beta/theta butterfly add-compare-select over the N
// states, the decisions packed into ceil(N/32) survivor words per stage
// (bit state%32 of word state/32 set iff the odd predecessor won), and the
// final path metrics.
//
// Design. The TPU kernel carries PM in VMEM scratch across a sequential grid
// of stage chunks; CUDA blocks cannot carry state between grid steps, so each
// CTA runs the whole stage loop of its parallel blocks itself. One thread per
// target state; G = max(1, 128/N) parallel blocks per CTA. PM ping-pongs in
// shared memory with one __syncthreads() per stage. Each warp's 32 decisions
// are exactly one survivor word (bit = lane), packed with __ballot_sync and
// stored by one lane; for N < 32 a warp holds 32/N parallel blocks and each
// block's word is its N-bit slice of the ballot. No stage padding: the loop
// runs the true T stages, so the final PM is the true stage-T metric (the
// argmin start follows the reference's "ref" semantics).
//
// Arithmetic matches the reference bit for bit: symbols are read in their
// wire dtype and widened to the accumulator (int32, or float32 for float
// symbols) before any negation; each folded row is +-y_0 +- y_1 ... added in
// r order with no multiply (so no FMA contraction can change a float sum);
// each butterfly metric is +- one folded row; the tie-break is
// m_odd < m_even, so ties keep the even predecessor. Build without
// --use_fast_math.
//
// Bound on the H100. Per stage and parallel block the kernel does about 4N
// integer operations (two adds, a compare and a select per state) and moves
// R symbol bytes in and 4*W survivor bytes out: at N = 64, W = 2 that is
// ~256 operations per 10 bytes, so the integer issue rate bounds it, not
// HBM. The design spends one thread per state so every ACS operation runs in
// parallel lanes, keeps PM in shared memory, prefetches the next stage's
// symbols into registers while the current stage computes, and writes each
// survivor word with one store from the ballot instead of a reduction.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxR = 4;

// Branch metric of R-bit label c, as the reference builds it: folded row
// k = c (MSB 0) or its complement, chained in r order, then the fold sign.
template <typename Acc>
__device__ __forceinline__ Acc label_metric(const Acc (&y)[kMaxR], int c, int R) {
  const int full = (1 << R) - 1;
  const bool neg = c >= (1 << (R - 1));
  const int k = neg ? (c ^ full) : c;
  Acc acc = ((k >> (R - 1)) & 1) ? y[0] : -y[0];
  for (int r = 1; r < R; ++r) {
    const Acc term = ((k >> (R - 1 - r)) & 1) ? y[r] : -y[r];
    acc = acc + term;
  }
  return neg ? -acc : acc;
}

template <typename Sym, typename Acc>
__global__ void acs_kernel(const Sym* __restrict__ y, const int* __restrict__ labels,
                           int T, int R, int B, int log2n, int* __restrict__ sp,
                           Acc* __restrict__ pm_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int N = 1 << log2n;
  const int G = blockDim.x >> log2n;  // parallel blocks in this CTA
  const int W = (N + 31) >> 5;
  const int tid = threadIdx.x;
  const int g = tid >> log2n;
  const int s = tid & (N - 1);           // target state of this thread
  const int lane = tid & 31;
  const int b = blockIdx.x * G + g;      // parallel block (lane of the batch)
  const bool valid = b < B;
  const int pe = g * N + 2 * (s & ((N >> 1) - 1));  // even predecessor slot
  const int lab_even = labels[2 * s];
  const int lab_odd = labels[2 * s + 1];

  Acc* pm_cur = reinterpret_cast<Acc*>(smem);
  Acc* pm_nxt = pm_cur + G * N;
  pm_cur[tid] = Acc(0);

  Acc yc[kMaxR] = {};
  Acc yn[kMaxR] = {};
  if (valid) {
    for (int r = 0; r < R; ++r) yc[r] = static_cast<Acc>(y[static_cast<size_t>(r) * B + b]);
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (valid && t + 1 < T) {  // prefetch the next stage's symbols
      const size_t base = static_cast<size_t>(t + 1) * R * B + b;
      for (int r = 0; r < R; ++r) yn[r] = static_cast<Acc>(y[base + static_cast<size_t>(r) * B]);
    }
    const Acc m_even = pm_cur[pe] + label_metric(yc, lab_even, R);
    const Acc m_odd = pm_cur[pe + 1] + label_metric(yc, lab_odd, R);
    const bool dec = m_odd < m_even;
    pm_nxt[tid] = dec ? m_odd : m_even;
    const unsigned word = __ballot_sync(0xffffffffu, dec);
    if (N >= 32) {
      if (lane == 0 && valid) sp[(static_cast<size_t>(t) * W + (s >> 5)) * B + b] = static_cast<int>(word);
    } else if (s == 0 && valid) {
      sp[static_cast<size_t>(t) * B + b] = static_cast<int>((word >> lane) & ((1u << N) - 1u));
    }
    __syncthreads();
    Acc* tmp = pm_cur;
    pm_cur = pm_nxt;
    pm_nxt = tmp;
    for (int r = 0; r < kMaxR; ++r) yc[r] = yn[r];
  }
  if (valid) pm_out[static_cast<size_t>(s) * B + b] = pm_cur[tid];
}

template <typename Sym, typename Acc>
int launch(const void* y, const int* labels, int T, int R, int B, int log2n, int* sp,
           void* pm, cudaStream_t stream) {
  const int N = 1 << log2n;
  const int G = N >= 128 ? 1 : 128 / N;
  const int threads = G * N;
  const int grid = (B + G - 1) / G;
  const size_t smem = 2 * static_cast<size_t>(threads) * sizeof(Acc);
  acs_kernel<Sym, Acc><<<grid, threads, smem, stream>>>(
      static_cast<const Sym*>(y), labels, T, R, B, log2n, sp, static_cast<Acc*>(pm));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y: (T, R, B) symbols, dtype 0 = int8, 1 = int16, 2 = int32, 3 = float32.
// labels: (N, 2) int32 even/odd predecessor labels of each target state.
// sp: (T, ceil(N/32), B) int32 out. pm: (N, B) out, int32 (float32 for
// float symbols). Requires 1 <= log2n <= 10, 1 <= R <= 4, T >= 1, B >= 1.
// Returns cudaGetLastError() after the launch; 1000 for a bad argument.
extern "C" int pbvd_acs_forward(const void* y, int dtype, int T, int R, int B, int log2n,
                                const void* labels, void* sp, void* pm, void* stream) {
  if (log2n < 1 || log2n > 10 || R < 1 || R > kMaxR || T < 1 || B < 1) return 1000;
  const int* lab = static_cast<const int*>(labels);
  int* sp_i = static_cast<int*>(sp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<int8_t, int>(y, lab, T, R, B, log2n, sp_i, pm, st);
    case 1: return launch<int16_t, int>(y, lab, T, R, B, log2n, sp_i, pm, st);
    case 2: return launch<int32_t, int>(y, lab, T, R, B, log2n, sp_i, pm, st);
    case 3: return launch<float, float>(y, lab, T, R, B, log2n, sp_i, pm, st);
    default: return 1000;
  }
}
