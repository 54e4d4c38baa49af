// K1: forward add-compare-select of the parallel block-based Viterbi decoder.
//
// Replaces the TPU kernel repro/kernels/acs.py::_acs_kernel (driven by
// acs_forward_pallas): its radix-2 branch (radix2_stage, folded_bm_rows,
// butterfly_bm_row, _pack_plane), its radix-4 branch (radix4_stage_pair,
// staged) and its narrow metric modes (norm_every min-subtract, clip to
// metric_mode_qmax). It computes the same function: for every parallel
// block b and stage t, the alpha/gamma/beta/theta butterfly
// add-compare-select over the N states with symmetry-folded branch metrics,
// the decisions packed into ceil(N/32) survivor words per stage (bit
// state%32 of word state/32 set iff the odd predecessor won), and the final
// path metrics.
//
// Design. The TPU kernel carries PM in VMEM scratch across a sequential grid
// of stage chunks; CUDA blocks cannot carry state between grid steps, so each
// CTA runs the whole stage loop of its parallel blocks itself. The loop,
// the stage arithmetic, the narrow modes and the radix-4 step live in
// acs_core.cuh, shared with the fused kernel; this file stores each
// survivor word to global memory and the final metrics after the loop. No
// stage padding: the loop runs the true T stages, so the final PM is the
// true stage-T metric (the argmin start follows the reference's "ref"
// semantics), and odd T at radix 4 ends with the reference's trailing
// radix-2 stage.
//
// Bound on the H100. Per stage and parallel block the kernel does about 4N
// integer operations (two adds, a compare and a select per state) and moves
// R symbol bytes in and 4*W survivor bytes out: at N = 64, W = 2 that is
// ~256 operations per 10 bytes, so the integer issue rate bounds it, not
// HBM. The design spends one thread per state so every ACS operation runs in
// parallel lanes, keeps PM in shared memory, fetches the next step's
// symbols into registers while the current step computes, and writes each
// survivor word with one store from the ballot instead of a reduction.
// Radix 4 does the same work (same bound); it halves the symbol fetch and
// normalization rounds, not the barriers.
//
// K1-matrix (pbvd_acs_forward_matrix) replaces the TPU kernel
// repro/kernels/acs.py::_acs_matrix_kernel (acs_forward_pallas with
// impl="matrix"): T // k k-stage (min,+) steps, each emitting its k standard
// radix-2 survivor planes, then T mod k radix-2 stages (the reference's
// "ref" semantics; the port pads no stages). The TPU kernel assembles the
// k-stage metrics with one MXU product E @ folded; here each thread gathers
// its 2^k metrics from the 2^(kR-1) folded rows in shared memory with the
// table's index and sign, the form of the TPU's fused body
// _acs_phase_mat_dbuf (acs_core.cuh::forward_acs_matrix). Bound: per k-step
// and target 2^k adds and 2^k - 1 compare-selects, plus kR adds per folded
// row, so again the integer issue rate, not HBM; it trades K1's one barrier
// per stage for two per k stages, and its ballot for a shared-memory or.

#include "acs_core.cuh"

namespace {

using pbvd::forward_acs;
using pbvd::forward_acs_matrix;
using pbvd::forward_smem_slots;
using pbvd::matrix_smem_slots;

template <int kStagesPerStep, bool kNarrow, typename Sym, typename Acc>
__global__ void acs_kernel(const Sym* __restrict__ y, const int* __restrict__ labels, int T,
                           int R, int B, int log2n, int norm_every, int qmax,
                           int* __restrict__ sp, Acc* __restrict__ pm_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = ((1 << log2n) + 31) >> 5;
  const int G = blockDim.x >> log2n;
  const int b = blockIdx.x * G + (threadIdx.x >> log2n);
  auto store = [&](int t, int w, unsigned word) {
    sp[(static_cast<size_t>(t) * W + w) * B + b] = static_cast<int>(word);
  };
  const Acc pm = forward_acs<kStagesPerStep, kNarrow, Sym>(
      y, labels, T, R, B, log2n, norm_every, qmax, reinterpret_cast<Acc*>(smem_raw), store);
  if (b < B) {
    const int s = threadIdx.x & ((1 << log2n) - 1);
    pm_out[static_cast<size_t>(s) * B + b] = pm;
  }
}

template <int kStagesPerStep, bool kNarrow, typename Sym, typename Acc>
int launch(const void* y, const int* labels, int T, int R, int B, int log2n, int norm_every,
           int qmax, int* sp, void* pm, cudaStream_t stream) {
  const int N = 1 << log2n;
  const int G = N >= 128 ? 1 : 128 / N;
  const int threads = G * N;
  const int grid = (B + G - 1) / G;
  const size_t smem = static_cast<size_t>(forward_smem_slots(G, log2n)) * sizeof(Acc);
  acs_kernel<kStagesPerStep, kNarrow, Sym, Acc><<<grid, threads, smem, stream>>>(
      static_cast<const Sym*>(y), labels, T, R, B, log2n, norm_every, qmax, sp,
      static_cast<Acc*>(pm));
  return static_cast<int>(cudaGetLastError());
}

template <int kStagesPerStep, bool kNarrow>
int dispatch(const void* y, int dtype, const int* labels, int T, int R, int B, int log2n,
             int norm_every, int qmax, int* sp, void* pm, cudaStream_t st) {
  switch (dtype) {
    case 0: return launch<kStagesPerStep, kNarrow, int8_t, int>(y, labels, T, R, B, log2n, norm_every, qmax, sp, pm, st);
    case 1: return launch<kStagesPerStep, kNarrow, int16_t, int>(y, labels, T, R, B, log2n, norm_every, qmax, sp, pm, st);
    case 2: return launch<kStagesPerStep, kNarrow, int32_t, int>(y, labels, T, R, B, log2n, norm_every, qmax, sp, pm, st);
    case 3: return kNarrow ? 1000 : launch<kStagesPerStep, false, float, float>(y, labels, T, R, B, log2n, norm_every, qmax, sp, pm, st);
    default: return 1000;
  }
}

template <int kK, bool kNarrow, typename Sym>
__global__ void acs_matrix_kernel(const Sym* __restrict__ y, const int* __restrict__ labels,
                                  const int* __restrict__ mtab, int T, int R, int B, int log2n,
                                  int norm_every, int qmax, int* __restrict__ sp,
                                  int* __restrict__ pm_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = ((1 << log2n) + 31) >> 5;
  const int G = blockDim.x >> log2n;
  const int b = blockIdx.x * G + (threadIdx.x >> log2n);
  auto store = [&](int t, int w, unsigned word) {
    sp[(static_cast<size_t>(t) * W + w) * B + b] = static_cast<int>(word);
  };
  const int pm = forward_acs_matrix<kK, kNarrow, Sym>(
      y, labels, mtab, T, R, B, log2n, norm_every, qmax, reinterpret_cast<int*>(smem_raw), store);
  if (b < B) {
    const int s = threadIdx.x & ((1 << log2n) - 1);
    pm_out[static_cast<size_t>(s) * B + b] = pm;
  }
}

template <int kK, bool kNarrow, typename Sym>
int launch_matrix(const void* y, const int* labels, const int* mtab, int T, int R, int B,
                  int log2n, int norm_every, int qmax, int* sp, int* pm, cudaStream_t stream) {
  const int N = 1 << log2n;
  const int G = N >= 128 ? 1 : 128 / N;
  const int grid = (B + G - 1) / G;
  const size_t smem = static_cast<size_t>(forward_smem_slots(G, log2n) +
                                          matrix_smem_slots(G, log2n, kK, R)) * sizeof(int);
  acs_matrix_kernel<kK, kNarrow, Sym><<<grid, G * N, smem, stream>>>(
      static_cast<const Sym*>(y), labels, mtab, T, R, B, log2n, norm_every, qmax, sp, pm);
  return static_cast<int>(cudaGetLastError());
}

template <int kK, bool kNarrow>
int dispatch_matrix(const void* y, int dtype, const int* labels, const int* mtab, int T, int R,
                    int B, int log2n, int norm_every, int qmax, int* sp, int* pm,
                    cudaStream_t st) {
  switch (dtype) {
    case 0: return launch_matrix<kK, kNarrow, int8_t>(y, labels, mtab, T, R, B, log2n, norm_every, qmax, sp, pm, st);
    case 1: return launch_matrix<kK, kNarrow, int16_t>(y, labels, mtab, T, R, B, log2n, norm_every, qmax, sp, pm, st);
    case 2: return launch_matrix<kK, kNarrow, int32_t>(y, labels, mtab, T, R, B, log2n, norm_every, qmax, sp, pm, st);
    default: return 1000;  // integer symbols only: float lowers to the butterfly
  }
}

template <int kK>
int dispatch_matrix_mode(bool narrow, const void* y, int dtype, const int* labels,
                         const int* mtab, int T, int R, int B, int log2n, int norm_every,
                         int qmax, int* sp, int* pm, cudaStream_t st) {
  return narrow ? dispatch_matrix<kK, true>(y, dtype, labels, mtab, T, R, B, log2n, norm_every, qmax, sp, pm, st)
                : dispatch_matrix<kK, false>(y, dtype, labels, mtab, T, R, B, log2n, norm_every, qmax, sp, pm, st);
}

}  // namespace

// y: (T, R, B) symbols, dtype 0 = int8, 1 = int16, 2 = int32, 3 = float32.
// labels: (N, 2) int32 even/odd predecessor labels of each target state.
// norm_every: min-subtract every norm_every-th ACS step and qmax: clip
// symbols to +-qmax; both > 0 in the narrow modes (integer symbols only),
// both 0 otherwise.
// radix: 2, or 4 (two stages per step; needs N >= 4).
// sp: (T, ceil(N/32), B) int32 out. pm: (N, B) out, int32 (float32 for
// float symbols). Requires 1 <= log2n <= 10, 1 <= R <= 4, T >= 1, B >= 1.
// Returns cudaGetLastError() after the launch; 1000 for a bad argument.
extern "C" int pbvd_acs_forward(const void* y, int dtype, int T, int R, int B, int log2n,
                                const void* labels, int norm_every, int qmax, int radix,
                                void* sp, void* pm, void* stream) {
  if (log2n < 1 || log2n > 10 || R < 1 || R > pbvd::kMaxR || T < 1 || B < 1 ||
      norm_every < 0 || qmax < 0 || (norm_every > 0) != (qmax > 0) ||
      !(radix == 2 || (radix == 4 && log2n >= 2))) {
    return 1000;
  }
  const int* lab = static_cast<const int*>(labels);
  int* sp_i = static_cast<int*>(sp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = norm_every > 0;
  if (radix == 4) {
    return narrow ? dispatch<2, true>(y, dtype, lab, T, R, B, log2n, norm_every, qmax, sp_i, pm, st)
                  : dispatch<2, false>(y, dtype, lab, T, R, B, log2n, norm_every, qmax, sp_i, pm, st);
  }
  return narrow ? dispatch<1, true>(y, dtype, lab, T, R, B, log2n, norm_every, qmax, sp_i, pm, st)
                : dispatch<1, false>(y, dtype, lab, T, R, B, log2n, norm_every, qmax, sp_i, pm, st);
}

// K1-matrix. y: (T, R, B) integer symbols, dtype 0 = int8, 1 = int16,
// 2 = int32. labels: as pbvd_acs_forward (the trailing radix-2 stages).
// table: (2^k, 2^k, N >> k) int32, 2 * fold_idx + (fold_sgn < 0) of the
// code's matrix_acs_tables(k). k: stages per step, 1 <= k <= min(4, log2n),
// k * R <= 8. norm_every, qmax: as pbvd_acs_forward (norm_every counts
// k-stage steps). sp: (T, ceil(N/32), B) int32 out. pm: (N, B) int32 out.
// Returns cudaGetLastError() after the launch; 1000 for a bad argument.
extern "C" int pbvd_acs_forward_matrix(const void* y, int dtype, int T, int R, int B, int log2n,
                                       const void* labels, const void* table, int k,
                                       int norm_every, int qmax, void* sp, void* pm,
                                       void* stream) {
  if (log2n < 1 || log2n > 10 || R < 1 || R > pbvd::kMaxR || T < 1 || B < 1 || k < 1 ||
      k > 4 || k > log2n || k * R > 8 || norm_every < 0 || qmax < 0 ||
      (norm_every > 0) != (qmax > 0)) {
    return 1000;
  }
  const int* lab = static_cast<const int*>(labels);
  const int* mtab = static_cast<const int*>(table);
  int* sp_i = static_cast<int*>(sp);
  int* pm_i = static_cast<int*>(pm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = norm_every > 0;
  switch (k) {
    case 1: return dispatch_matrix_mode<1>(narrow, y, dtype, lab, mtab, T, R, B, log2n, norm_every, qmax, sp_i, pm_i, st);
    case 2: return dispatch_matrix_mode<2>(narrow, y, dtype, lab, mtab, T, R, B, log2n, norm_every, qmax, sp_i, pm_i, st);
    case 3: return dispatch_matrix_mode<3>(narrow, y, dtype, lab, mtab, T, R, B, log2n, norm_every, qmax, sp_i, pm_i, st);
    default: return dispatch_matrix_mode<4>(narrow, y, dtype, lab, mtab, T, R, B, log2n, norm_every, qmax, sp_i, pm_i, st);
  }
}
