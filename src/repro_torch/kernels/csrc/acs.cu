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
// path metrics. No stage padding: the loop runs the true T stages, so the
// final PM is the true stage-T metric (the argmin start follows the
// reference's "ref" semantics), and odd T at radix 4 ends with the
// reference's trailing radix-2 stage.
//
// Two bodies (acs_core.cuh), chosen by the code and counted apart by the
// wrapper (repro_torch/kernels/acs.py):
//
// * acs_warp_kernel, the warp body, for the three registered mother codes
//   (CCSDS, IS-95, LTE), each instantiated with its trellis tables fixed
//   at compile time and S path metrics per lane in registers: a parallel
//   block's states in L = N/S lanes of one warp, Gw = 32/L blocks per warp,
//   one warp per CTA, neighbouring lanes on neighbouring blocks. The S
//   variants instantiated are 64, 32 and 16 at N = 64 and 64 and 32 at
//   N = 256 (255 registers cannot hold 256 metrics); the wrapper picks
//   the default.
// * acs_table_kernel, the runtime-table body (the first thread-per-state
//   kernel of the port, under its own name) for every other code: labels from a table,
//   one thread per state, G = max(1, 128/N) blocks per CTA, PM ping-pong in
//   shared memory with one barrier per stage, any N up to 1024.
//
// Bound on the H100 80GB HBM3 (700 W limit). Per stage and parallel block
// the function needs about 4N integer operations (two adds, a compare and
// a select per state) and moves R symbol bytes in and 4*W survivor bytes
// out: at N = 64, W = 2 that is ~256 operations per 10 bytes, so the INT32
// issue rate bounds it (132 SMs x 64 lanes x 1.98 GHz = 16.7 Tops/s:
// 0.0753 ms at the main shapes T = 596, B = 8192), not HBM (0.0152 ms).
// The table body took 1.555 ms there (PERF.md): ~10x the bound's
// instructions per state and a CTA barrier per stage. The warp body spends
// two adds, a compare, a select and the or of the decision into its word
// per state and stage, forms the folded rows once per stage and lane, and
// has no barrier; its risk is occupancy: at S = 64 the 8,192 blocks of the
// main path fill 256 warps for the card's 528 schedulers, at S = 32 512,
// at S = 16 1,024. On the H100 80GB HBM3 (700 W) S = 32 is the fastest of
// the three at CCSDS, about a third of the bound and a sixth of the table
// body's time; LTE is fastest at S = 16 and IS-95 at S = 64 (255
// registers cannot hold 256 metrics, and S = 32 doubles its shuffles).
// chip_smoke.py phase 6 prints every variant; PERF.md keeps the times.
//
// K1-matrix (pbvd_acs_forward_matrix) replaces the TPU kernel
// repro/kernels/acs.py::_acs_matrix_kernel (acs_forward_pallas with
// impl="matrix"): T // k k-stage (min,+) steps, each emitting its k standard
// radix-2 survivor planes, then T mod k radix-2 stages (the reference's
// "ref" semantics; the port pads no stages). Two bodies, chosen by the code
// and counted apart by the wrapper (matrix_launches, matrix_table_launches):
//
// * acs_matrix_warp_kernel, the matrix warp body (acs_core.cuh::
//   forward_acs_matrix_warp), for CCSDS, IS-95 and LTE at every k that
//   validate_matrix_k and the limit of 4 allow, one S per (code, k), launched
//   as acs_warp_kernel is (one warp per CTA, Gw = 32/L blocks). Its
//   compile-time matrix table is exported (pbvd_acs_code_matrix_table) and
//   held against kernel_matrix_table before the first launch.
// * acs_matrix_kernel, the runtime-table matrix body (forward_acs_matrix,
//   the port's first thread-per-state form) for every other code: the
//   table from global memory, rows and decision planes in shared memory.
//
// Tensor cores: a record, not a build. The TPU kernel assembles the k-stage
// metrics with one MXU product E @ folded; here each candidate gathers + or
// - one folded row, which on this card costs no instruction: E is a signed
// one-hot operand (code.matrix_expansion(k)), so the product is a gather
// with a sign, and a gather from a compile-time table is a register name. A
// wgmma over E (2^k*N rows x 2^(kR-1) depth) would spend 2^(kR-1)
// multiply-adds per metric, leave the metrics in accumulator fragments that
// the tournament would have to shuffle back into its slots, and the (min,+)
// tournament itself has no tensor-core form; the TPU's own fused matrix
// phase does not use the MXU either.
//
// Bound: the function is K1's (0.0753 ms at the main shapes on the H100
// 80GB HBM3, 700 W, by INT32 operations). The matrix form does K1's work
// times 1.29, 2.02 and 3.72 at k = 2, 3, 4 (2^k adds and 2^k - 1
// compare-selects per k-step and target: 0.0969, 0.1523 and 0.2802 ms), and
// the card is integer-issue-bound, so it cannot beat the butterfly; a chain
// k times shorter buys nothing with 8,192 blocks in flight. The table body
// took 1.92 ms at k = 2 on that card; the matrix warp body takes about
// 0.31 ms (0.34 at k = 3, 0.44 at k = 4), against K1's 0.23 ms (PERF.md,
// chip_smoke.py phase 14, launch/kernel_times.py).

#include "acs_core.cuh"

namespace {

using pbvd::forward_acs_matrix;
using pbvd::forward_acs_table;
using pbvd::forward_smem_slots;
using pbvd::matrix_smem_slots;

// ---- the warp body --------------------------------------------------------

template <class Code, int kS, int kStagesPerStep, bool kNarrow, typename Acc>
__global__ void __launch_bounds__(32) acs_warp_kernel(const void* __restrict__ y, int dtype,
                                                      int T, int B, int norm_every, int qmax,
                                                      int* __restrict__ sp,
                                                      Acc* __restrict__ pm_out) {
  constexpr int W = Code::W;
  constexpr int G = 32 / pbvd::WarpMap<Code, kS>::L;  // parallel blocks per warp (= CTA)
  const int lane = threadIdx.x;
  const int sub = lane / G;
  const int b = blockIdx.x * G + lane % G;
  const bool valid = b < B;
  auto load = [&](int t0, Acc (&dst)[Code::v][Code::R]) {
    pbvd::load_block<kNarrow>(y, dtype, t0, T, B, b, valid, qmax, dst);
  };
  auto store = [&](int t, int w, unsigned word, bool ok) {
    if (ok && valid) sp[(static_cast<size_t>(t) * W + w) * B + b] = static_cast<int>(word);
  };
  auto pm_store = [&](int s, Acc m) {
    if (valid) pm_out[static_cast<size_t>(s) * B + b] = m;
  };
  pbvd::forward_acs_warp<Code, kS, kStagesPerStep, kNarrow, Acc>(T, norm_every, sub, G,
                                                                 0xffffffffu, load, store,
                                                                 pm_store);
}

struct WarpArgs {
  const void* y;
  int dtype, T, B, norm_every, qmax, radix, S;
  int* sp;
  void* pm;
  cudaStream_t stream;
};

template <class Code, int kS, int kStagesPerStep, bool kNarrow, typename Acc>
int launch_warp(const WarpArgs& a) {
  constexpr int G = 32 / pbvd::WarpMap<Code, kS>::L;
  acs_warp_kernel<Code, kS, kStagesPerStep, kNarrow, Acc><<<(a.B + G - 1) / G, 32, 0, a.stream>>>(
      a.y, a.dtype, a.T, a.B, a.norm_every, a.qmax, a.sp, static_cast<Acc*>(a.pm));
  return static_cast<int>(cudaGetLastError());
}

// float symbols run float metrics; integer symbols int32 metrics, narrow or not
template <class Code, int kS, int kStagesPerStep>
int warp_mode(const WarpArgs& a) {
  if (a.dtype == 3) {
    return a.norm_every > 0 ? 1000 : launch_warp<Code, kS, kStagesPerStep, false, float>(a);
  }
  return a.norm_every > 0 ? launch_warp<Code, kS, kStagesPerStep, true, int>(a)
                          : launch_warp<Code, kS, kStagesPerStep, false, int>(a);
}

template <class Code, int kS>
int warp_radix(const WarpArgs& a) {
  return a.radix == 4 ? warp_mode<Code, kS, 2>(a) : warp_mode<Code, kS, 1>(a);
}

// the S variants instantiated: 64, 32, 16 at N = 64; 64, 32 at N = 256
template <class Code>
int warp_states(const WarpArgs& a) {
  switch (a.S) {
    case 64: return warp_radix<Code, 64>(a);
    case 32: return warp_radix<Code, 32>(a);
    case 16:
      if constexpr (Code::N == 64) {
        return warp_radix<Code, 16>(a);
      } else {
        return 1000;
      }
    default: return 1000;
  }
}

// ---- the matrix warp body (K1-matrix for the mother codes) -------------------

template <class Code, int kS, int kK>
__global__ void __launch_bounds__(32) acs_matrix_warp_kernel(const void* __restrict__ y,
                                                             int dtype, int T, int B,
                                                             int norm_every, int qmax,
                                                             int* __restrict__ sp,
                                                             int* __restrict__ pm_out) {
  constexpr int W = Code::W;
  constexpr int G = 32 / pbvd::WarpMap<Code, kS>::L;  // parallel blocks per warp (= CTA)
  const int lane = threadIdx.x;
  const int sub = lane / G;
  const int b = blockIdx.x * G + lane % G;
  const bool valid = b < B;
  constexpr int kLoad = pbvd::WarpMatrix<Code, kS, kK>::kLoad;
  auto load = [&](int t0, int (&dst)[kLoad][Code::R]) {  // narrow modes clip
    if (qmax) {
      pbvd::load_block<true>(y, dtype, t0, T, B, b, valid, qmax, dst);
    } else {
      pbvd::load_block<false>(y, dtype, t0, T, B, b, valid, qmax, dst);
    }
  };
  auto store = [&](int t, int w, unsigned word, bool ok) {
    if (ok && valid) sp[(static_cast<size_t>(t) * W + w) * B + b] = static_cast<int>(word);
  };
  auto pm_store = [&](int s, int m) {
    if (valid) pm_out[static_cast<size_t>(s) * B + b] = m;
  };
  pbvd::forward_acs_matrix_warp<Code, kS, kK>(T, norm_every, sub, G, 0xffffffffu, load, store,
                                              pm_store);
}

template <class Code, int kK>
int launch_matrix_warp(const WarpArgs& a) {
  constexpr int S = pbvd::matrix_warp_states<Code>(kK);
  constexpr int G = 32 / pbvd::WarpMap<Code, S>::L;
  if (a.S != S || a.dtype == 3) return 1000;  // integer symbols only
  acs_matrix_warp_kernel<Code, S, kK><<<(a.B + G - 1) / G, 32, 0, a.stream>>>(
      a.y, a.dtype, a.T, a.B, a.norm_every, a.qmax, a.sp, static_cast<int*>(a.pm));
  return static_cast<int>(cudaGetLastError());
}

// every k that validate_matrix_k and the limit of 4 allow for the code
template <class Code>
int matrix_warp_k(const WarpArgs& a, int k) {
  switch (k) {
    case 1: return launch_matrix_warp<Code, 1>(a);
    case 2: return launch_matrix_warp<Code, 2>(a);
    case 3:
      if constexpr (Code::matrix_k_ok(3)) return launch_matrix_warp<Code, 3>(a);
      return 1000;
    case 4:
      if constexpr (Code::matrix_k_ok(4)) return launch_matrix_warp<Code, 4>(a);
      return 1000;
    default: return 1000;
  }
}

// ---- the runtime-table body -------------------------------------------------

template <int kStagesPerStep, bool kNarrow, typename Sym, typename Acc>
__global__ void acs_table_kernel(const Sym* __restrict__ y, const int* __restrict__ labels,
                                 int T, int R, int B, int log2n, int norm_every, int qmax,
                                 int* __restrict__ sp, Acc* __restrict__ pm_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int W = ((1 << log2n) + 31) >> 5;
  const int G = blockDim.x >> log2n;
  const int b = blockIdx.x * G + (threadIdx.x >> log2n);
  auto store = [&](int t, int w, unsigned word) {
    sp[(static_cast<size_t>(t) * W + w) * B + b] = static_cast<int>(word);
  };
  const Acc pm = forward_acs_table<kStagesPerStep, kNarrow, Sym>(
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
  acs_table_kernel<kStagesPerStep, kNarrow, Sym, Acc><<<grid, threads, smem, stream>>>(
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

// ---- K1-matrix --------------------------------------------------------------

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
// labels: (N, 2) int32 even/odd predecessor labels of each target state
// (read by the runtime-table body only). norm_every: min-subtract every
// norm_every-th ACS step and qmax: clip symbols to +-qmax; both > 0 in the
// narrow modes (integer symbols only), both 0 otherwise.
// radix: 2, or 4 (two stages per step; needs N >= 4).
// code: 0 for the runtime-table body, else the mother code of the warp body
// (1 CCSDS, 2 IS-95, 3 LTE; log2n and R must be the code's); S: its path
// metrics per lane (64, 32 or 16 at N = 64; 64 or 32 at N = 256).
// sp: (T, ceil(N/32), B) int32 out. pm: (N, B) out, int32 (float32 for
// float symbols). Requires 1 <= log2n <= 10, 1 <= R <= 4, T >= 1, B >= 1.
// Returns cudaGetLastError() after the launch; 1000 for a bad argument.
extern "C" int pbvd_acs_forward(const void* y, int dtype, int T, int R, int B, int log2n,
                                const void* labels, int norm_every, int qmax, int radix,
                                int code, int S, void* sp, void* pm, void* stream) {
  if (log2n < 1 || log2n > 10 || R < 1 || R > pbvd::kMaxR || T < 1 || B < 1 ||
      norm_every < 0 || qmax < 0 || (norm_every > 0) != (qmax > 0) ||
      !(radix == 2 || (radix == 4 && log2n >= 2)) || dtype < 0 || dtype > 3) {
    return 1000;
  }
  int* sp_i = static_cast<int*>(sp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code != pbvd::kCodeTable) {
    const WarpArgs a{y, dtype, T, B, norm_every, qmax, radix, S, sp_i, pm, st};
    switch (code) {
      case pbvd::kCodeCcsds:
        return log2n == pbvd::Ccsds::v && R == pbvd::Ccsds::R ? warp_states<pbvd::Ccsds>(a) : 1000;
      case pbvd::kCodeIs95:
        return log2n == pbvd::Is95::v && R == pbvd::Is95::R ? warp_states<pbvd::Is95>(a) : 1000;
      case pbvd::kCodeLte:
        return log2n == pbvd::Lte::v && R == pbvd::Lte::R ? warp_states<pbvd::Lte>(a) : 1000;
      default: return 1000;
    }
  }
  const int* lab = static_cast<const int*>(labels);
  const bool narrow = norm_every > 0;
  if (radix == 4) {
    return narrow ? dispatch<2, true>(y, dtype, lab, T, R, B, log2n, norm_every, qmax, sp_i, pm, st)
                  : dispatch<2, false>(y, dtype, lab, T, R, B, log2n, norm_every, qmax, sp_i, pm, st);
  }
  return narrow ? dispatch<1, true>(y, dtype, lab, T, R, B, log2n, norm_every, qmax, sp_i, pm, st)
                : dispatch<1, false>(y, dtype, lab, T, R, B, log2n, norm_every, qmax, sp_i, pm, st);
}

// The (N, 2) even/odd labels that the warp body of code id `code` derives
// at compile time, into out (2N ints); returns N, or -1 for an id without
// an instantiation.
extern "C" int pbvd_acs_code_labels(int code, int* out) { return pbvd::code_labels(code, out); }

// The (2^k, 2^k, N >> k) matrix table that the matrix warp body of code id
// `code` derives at compile time, into out; returns its length, or -1 for
// an id or k without an instantiation.
extern "C" int pbvd_acs_code_matrix_table(int code, int k, int* out) {
  return pbvd::code_matrix_table(code, k, out);
}

// K1-matrix. y: (T, R, B) integer symbols, dtype 0 = int8, 1 = int16,
// 2 = int32. labels: as pbvd_acs_forward (the trailing radix-2 stages of
// the runtime-table body). table: (2^k, 2^k, N >> k) int32, 2 * fold_idx +
// (fold_sgn < 0) of the code's matrix_acs_tables(k) (read by the
// runtime-table body only). k: stages per step, 1 <= k <= min(4, log2n),
// k * R <= 8. norm_every, qmax: as pbvd_acs_forward (norm_every counts
// k-stage steps). code: 0 for the runtime-table body, else the mother code
// of the matrix warp body (log2n and R must be the code's); S: its path
// metrics per lane, the one built for (code, k). sp: (T, ceil(N/32), B)
// int32 out. pm: (N, B) int32 out. Returns cudaGetLastError() after the
// launch; 1000 for a bad argument.
extern "C" int pbvd_acs_forward_matrix(const void* y, int dtype, int T, int R, int B, int log2n,
                                       const void* labels, const void* table, int k,
                                       int norm_every, int qmax, int code, int S, void* sp,
                                       void* pm, void* stream) {
  if (log2n < 1 || log2n > 10 || R < 1 || R > pbvd::kMaxR || T < 1 || B < 1 || k < 1 ||
      k > 4 || k > log2n || k * R > 8 || norm_every < 0 || qmax < 0 ||
      (norm_every > 0) != (qmax > 0) || dtype < 0 || dtype > 3) {
    return 1000;
  }
  const int* lab = static_cast<const int*>(labels);
  const int* mtab = static_cast<const int*>(table);
  int* sp_i = static_cast<int*>(sp);
  int* pm_i = static_cast<int*>(pm);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (code != pbvd::kCodeTable) {
    const WarpArgs a{y, dtype, T, B, norm_every, qmax, 0, S, sp_i, pm, st};
    switch (code) {
      case pbvd::kCodeCcsds:
        return log2n == pbvd::Ccsds::v && R == pbvd::Ccsds::R ? matrix_warp_k<pbvd::Ccsds>(a, k) : 1000;
      case pbvd::kCodeIs95:
        return log2n == pbvd::Is95::v && R == pbvd::Is95::R ? matrix_warp_k<pbvd::Is95>(a, k) : 1000;
      case pbvd::kCodeLte:
        return log2n == pbvd::Lte::v && R == pbvd::Lte::R ? matrix_warp_k<pbvd::Lte>(a, k) : 1000;
      default: return 1000;
    }
  }
  const bool narrow = norm_every > 0;
  switch (k) {
    case 1: return dispatch_matrix_mode<1>(narrow, y, dtype, lab, mtab, T, R, B, log2n, norm_every, qmax, sp_i, pm_i, st);
    case 2: return dispatch_matrix_mode<2>(narrow, y, dtype, lab, mtab, T, R, B, log2n, norm_every, qmax, sp_i, pm_i, st);
    case 3: return dispatch_matrix_mode<3>(narrow, y, dtype, lab, mtab, T, R, B, log2n, norm_every, qmax, sp_i, pm_i, st);
    default: return dispatch_matrix_mode<4>(narrow, y, dtype, lab, mtab, T, R, B, log2n, norm_every, qmax, sp_i, pm_i, st);
  }
}
