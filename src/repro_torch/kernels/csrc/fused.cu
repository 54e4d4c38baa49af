// The fused single-kernel decoder: forward ACS and serial traceback in one
// kernel, with the survivor history kept on-chip.
//
// Replaces the TPU kernels repro/kernels/fused.py::_fused_kernel (driven by
// pbvd_fused_pallas with tb_mode="serial") and _fused_prefix_kernel
// (tb_mode="prefix"), with each of their ACS phases: _acs_phase (radix 2),
// _acs_phase_r4_dbuf (radix 4) and _acs_phase_mat_dbuf (k-stage matrix
// steps), in the metric modes f32/i16/i8. It computes the same function:
// per parallel block, the forward ACS of K1 (or K1-matrix), then the walk
// from the start state after stage T-1 down to decode_start, emitting the
// decoded bit of stage decode_start + b at bit b & 31 of output word b >> 5
// (bits of stages at or beyond T stay 0).
//
// Prefix tail. The walk is the chunked prefix walk of K2-prefix
// (traceback_core.cuh) over the shared history, whose stage-major layout it
// reads as is (stages below 0 read as the zero pad). The composed maps,
// the entry states and the decode window's words sit in shared memory
// beside the history; phase C ors each decoded bit into the window's words
// (atomicOr: the window starts at ds_local = decode_start + P - c_lo * C,
// which is not word aligned, so a chunk's bits straddle words) and the
// block then stores its n_decode/32 words.
//
// Design. The ACS phase is K1's (acs_core.cuh: one thread per target
// state, G = max(1, 128/N) parallel blocks per CTA, PM ping-pong in shared
// memory, narrow modes and the radix-4 step as there), except that each
// stage's survivor words go to dynamic shared memory, T*W*4 bytes per
// parallel block (4,768 B for CCSDS at T = 596; 19,072 B for K = 9), instead
// of global memory. After the loop's last barrier one thread per parallel
// block walks its history in shared memory and stores each packed output
// word when its lowest bit arrives. Above 48 KB the launch raises the
// kernel's dynamic shared-memory limit; a CTA that would need more than the
// card's 232,448 B first drops to G = 1, and the wrapper refuses a history
// that does not fit even then (it never falls back to the two-kernel path).
//
// The TPU kernel's radix-4 phase keeps the symbols in HBM in their wire
// dtype and double-buffers 64-stage tiles into VMEM with async copies. This
// kernel also reads the symbols in their wire dtype from global memory and
// widens (and, in the narrow modes, clips) them after the load, but it
// pipelines them only one ACS step ahead, into registers, as K1 does; a
// cp.async/TMA ring in shared memory is later work.
//
// Bound on the H100. The kernel moves only the symbols in and the packed
// bits out: at CCSDS, T = 596, int8 symbols, 2.45 bytes per decoded bit
// against K1+K2's 20.47, and does K1's ACS operations plus a handful per
// walked stage, so the integer issue rate bounds it. Against K1+K2 it
// saves the survivor round trip through global memory and K2's chain of
// dependent global loads: the walk's chain runs on shared-memory latency,
// and while one CTA walks, the other CTAs on its SM run their ACS.

#include "acs_core.cuh"
#include "traceback_core.cuh"

namespace {

using pbvd::forward_acs;
using pbvd::forward_acs_matrix;
using pbvd::forward_smem_slots;
using pbvd::matrix_smem_slots;

constexpr size_t kMaxSmem = 232448;      // per-CTA dynamic shared memory on the H100
constexpr size_t kDefaultSmem = 48 * 1024;

// The ACS loop's slots (4 bytes each), then G histories of T * W words,
// then (prefix) G blocks of walk scratch: n_act * N maps, nc_e entry
// states, n_decode / 32 window words. k = 0 for the butterfly.
__host__ __device__ inline int acs_slots(int G, int log2n, int k, int R) {
  return forward_smem_slots(G, log2n) + (k ? matrix_smem_slots(G, log2n, k, R) : 0);
}

size_t fused_smem_bytes(int G, int log2n, int T, int k, int R, int prefix_words) {
  const int W = ((1 << log2n) + 31) >> 5;
  return 4 * (static_cast<size_t>(acs_slots(G, log2n, k, R)) +
              static_cast<size_t>(G) * T * W + static_cast<size_t>(G) * prefix_words);
}

// Phase 2 in prefix mode: the prefix walk of this parallel block over its
// shared history. It is kept out of line: inlined into the kernel, it made
// every instantiation slower, the serial radix-2 path by ~40 % on the H100
// (PERF.md, PR 13), though ptxas counted no more registers.
__device__ __noinline__ void prefix_tail(const unsigned* my_hist, int W, int G, int T, int B,
                                         int b, int log2n, int n_words, unsigned* hist,
                                         const int* __restrict__ start,
                                         const pbvd::PrefixGeometry& geo, int* __restrict__ bits) {
  const int N = 1 << log2n;
  const int g = threadIdx.x >> log2n;
  const bool valid = b < B;
  const int s = threadIdx.x & (N - 1);
  int* maps = reinterpret_cast<int*>(hist + static_cast<size_t>(G) * T * W) +
              g * (geo.n_act * N + geo.nc_e + n_words);
  int* entry = maps + geo.n_act * N;
  unsigned* window = reinterpret_cast<unsigned*>(entry + geo.nc_e);
  for (int w = s; w < n_words; w += N) window[w] = 0u;  // phase A's barrier orders it
  auto sp_word = [&](int stage, unsigned w) -> unsigned {
    return stage < 0 ? 0u : my_hist[static_cast<size_t>(stage) * W + w];
  };
  auto emit = [&](int idx, unsigned bit) {
    if (bit) atomicOr(&window[idx >> 5], 1u << (idx & 31));
  };
  pbvd::prefix_traceback(geo, log2n, valid, valid ? static_cast<unsigned>(start[b]) : 0u,
                         maps, entry, sp_word, emit);
  __syncthreads();
  if (valid) {
    for (int w = s; w < n_words; w += N) {
      bits[static_cast<size_t>(w) * B + b] = static_cast<int>(window[w]);
    }
  }
}

// kMatrix: kStagesPerStep is the matrix k (integer symbols, Acc = int);
// otherwise 1 (radix 2) or 2 (radix 4). prefix selects the walk at run time.
template <int kStagesPerStep, bool kMatrix, bool kNarrow, typename Sym, typename Acc>
__global__ void fused_kernel(const Sym* __restrict__ y, const int* __restrict__ labels,
                             const int* __restrict__ mtab, const int* __restrict__ start, int T,
                             int R, int B, int log2n, int norm_every, int qmax,
                             int decode_start, int n_decode, int prefix,
                             pbvd::PrefixGeometry geo, int* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = 1 << log2n;
  const int W = (N + 31) >> 5;
  const int G = blockDim.x >> log2n;
  const int g = threadIdx.x >> log2n;
  const int b = blockIdx.x * G + g;
  Acc* acc_smem = reinterpret_cast<Acc*>(smem_raw);
  unsigned* hist = reinterpret_cast<unsigned*>(
      acc_smem + acs_slots(G, log2n, kMatrix ? kStagesPerStep : 0, R));
  unsigned* my_hist = hist + static_cast<size_t>(g) * T * W;

  // ---- phase 1: forward ACS, survivor words into shared memory -------------
  auto store = [&](int t, int w, unsigned word) {
    my_hist[static_cast<size_t>(t) * W + w] = word;
  };
  // both end with a __syncthreads()
  if constexpr (kMatrix) {
    forward_acs_matrix<kStagesPerStep, kNarrow, Sym>(y, labels, mtab, T, R, B, log2n,
                                                     norm_every, qmax, acc_smem, store);
  } else {
    forward_acs<kStagesPerStep, kNarrow, Sym>(y, labels, T, R, B, log2n, norm_every, qmax,
                                              acc_smem, store);
  }

  const int n_words = n_decode >> 5;
  if (prefix) {  // ---- phase 2 (prefix): chunked walk of the shared history
    prefix_tail(my_hist, W, G, T, B, b, log2n, n_words, hist, start, geo, bits);
    return;
  }

  // ---- phase 2 (serial): walk from shared memory, packed bits out ----------
  if ((threadIdx.x & (N - 1)) != 0 || b >= B) return;
  const unsigned n_mask = static_cast<unsigned>(N) - 1u;
  const unsigned half_mask = n_mask >> 1;
  // start states are in [0, N) by contract; the mask keeps the reads in
  // bounds whatever the caller passes
  unsigned state = static_cast<unsigned>(start[b]) & n_mask;
  const int top = T - 1 - decode_start;  // bit index of stage T-1
  for (int w = (top >> 5) + 1; w < n_words; ++w) bits[static_cast<size_t>(w) * B + b] = 0;
  unsigned word = 0;
  for (int st = T - 1;; --st) {
    const int bi = st - decode_start;
    if (bi < n_decode) {
      word |= (state >> (log2n - 1)) << (bi & 31);
      if ((bi & 31) == 0) {  // flush the word when its lowest bit arrives
        bits[static_cast<size_t>(bi >> 5) * B + b] = static_cast<int>(word);
        word = 0;
      }
    }
    if (st == decode_start) break;
    const unsigned sw = my_hist[static_cast<size_t>(st) * W + (state >> 5)];
    state = ((state & half_mask) << 1) | ((sw >> (state & 31u)) & 1u);
  }
}

struct Launch {
  const void* y;
  const int* labels;
  const int* mtab;
  const int* start;
  int T, R, B, log2n, norm_every, qmax, decode_start, n_decode, prefix, G;
  pbvd::PrefixGeometry geo;
  int* bits;
  cudaStream_t stream;
};

template <int kStagesPerStep, bool kMatrix, bool kNarrow, typename Sym, typename Acc>
int launch(const Launch& a) {
  const int k = kMatrix ? kStagesPerStep : 0;
  const int prefix_words = a.prefix ? a.geo.n_act * (1 << a.log2n) + a.geo.nc_e + (a.n_decode >> 5) : 0;
  const size_t smem = fused_smem_bytes(a.G, a.log2n, a.T, k, a.R, prefix_words);
  if (smem > kMaxSmem) return 1001;
  auto kernel = fused_kernel<kStagesPerStep, kMatrix, kNarrow, Sym, Acc>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<(a.B + a.G - 1) / a.G, a.G << a.log2n, smem, a.stream>>>(
      static_cast<const Sym*>(a.y), a.labels, a.mtab, a.start, a.T, a.R, a.B, a.log2n,
      a.norm_every, a.qmax, a.decode_start, a.n_decode, a.prefix, a.geo, a.bits);
  return static_cast<int>(cudaGetLastError());
}

template <int kStagesPerStep, bool kMatrix, bool kNarrow>
int dispatch(const Launch& a, int dtype) {
  switch (dtype) {
    case 0: return launch<kStagesPerStep, kMatrix, kNarrow, int8_t, int>(a);
    case 1: return launch<kStagesPerStep, kMatrix, kNarrow, int16_t, int>(a);
    case 2: return launch<kStagesPerStep, kMatrix, kNarrow, int32_t, int>(a);
    case 3:  // float symbols: the butterfly in f32 only
      if constexpr (kMatrix || kNarrow) {
        return 1000;
      } else {
        return launch<kStagesPerStep, false, false, float, float>(a);
      }
    default: return 1000;
  }
}

template <int kStagesPerStep, bool kMatrix>
int dispatch_mode(const Launch& a, int dtype) {
  return a.norm_every > 0 ? dispatch<kStagesPerStep, kMatrix, true>(a, dtype)
                          : dispatch<kStagesPerStep, kMatrix, false>(a, dtype);
}

}  // namespace

// y: (T, R, B) symbols, dtype 0 = int8, 1 = int16, 2 = int32, 3 = float32.
// labels: (N, 2) int32 even/odd predecessor labels; table: the matrix table
// of pbvd_acs_forward_matrix (read only when k > 0); start: (B,) int32
// start states. norm_every, qmax, radix: as pbvd_acs_forward; k: 0 for the
// butterfly at radix, else the matrix steps' k (1..4, integer symbols).
// prefix: 0 for the serial walk, 1 for the prefix walk with the geometry
// C, P, n_chunks, c_lo, c_hi of prefix_chunk_geometry(T, decode_start,
// min(n_decode, T - decode_start), tb_chunk). G: parallel blocks per CTA
// (G * N <= 1024). bits: (n_decode / 32, B) int32 out. Requires
// 0 <= decode_start < T, n_decode a multiple of 32.
// Returns cudaGetLastError() after the launch (or the error of raising the
// shared-memory limit); 1000 for a bad argument, 1001 for a history (and
// scratch) that does not fit in shared memory.
extern "C" int pbvd_fused(const void* y, int dtype, int T, int R, int B, int log2n,
                          const void* labels, const void* table, const void* start,
                          int decode_start, int n_decode, int norm_every, int qmax, int radix,
                          int k, int prefix, int C, int P, int n_chunks, int c_lo, int c_hi,
                          int G, void* bits, void* stream) {
  const int n_window = n_decode < T - decode_start ? n_decode : T - decode_start;
  if (log2n < 1 || log2n > 10 || R < 1 || R > pbvd::kMaxR || T < 1 || B < 1 || G < 1 ||
      (G << log2n) > 1024 || decode_start < 0 || decode_start >= T || n_decode < 32 ||
      (n_decode & 31) || norm_every < 0 || qmax < 0 || (norm_every > 0) != (qmax > 0) ||
      !(radix == 2 || (radix == 4 && log2n >= 2)) || k < 0 || k > 4 || k > log2n ||
      k * R > 8 || (k > 0 && table == nullptr) || (prefix != 0 && prefix != 1)) {
    return 1000;
  }
  if (prefix && (C < 1 || P < 0 || P >= C || n_chunks * C != T + P || c_lo < 0 ||
                 c_hi < c_lo || c_hi >= n_chunks ||
                 (decode_start + P + n_window - 1) / C != c_hi ||
                 (decode_start + P) / C != c_lo)) {
    return 1000;
  }
  Launch a{y, static_cast<const int*>(labels), static_cast<const int*>(table),
           static_cast<const int*>(start), T, R, B, log2n, norm_every, qmax, decode_start,
           n_decode, prefix, G,
           pbvd::PrefixGeometry{C, P, c_lo, n_chunks - c_lo, c_hi - c_lo + 1,
                                decode_start + P - c_lo * C, n_window},
           static_cast<int*>(bits), static_cast<cudaStream_t>(stream)};
  switch (k) {
    case 0: return radix == 4 ? dispatch_mode<2, false>(a, dtype) : dispatch_mode<1, false>(a, dtype);
    case 1: return dispatch_mode<1, true>(a, dtype);
    case 2: return dispatch_mode<2, true>(a, dtype);
    case 3: return dispatch_mode<3, true>(a, dtype);
    default: return dispatch_mode<4, true>(a, dtype);
  }
}
