// The fused single-kernel decoder: forward ACS and serial traceback in one
// kernel, with the survivor history kept on-chip.
//
// Replaces the TPU kernel repro/kernels/fused.py::_fused_kernel (driven by
// pbvd_fused_pallas with tb_mode="serial"), with both of its ACS phases:
// _acs_phase (radix 2) and _acs_phase_r4_dbuf (radix 4), in the metric
// modes f32/i16/i8. It computes the same function: per parallel block, the
// forward ACS of K1, then the serial walk from the start state after stage
// T-1 down to decode_start, emitting the decoded bit of stage
// decode_start + b at bit b & 31 of output word b >> 5 (bits of stages at or
// beyond T stay 0).
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

namespace {

using pbvd::forward_acs;
using pbvd::forward_smem_slots;

constexpr size_t kMaxSmem = 232448;      // per-CTA dynamic shared memory on the H100
constexpr size_t kDefaultSmem = 48 * 1024;

size_t fused_smem_bytes(int G, int log2n, int T) {
  const int W = ((1 << log2n) + 31) >> 5;
  return 4 * (static_cast<size_t>(forward_smem_slots(G, log2n)) +
              static_cast<size_t>(G) * T * W);
}

template <int kStagesPerStep, bool kNarrow, typename Sym, typename Acc>
__global__ void fused_kernel(const Sym* __restrict__ y, const int* __restrict__ labels,
                             const int* __restrict__ start, int T, int R, int B, int log2n,
                             int norm_every, int qmax, int decode_start, int n_decode,
                             int* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = 1 << log2n;
  const int W = (N + 31) >> 5;
  const int G = blockDim.x >> log2n;
  const int g = threadIdx.x >> log2n;
  const int b = blockIdx.x * G + g;
  Acc* acc_smem = reinterpret_cast<Acc*>(smem_raw);
  unsigned* hist = reinterpret_cast<unsigned*>(acc_smem + forward_smem_slots(G, log2n));
  unsigned* my_hist = hist + static_cast<size_t>(g) * T * W;

  // ---- phase 1: forward ACS, survivor words into shared memory -------------
  auto store = [&](int t, int w, unsigned word) {
    my_hist[static_cast<size_t>(t) * W + w] = word;
  };
  forward_acs<kStagesPerStep, kNarrow, Sym>(y, labels, T, R, B, log2n, norm_every, qmax,
                                            acc_smem, store);  // ends with a __syncthreads()

  // ---- phase 2: serial walk from shared memory, packed bits out ------------
  if ((threadIdx.x & (N - 1)) != 0 || b >= B) return;
  const unsigned n_mask = static_cast<unsigned>(N) - 1u;
  const unsigned half_mask = n_mask >> 1;
  // start states are in [0, N) by contract; the mask keeps the reads in
  // bounds whatever the caller passes
  unsigned state = static_cast<unsigned>(start[b]) & n_mask;
  const int n_words = n_decode >> 5;
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

template <int kStagesPerStep, bool kNarrow, typename Sym, typename Acc>
int launch(const void* y, const int* labels, const int* start, int T, int R, int B, int log2n,
           int norm_every, int qmax, int decode_start, int n_decode, int G, int* bits,
           cudaStream_t stream) {
  const int threads = G << log2n;
  const int grid = (B + G - 1) / G;
  const size_t smem = fused_smem_bytes(G, log2n, T);
  if (smem > kMaxSmem) return 1001;
  auto kernel = fused_kernel<kStagesPerStep, kNarrow, Sym, Acc>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, threads, smem, stream>>>(static_cast<const Sym*>(y), labels, start, T, R, B,
                                          log2n, norm_every, qmax, decode_start, n_decode, bits);
  return static_cast<int>(cudaGetLastError());
}

template <int kStagesPerStep, bool kNarrow>
int dispatch(const void* y, int dtype, const int* labels, const int* start, int T, int R, int B,
             int log2n, int norm_every, int qmax, int decode_start, int n_decode, int G,
             int* bits, cudaStream_t st) {
  switch (dtype) {
    case 0: return launch<kStagesPerStep, kNarrow, int8_t, int>(y, labels, start, T, R, B, log2n, norm_every, qmax, decode_start, n_decode, G, bits, st);
    case 1: return launch<kStagesPerStep, kNarrow, int16_t, int>(y, labels, start, T, R, B, log2n, norm_every, qmax, decode_start, n_decode, G, bits, st);
    case 2: return launch<kStagesPerStep, kNarrow, int32_t, int>(y, labels, start, T, R, B, log2n, norm_every, qmax, decode_start, n_decode, G, bits, st);
    case 3: return kNarrow ? 1000 : launch<kStagesPerStep, false, float, float>(y, labels, start, T, R, B, log2n, norm_every, qmax, decode_start, n_decode, G, bits, st);
    default: return 1000;
  }
}

}  // namespace

// y: (T, R, B) symbols, dtype 0 = int8, 1 = int16, 2 = int32, 3 = float32.
// labels: (N, 2) int32 even/odd predecessor labels; start: (B,) int32 start
// states. norm_every, qmax, radix: as pbvd_acs_forward. G: parallel blocks
// per CTA (G * N <= 1024). bits: (n_decode / 32, B) int32 out. Requires
// 0 <= decode_start < T, n_decode a multiple of 32.
// Returns cudaGetLastError() after the launch (or the error of raising the
// shared-memory limit); 1000 for a bad argument, 1001 for a history that
// does not fit in shared memory.
extern "C" int pbvd_fused(const void* y, int dtype, int T, int R, int B, int log2n,
                          const void* labels, const void* start, int decode_start, int n_decode,
                          int norm_every, int qmax, int radix, int G, void* bits, void* stream) {
  if (log2n < 1 || log2n > 10 || R < 1 || R > pbvd::kMaxR || T < 1 || B < 1 || G < 1 ||
      (G << log2n) > 1024 || decode_start < 0 || decode_start >= T || n_decode < 32 ||
      (n_decode & 31) || norm_every < 0 || qmax < 0 || (norm_every > 0) != (qmax > 0) ||
      !(radix == 2 || (radix == 4 && log2n >= 2))) {
    return 1000;
  }
  const int* lab = static_cast<const int*>(labels);
  const int* st0 = static_cast<const int*>(start);
  int* out = static_cast<int*>(bits);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = norm_every > 0;
  if (radix == 4) {
    return narrow ? dispatch<2, true>(y, dtype, lab, st0, T, R, B, log2n, norm_every, qmax,
                                      decode_start, n_decode, G, out, st)
                  : dispatch<2, false>(y, dtype, lab, st0, T, R, B, log2n, norm_every, qmax,
                                       decode_start, n_decode, G, out, st);
  }
  return narrow ? dispatch<1, true>(y, dtype, lab, st0, T, R, B, log2n, norm_every, qmax,
                                    decode_start, n_decode, G, out, st)
                : dispatch<1, false>(y, dtype, lab, st0, T, R, B, log2n, norm_every, qmax,
                                     decode_start, n_decode, G, out, st);
}
