// K2: serial traceback of the parallel block-based Viterbi decoder.
//
// Replaces the TPU kernel repro/kernels/traceback.py::_traceback_kernel
// (driven by traceback_pallas). It computes the same function: from the
// start state after stage T-1, walk the packed survivor words back to stage
// decode_start; at stage s emit the walked state's MSB (the input bit of
// stage s) for s in [decode_start, decode_start + n_decode), then step to
// the predecessor state' = 2 * (state mod N/2) + bit, where bit is bit
// (state % 32) of survivor word sp[s][state / 32][b].
//
// Design. One thread per parallel block, as in the paper. Where the TPU
// kernel fetched the word with a W-way select over the stage's words (it
// has no per-lane gather), a thread here loads sp[s][state >> 5][b]
// directly. Consecutive threads are consecutive blocks b, so each warp's
// loads and bit stores fall on one contiguous row of the (stage, word)
// plane, except where the threads' states sit in different words. The walk
// stops at decode_start: stages below it emit nothing and feed nothing.
//
// Bound on the H100. The kernel moves ~4 bytes in and 4 bytes out per
// decoded bit and does a handful of integer operations per stage, but each
// stage's load address depends on the previous load: a block's walk is a
// chain of T - 1 - decode_start dependent global loads. At 8192 blocks
// there are only 8192 threads (about two warps per SM), too few to hide
// that latency, so expect the chain's latency, not bytes or operations, to
// set the time. This first version does nothing about it; the fused kernel
// (survivor history in shared memory) is the planned answer.
//
// K2-prefix (pbvd_traceback_prefix) replaces the TPU kernel
// repro/kernels/traceback.py::_traceback_prefix_kernel (driven by
// traceback_prefix_pallas): the same bits from the chunked parallel-prefix
// walk, whose three phases live in traceback_core.cuh, shared with the
// fused kernel. A CTA holds G = max(1, 128/N) parallel blocks of N threads
// and their composed maps in shared memory; the words come from global
// memory through the read-only cache. The longest dependent chain drops
// from T - 1 - decode_start loads to about C (compose) + n_act (walk) + C
// (expand), 137 at the main geometry against K2's 553, for about
// n_act * N * C word loads of work per block instead of 553 (operations,
// not bytes or latency, should then bound it).

#include <cstdint>
#include <cuda_runtime.h>

#include "traceback_core.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // per-CTA dynamic shared memory on the H100
constexpr size_t kDefaultSmem = 48 * 1024;

__global__ void traceback_kernel(const int* __restrict__ sp, const int* __restrict__ start,
                                 int T, int W, int B, int log2n, int decode_start,
                                 int n_decode, int* __restrict__ bits) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const unsigned n_mask = (1u << log2n) - 1u;
  const unsigned half_mask = n_mask >> 1;
  // start states are in [0, N) by contract; the mask keeps the loads in
  // bounds whatever the caller passes
  unsigned state = static_cast<unsigned>(start[b]) & n_mask;
  const int emit_end = decode_start + n_decode;
  for (int s = T - 1;; --s) {
    if (s < emit_end) {
      bits[static_cast<size_t>(s - decode_start) * B + b] = static_cast<int>(state >> (log2n - 1));
    }
    if (s == decode_start) break;
    const unsigned word = static_cast<unsigned>(
        __ldg(sp + (static_cast<size_t>(s) * W + (state >> 5)) * B + b));
    const unsigned bit = (word >> (state & 31u)) & 1u;
    state = ((state & half_mask) << 1) | bit;
  }
}

__global__ void traceback_prefix_kernel(const int* __restrict__ sp, const int* __restrict__ start,
                                        int W, int B, int log2n, pbvd::PrefixGeometry geo,
                                        int* __restrict__ bits) {
  extern __shared__ int smem[];
  const int N = 1 << log2n;
  const int G = blockDim.x >> log2n;
  const int g = threadIdx.x >> log2n;
  const int b = blockIdx.x * G + g;
  const bool valid = b < B;
  int* maps = smem + g * (geo.n_act * N + geo.nc_e);
  int* entry = maps + geo.n_act * N;
  auto sp_word = [&](int stage, unsigned w) -> unsigned {
    if (stage < 0 || !valid) return 0u;  // the virtual pad below stage 0
    return static_cast<unsigned>(__ldg(sp + (static_cast<size_t>(stage) * W + w) * B + b));
  };
  auto emit = [&](int idx, unsigned bit) {
    bits[static_cast<size_t>(idx) * B + b] = static_cast<int>(bit);
  };
  pbvd::prefix_traceback(geo, log2n, valid, valid ? static_cast<unsigned>(start[b]) : 0u, maps,
                         entry, sp_word, emit);
}

}  // namespace

// sp: (T, W, B) int32 packed survivor words; start: (B,) int32 start states.
// bits: (n_decode, B) int32 out. Requires 0 <= decode_start,
// decode_start + n_decode <= T, 1 <= log2n <= 10, B >= 1.
// Returns cudaGetLastError() after the launch; 1000 for a bad argument.
extern "C" int pbvd_traceback(const void* sp, const void* start, int T, int W, int B,
                              int log2n, int decode_start, int n_decode, void* bits,
                              void* stream) {
  if (log2n < 1 || log2n > 10 || B < 1 || decode_start < 0 || n_decode < 0 ||
      decode_start + n_decode > T || decode_start >= T || W != ((1 << log2n) + 31) / 32) {
    return 1000;
  }
  const int threads = 128;
  const int grid = (B + threads - 1) / threads;
  traceback_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sp), static_cast<const int*>(start), T, W, B, log2n,
      decode_start, n_decode, static_cast<int*>(bits));
  return static_cast<int>(cudaGetLastError());
}

// K2-prefix. sp, start, bits: as pbvd_traceback. C, P, n_chunks, c_lo,
// c_hi: prefix_chunk_geometry(T, decode_start, n_decode, tb_chunk). G:
// parallel blocks per CTA (G * N <= 1024). Returns cudaGetLastError() after
// the launch (or the error of raising the shared-memory limit); 1000 for a
// bad argument, 1001 for scratch that does not fit in shared memory.
extern "C" int pbvd_traceback_prefix(const void* sp, const void* start, int T, int W, int B,
                                     int log2n, int decode_start, int n_decode, int C, int P,
                                     int n_chunks, int c_lo, int c_hi, int G, void* bits,
                                     void* stream) {
  if (log2n < 1 || log2n > 10 || B < 1 || decode_start < 0 || n_decode < 1 ||
      decode_start + n_decode > T || W != ((1 << log2n) + 31) / 32 || C < 1 || P < 0 ||
      P >= C || n_chunks * C != T + P || c_lo < 0 || c_hi < c_lo || c_hi >= n_chunks ||
      G < 1 || (G << log2n) > 1024) {
    return 1000;
  }
  const int N = 1 << log2n;
  pbvd::PrefixGeometry geo{C, P, c_lo, n_chunks - c_lo, c_hi - c_lo + 1,
                           decode_start + P - c_lo * C, n_decode};
  const size_t smem = 4 * static_cast<size_t>(G) * (static_cast<size_t>(geo.n_act) * N + geo.nc_e);
  if (smem > kMaxSmem) return 1001;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        traceback_prefix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  traceback_prefix_kernel<<<(B + G - 1) / G, G * N, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sp), static_cast<const int*>(start), W, B, log2n, geo,
      static_cast<int*>(bits));
  return static_cast<int>(cudaGetLastError());
}
