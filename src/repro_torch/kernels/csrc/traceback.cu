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

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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
