// The chunked parallel-prefix traceback of the parallel block-based Viterbi
// decoder, shared by K2-prefix (traceback.cu, survivor words in global
// memory) and the fused kernel's prefix tail (fused.cu, survivor words in
// its shared history). One copy of the three phases keeps the two kernels
// bit-exact to each other and to the plain version
// (repro_torch/kernels/ref.py::traceback_prefix_chunked_ref), the port of
// repro/kernels/traceback.py::_prefix_traceback_phases.
//
// Geometry (prefix_chunk_geometry): the T stages get P virtual zero stages
// below stage 0 and are cut into chunks of C; chunk c covers padded stages
// [c*C, (c+1)*C), so its row `row` is stage c*C + row - P. Chunks below
// c_lo feed nothing, chunks c_lo .. c_hi hold the decode window, chunks
// above c_hi are composed and walked but not expanded.
//
// Layout. One parallel block per N threads (thread s <-> state s), G blocks
// per CTA, as the ACS loop. sp_word(stage, w) returns the survivor word;
// it must return 0 for stage < 0, the virtual pad, so neither kernel
// re-lays out its history. Unpacking takes an unsigned shift and & 1, so
// bit 31 (the int32 sign bit) reads as any other.
//
// A, compose: thread s composes the maps of state s in every active chunk,
// top down, kComposeBatch chunks at a time in registers (independent
// chains whose word loads overlap), into maps[n_act][N] in shared memory.
// B, walk: one thread per block walks the n_act composed maps from the
// start state (the only serial chain, n_act shared loads) and records the
// entry state of each decode chunk. C, expand: one thread per decode chunk
// re-walks its C stages and hands each decoded bit to emit(idx, bit),
// idx = the bit's position in the decode window, 0 <= idx < n_window.

#pragma once

#include <cuda_runtime.h>

namespace pbvd {

struct PrefixGeometry {
  int C;         // stages per chunk
  int P;         // virtual zero stages below stage 0
  int c_lo;      // first chunk that holds decode-window stages
  int n_act;     // active chunks: n_chunks - c_lo
  int nc_e;      // chunks to expand: c_hi - c_lo + 1
  int ds_local;  // the window's first stage, counted from chunk c_lo's start
  int n_window;  // decoded bits that exist
};

constexpr int kComposeBatch = 4;

// Every thread of the CTA must call it (it holds barriers). maps holds
// n_act * N ints and entry nc_e ints of this thread's block; valid is
// false for the padding blocks of the last CTA, whose start state and
// words are never read by phases B and C.
template <typename SpWord, typename Emit>
__device__ __forceinline__ void prefix_traceback(const PrefixGeometry& geo, int log2n, bool valid,
                                                 unsigned start, int* maps, int* entry,
                                                 SpWord sp_word, Emit emit) {
  const int N = 1 << log2n;
  const unsigned s = threadIdx.x & (N - 1);
  const unsigned n_mask = static_cast<unsigned>(N) - 1u;
  const unsigned half_mask = n_mask >> 1;

  // ---- A: compose, thread s over every active chunk's state s ------------
  for (int c0 = 0; c0 < geo.n_act; c0 += kComposeBatch) {
    unsigned h[kComposeBatch];
#pragma unroll
    for (int q = 0; q < kComposeBatch; ++q) h[q] = s;
    for (int row = geo.C - 1; row >= 0; --row) {
#pragma unroll
      for (int q = 0; q < kComposeBatch; ++q) {
        if (c0 + q < geo.n_act) {
          const unsigned word = sp_word((geo.c_lo + c0 + q) * geo.C + row - geo.P, h[q] >> 5);
          h[q] = ((h[q] & half_mask) << 1) | ((word >> (h[q] & 31u)) & 1u);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kComposeBatch; ++q) {
      if (c0 + q < geo.n_act) maps[(c0 + q) * N + s] = static_cast<int>(h[q]);
    }
  }
  __syncthreads();

  // ---- B: walk the composed maps, record the decode chunks' entries ------
  if (s == 0 && valid) {
    unsigned state = start & n_mask;  // the mask keeps the reads in bounds
    for (int c = geo.n_act - 1; c >= 0; --c) {
      if (c < geo.nc_e) entry[c] = static_cast<int>(state);  // state at chunk c's top
      state = static_cast<unsigned>(maps[c * N + state]);
    }
  }
  __syncthreads();

  // ---- C: expand the decode chunks, one thread each ----------------------
  if (!valid) return;
  for (int ci = static_cast<int>(s); ci < geo.nc_e; ci += N) {
    unsigned state = static_cast<unsigned>(entry[ci]);
    for (int row = geo.C - 1;; --row) {
      const int idx = ci * geo.C + row - geo.ds_local;
      if (idx >= 0 && idx < geo.n_window) emit(idx, state >> (log2n - 1));
      if (row == 0) break;
      const unsigned word = sp_word((geo.c_lo + ci) * geo.C + row - geo.P, state >> 5);
      state = ((state & half_mask) << 1) | ((word >> (state & 31u)) & 1u);
    }
  }
}

}  // namespace pbvd
