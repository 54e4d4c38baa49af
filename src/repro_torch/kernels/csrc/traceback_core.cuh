// The chunked parallel-prefix traceback of the parallel block-based Viterbi
// decoder: the port of repro/kernels/traceback.py::_prefix_traceback_phases,
// bit-exact to the plain version
// (repro_torch/kernels/ref.py::traceback_prefix_chunked_ref). Two layouts
// share the geometry and the chain arithmetic below:
//
// 1. The lane bodies (compose_chains, expand_chain): K2-prefix
//    (traceback.cu, lanes on parallel blocks, words from global memory) and
//    the fused kernel's prefix tail on the warp bodies (fused.cu, words from
//    its shared history). The TPU kernel's own layout: every chain of one
//    (block, chunk) reads the same W words at a row, so a thread holds
//    kK chains (states) of one (block, chunk), loads the row's W words
//    once, at addresses known in advance and independent of the chains, and
//    steps every chain with a select and two funnel shifts; no load sits
//    in a chain for W <= 4. Above that the chain loads the word its state
//    selects, as K2's staged walk does.
// 2. prefix_traceback, the thread-per-state body (one parallel block per N
//    threads, thread s <-> state s), kept for the fused kernel's
//    runtime-table bodies (codes other than the three mother codes).
//
// Geometry (prefix_chunk_geometry): the T stages get P virtual zero stages
// below stage 0 and are cut into chunks of C; chunk c covers padded stages
// [c*C, (c+1)*C), so its row `row` is stage c*C + row - P. Chunks below
// c_lo feed nothing, chunks c_lo .. c_hi hold the decode window, chunks
// above c_hi are composed and walked but not expanded. A stage below 0
// reads as the zero pad, so neither kernel re-lays out its history.
//
// A, compose: each active chunk's map, the state at the chunk's bottom
// reached from each state at its top, over its C rows top down. B, walk:
// one thread per block walks the n_act composed maps from the start state
// (the only serial chain, n_act loads) and records the entry state of each
// decode chunk. C, expand: one thread per (block, decode chunk) re-walks its
// C stages and emits each decoded bit at idx = its position in the decode
// window, 0 <= idx < n_window.

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

// ---- the lane bodies' chain arithmetic --------------------------------------
//
// A chain carries u = ~h, the complement of the walked state h, and the
// rows' words arrive complemented and in reverse order (rw[k] = ~word[W-1-k]),
// so that one step is: pick x = ~word[h >> 5] by the bits of u (for W <= 4
// a select on bits 5 and 6), rotate x left by u & 31 = 31 - (h & 31) (bit
// h & 31 of ~word lands on bit 31), and shift that bit into u from below:
// u' = (u << 1) | (x' >> 31) = ~((h << 1) | bit), two funnel shifts. Bits of
// u at and above v carry garbage, which the walk never reads (the select
// reads bits 5 .. 4 + log2 W < v), except at W = 1, where N <= 32 and the
// rotation reads bits up to 4: there every step ors in ~(N - 1).

constexpr int kLaneDepth = 4;

__host__ __device__ constexpr int log2_exact(int x) { return x <= 1 ? 0 : 1 + log2_exact(x >> 1); }  // rows whose words are loaded ahead of the chains

template <int kW>
__device__ __forceinline__ unsigned pick_word(const unsigned (&rw)[kW], unsigned u) {
  static_assert(kW == 1 || kW == 2 || kW == 4, "the select holds W <= 4 words");
  if constexpr (kW == 1) {
    return rw[0];
  } else if constexpr (kW == 2) {
    return u & 32u ? rw[1] : rw[0];
  } else {
    const unsigned lo = u & 32u ? rw[1] : rw[0], hi = u & 32u ? rw[3] : rw[2];
    return u & 64u ? hi : lo;
  }
}

// One step of a complemented chain through the complemented word x of its
// state; hi_ones = ~(N - 1) at W = 1, else 0.
__device__ __forceinline__ unsigned chain_step(unsigned u, unsigned x, unsigned hi_ones) {
  const unsigned r = __funnelshift_l(x, x, u);
  return __funnelshift_l(r, u, 1) | hi_ones;
}

// The word index of the complemented state u at W > 4 words per stage.
template <int kW>
__device__ __forceinline__ unsigned word_of(unsigned u) {
  return (~u >> 5) & static_cast<unsigned>(kW - 1);
}

// Phase A of one (block, chunk) for the kK states s0 .. s0 + kK - 1: the C
// rows of the chunk, whose row `row` is stage stage0 + row, top down.
//   load_row(stage, rw): the stage's W words, complemented and reversed
//     (zero pad below stage 0), for kW <= 4; the loads of a row are issued
//     kLaneDepth rows ahead of its use;
//   load_word(stage, w): ~word w of the stage, for kW > 4 (in the chain);
//   out(q, map): the composed map of state s0 + q.
template <int kW, int kK, typename LoadRow, typename LoadWord, typename Out>
__device__ __forceinline__ void compose_chains(int C, int stage0, unsigned s0, unsigned n_mask,
                                               LoadRow load_row, LoadWord load_word, Out out) {
  const unsigned hi_ones = kW == 1 ? ~n_mask : 0u;
  unsigned u[kK];
#pragma unroll
  for (int q = 0; q < kK; ++q) u[q] = ~(s0 + q);
  if constexpr (kW <= 4) {
    unsigned buf[kLaneDepth][kW];
#pragma unroll
    for (int d = 0; d < kLaneDepth; ++d) {
      if (C - 1 - d >= 0) load_row(stage0 + C - 1 - d, buf[d]);
    }
    for (int r0 = C - 1; r0 >= 0; r0 -= kLaneDepth) {
#pragma unroll
      for (int d = 0; d < kLaneDepth; ++d) {
        const int row = r0 - d;
        if (row >= 0) {
#pragma unroll
          for (int q = 0; q < kK; ++q) u[q] = chain_step(u[q], pick_word<kW>(buf[d], u[q]), hi_ones);
          if (row - kLaneDepth >= 0) load_row(stage0 + row - kLaneDepth, buf[d]);
        }
      }
    }
  } else {
    for (int row = C - 1; row >= 0; --row) {
#pragma unroll
      for (int q = 0; q < kK; ++q) u[q] = chain_step(u[q], load_word(stage0 + row, word_of<kW>(u[q])), 0u);
    }
  }
#pragma unroll
  for (int q = 0; q < kK; ++q) out(q, ~u[q] & n_mask);
}

// Phase C of one (block, decode chunk) from its entry state h: emit(row,
// bit) for rows C-1 .. 0 (the caller maps a row to its window position and
// drops those outside), stepping through rows C-1 .. 1 (stage stage0 + row),
// with the loaders of compose_chains.
template <int kW, typename LoadRow, typename LoadWord, typename Emit>
__device__ __forceinline__ void expand_chain(int C, int stage0, unsigned h, int log2n,
                                             LoadRow load_row, LoadWord load_word, Emit emit) {
  const unsigned n_mask = (1u << log2n) - 1u;
  const unsigned hi_ones = kW == 1 ? ~n_mask : 0u;
  unsigned u = ~h;
  if constexpr (kW <= 4) {
    unsigned buf[kLaneDepth][kW];
#pragma unroll
    for (int d = 0; d < kLaneDepth; ++d) {
      if (C - 1 - d >= 1) load_row(stage0 + C - 1 - d, buf[d]);
    }
    for (int r0 = C - 1; r0 >= 0; r0 -= kLaneDepth) {
#pragma unroll
      for (int d = 0; d < kLaneDepth; ++d) {
        const int row = r0 - d;
        if (row >= 0) {
          emit(row, (~u >> (log2n - 1)) & 1u);
          if (row >= 1) {
            u = chain_step(u, pick_word<kW>(buf[d], u), hi_ones);
            if (row - kLaneDepth >= 1) load_row(stage0 + row - kLaneDepth, buf[d]);
          }
        }
      }
    }
  } else {
    for (int row = C - 1;; --row) {
      emit(row, (~u >> (log2n - 1)) & 1u);
      if (row == 0) break;
      u = chain_step(u, load_word(stage0 + row, word_of<kW>(u)), 0u);
    }
  }
}

// ---- the thread-per-state body ------------------------------------------------
//
// One parallel block per N threads (thread s <-> state s), G blocks per CTA.
// sp_word(stage, w) returns the survivor word (0 below stage 0). A: thread
// s composes the maps of state s in every active chunk, kComposeBatch chunks
// at a time in registers (independent chains whose word loads overlap),
// into maps[n_act][N]. B: one thread per block walks the composed maps. C:
// one thread per decode chunk re-walks its C stages and hands each decoded
// bit to emit(idx, bit).

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
