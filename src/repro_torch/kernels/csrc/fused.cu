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
// Bodies. The ACS phase runs K1's bodies (acs_core.cuh). fused_warp_kernel
// runs the warp body (compile-time tables, a block's states in L = N/S
// lanes of one warp, S metrics per lane in registers, no barrier) for the
// three registered mother codes with the serial walk: one warp or part of
// one per CTA, G = 32/L blocks or fewer, lane = sub * G + g. With kK > 0 it
// runs the matrix warp body instead (acs_impl="matrix": k-stage (min,+)
// steps on the same layout, rows and metrics in registers; it replaces the
// TPU's _acs_phase_mat_dbuf for those codes, with register prefetch where
// the TPU double-buffers symbol tiles). After a __syncwarp, lane sub = 0 of
// each block walks its history (serial), or the CTA's lanes run the prefix
// walk on the warp layout (prefix, a run-time flag: prefix_tail_warp, one
// instantiation per W): sub-lane j of block g composes 32-state groups of
// the block's chunks, loading each row's W words once for its 32 chains
// (traceback_core.cuh's lane bodies, shared with K2-prefix), one lane per
// block walks the maps, and (decode chunk, block) pairs expand on the
// lanes. Every other code runs fused_table_kernel (the butterfly or the
// runtime-table matrix body) with either walk, the prefix walk there one
// thread per state (traceback_core.cuh::prefix_traceback): G = max(1,
// 128/N) blocks per CTA. The wrapper chooses the body and counts
// table-body launches apart (table_launches for the butterfly,
// matrix_table_launches for the matrix).
//
// History. Each stage's survivor words go to dynamic shared memory, T*W*4
// bytes per parallel block, laid out stage-major with the block fastest:
// word (t, w) of block g at hist[(t*W + w)*G + g]. The warp body's lanes
// are neighbouring blocks, so a warp's stores and the walkers' loads fall
// on distinct banks (at G = 16 and W = 2 the two words of a stage are 16
// banks apart); the table bodies store one word per warp and read it the
// same way, the serial walk with one thread per block, the prefix walks
// with neighbouring lanes on neighbouring blocks (warp bodies) or thread s
// of a block on state s (table bodies), stages below 0 reading as the zero
// pad. The window starts at ds_local = decode_start + P - c_lo * C, which
// is not word aligned, so a chunk's bits straddle words: the table bodies
// or each decoded bit into the window (atomicOr), the warp bodies' lanes
// gather a window word in a register and or it in once; the block then
// stores its n_decode/32 words.
//
// Shared-memory plan (kernels/fused.py::smem_plan), at CCSDS, T = 596:
// 4,768 B of history per parallel block (19,072 B at K = 9). The warp
// bodies need nothing else (metrics and rows are in registers, so the
// matrix warp body's G and residency are the serial warp path's); the planner takes the
// G (a power of two, at most 32/L) that keeps the most blocks resident on
// an SM of the H100 (233,472 B of shared memory, 1 KB reserved per CTA, at
// most 32 CTAs): at S = 32, G = 16 is 76,288 B per CTA, three CTAs and 48
// blocks (three warps) per SM, 6,336 of the 8,192 blocks of the main path
// at once. The table bodies add two path-metric planes and the min slots
// per block (plus, for the matrix body, its rows and decision planes); the
// prefix walk adds n_act*N + nc_e + n_decode/32 words per block, G-fastest
// on the warp bodies (576 + 9 + 16 at the main geometry: 7,172 B per
// block with the history, so G = 16 holds two CTAs, 32 blocks, two warps
// per SM, where the serial variant holds 48). Above 48
// KB the launch raises the kernel's dynamic shared-memory limit; the
// wrapper refuses a history that does not fit even at G = 1 (it never
// falls back to the two-kernel path).
//
// Symbols are read in their wire dtype from global memory and widened
// (and, in the narrow modes, clipped) after the load; the warp body fetches
// the next v stages into registers while it computes the current ones
// (the TPU kernel's radix-4 phase double-buffers 64-stage tiles into VMEM;
// a cp.async/TMA ring in shared memory is later work).
//
// Bound on the H100 80GB HBM3 (700 W limit). The kernel moves only the
// symbols in and the packed bits out: at CCSDS, T = 596, int8 symbols, 2.46
// bytes per decoded bit against K1+K2's 20.47, and does K1's ACS operations
// plus a handful per walked stage, so the integer issue rate bounds it
// (0.0769 ms at the main shapes). On the H100 80GB HBM3 (700 W) the table
// body took 1.455 ms there; the warp body, with no barrier and a fraction
// of its instructions per state, takes about a third of that at S = 32
// (chip_smoke.py phase 9; PERF.md keeps the times). Shared memory caps the
// resident histories at 48 blocks (three warps) per SM, so the 8,192
// blocks of the main path run in two waves and the kernel sits at about a
// sixth of its bound, where K1 sits at a third. The matrix warp body has the
// same bound (the function is the fused serial kernel's) and the same two
// waves: about 0.54 ms at k = 2 on the H100 80GB HBM3 (700 W), level with
// the butterfly, where the runtime-table matrix body took 1.98 ms (PERF.md).

#include "acs_core.cuh"
#include "traceback_core.cuh"

namespace {

using pbvd::forward_acs_matrix;
using pbvd::forward_acs_table;
using pbvd::forward_smem_slots;
using pbvd::matrix_smem_slots;

constexpr size_t kMaxSmem = 232448;      // per-CTA dynamic shared memory on the H100
constexpr size_t kDefaultSmem = 48 * 1024;

// The table bodies' slots (4 bytes each) before the histories. k = 0 for
// the butterfly.
__host__ __device__ inline int acs_slots(int G, int log2n, int k, int R) {
  return forward_smem_slots(G, log2n) + (k ? matrix_smem_slots(G, log2n, k, R) : 0);
}

// Bytes of shared memory per CTA: `slots` 4-byte ACS slots, then G
// histories of T * W words, then (prefix) G blocks of walk scratch of
// prefix_words each: n_act * N maps, nc_e entry states, n_decode / 32
// window words.
size_t fused_smem_bytes(int G, int slots, int log2n, int T, int prefix_words) {
  const int W = ((1 << log2n) + 31) >> 5;
  return 4 * (static_cast<size_t>(slots) + static_cast<size_t>(G) * T * W +
              static_cast<size_t>(G) * prefix_words);
}

// Phase 2 in prefix mode (table bodies): the prefix walk of parallel block
// g over its shared history (word (t, w) at hist_g[(t*W + w)*G]), thread
// s of the block on state s. Every thread of the CTA calls it. It is kept
// out of line: inlined into the kernel, it made every instantiation
// slower, the serial radix-2 path by ~40 % on the H100 (PERF.md),
// though ptxas counted no more registers.
__device__ __noinline__ void prefix_tail(const unsigned* hist_g, int G, int W, int B, int b,
                                         int log2n, int n_words, int* scratch,
                                         const int* __restrict__ start,
                                         const pbvd::PrefixGeometry& geo, int* __restrict__ bits) {
  const int N = 1 << log2n;
  const bool valid = b < B;
  const int s = threadIdx.x & (N - 1);
  int* maps = scratch;
  int* entry = maps + geo.n_act * N;
  unsigned* window = reinterpret_cast<unsigned*>(entry + geo.nc_e);
  for (int w = s; w < n_words; w += N) window[w] = 0u;  // phase A's barrier orders it
  auto sp_word = [&](int stage, unsigned w) -> unsigned {
    return stage < 0 ? 0u : hist_g[(static_cast<size_t>(stage) * W + w) * G];
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

// Phase 2 in prefix mode (warp bodies): the prefix walk of the CTA's G
// parallel blocks (G a power of two) over its shared history (word (t, w)
// of block g at hist[(t*W + w)*G + g]), on the nt = blockDim.x <= 32 lanes
// of its one warp: lane l is block g = l & (G - 1), sub-lane j = l / G (the
// warp body's own lane = sub * G + g). Scratch, G-fastest: maps[c][s][g],
// entry[ci][g], window[w][g]. A: sub-lane j of block g composes items j,
// j + L, ... of the block's n_act * N/32 (chunk, 32 states), loading each
// row's W words once per lane (W <= 4; above that in the chain); the lanes
// of a block read the same words (broadcast) and neighbouring blocks
// neighbouring banks. B: sub-lane 0 of each block walks its maps. C:
// (decode chunk, block) on lanes, block fastest; a lane gathers its chunk's
// bits in a register and ors each finished word into the window once
// (atomicOr: a chunk's first and last words may be shared with its
// neighbours), then the lanes store the window, G neighbouring b per word.
// Kept out of line, as prefix_tail.
template <int kW>
__device__ __noinline__ void prefix_tail_warp(const unsigned* hist, int G, int B, int b0,
                                              int log2n, int n_words, unsigned* scratch,
                                              const int* __restrict__ start,
                                              pbvd::PrefixGeometry geo, unsigned lanes,
                                              int* __restrict__ bits) {
  constexpr int kK = 32;  // chains per lane: N >= 64 for the warp bodies
  const int nt = blockDim.x, lane = threadIdx.x;
  const int log2g = __ffs(G) - 1;
  const int g = lane & (G - 1), j = lane >> log2g, L = nt >> log2g;
  const bool valid = b0 + g < B;
  const unsigned n_mask = (1u << log2n) - 1u;
  unsigned* maps = scratch;
  unsigned* entry = maps + (static_cast<size_t>(geo.n_act) << log2n) * G;
  unsigned* window = entry + geo.nc_e * G;
  for (int k = lane; k < n_words * G; k += nt) window[k] = 0u;

  // ---- A: compose --------------------------------------------------------------
  auto load_word = [&](int stage, unsigned w) -> unsigned {
    return ~(stage < 0 ? 0u : hist[(static_cast<size_t>(stage) * kW + w) * G + g]);
  };
  auto load_row = [&](int stage, unsigned (&rw)[kW]) {
#pragma unroll
    for (int k = 0; k < kW; ++k) rw[k] = load_word(stage, kW - 1 - k);
  };
  const int log2sg = log2n - 5;  // 32-state groups per chunk
  const int n_items = geo.n_act << log2sg;
  for (int i = j; valid && i < n_items; i += L) {
    const int c = i >> log2sg;
    const unsigned s0 = static_cast<unsigned>(i & ((1 << log2sg) - 1)) << 5;
    auto out = [&](int q, unsigned m) {
      maps[((static_cast<size_t>(c) << log2n) + s0 + q) * G + g] = m;
    };
    pbvd::compose_chains<kW, kK>(geo.C, (geo.c_lo + c) * geo.C - geo.P, s0, n_mask, load_row,
                                 load_word, out);
  }
  __syncwarp(lanes);

  // ---- B: walk the maps ----------------------------------------------------------
  if (j == 0 && valid) {
    unsigned state = static_cast<unsigned>(start[b0 + g]) & n_mask;
    for (int c = geo.n_act - 1; c >= 0; --c) {
      if (c < geo.nc_e) entry[c * G + g] = state;
      state = maps[((static_cast<size_t>(c) << log2n) + state) * G + g];
    }
  }
  __syncwarp(lanes);

  // ---- C: expand, a word of bits at a time -----------------------------------------
  for (int t = lane; t < (geo.nc_e << log2g); t += nt) {
    const int ci = t >> log2g, gt = t & (G - 1);
    if (b0 + gt >= B) continue;
    auto word = [&](int stage, unsigned w) -> unsigned {
      return ~(stage < 0 ? 0u : hist[(static_cast<size_t>(stage) * kW + w) * G + gt]);
    };
    auto row_words = [&](int stage, unsigned (&rw)[kW]) {
#pragma unroll
      for (int k = 0; k < kW; ++k) rw[k] = word(stage, kW - 1 - k);
    };
    const int idx0 = ci * geo.C - geo.ds_local;  // window position of row 0
    int cur = -1;                                // the window word being gathered
    unsigned acc = 0u;
    auto emit = [&](int row, unsigned bit) {
      const int idx = idx0 + row;
      if (idx < 0 || idx >= geo.n_window) return;
      if ((idx >> 5) != cur) {
        if (acc) atomicOr(&window[cur * G + gt], acc);
        cur = idx >> 5;
        acc = 0u;
      }
      acc |= bit << (idx & 31);
    };
    pbvd::expand_chain<kW>(geo.C, (geo.c_lo + ci) * geo.C - geo.P, entry[t], log2n, row_words,
                           word, emit);
    if (acc) atomicOr(&window[cur * G + gt], acc);
  }
  __syncwarp(lanes);
  for (int k = lane; k < n_words * G; k += nt) {
    const int gt = k & (G - 1);
    if (b0 + gt < B) bits[static_cast<size_t>(k >> log2g) * B + b0 + gt] = static_cast<int>(window[k]);
  }
}

// Phase 2 (serial) of parallel block b, by one thread: walk its history
// (word (t, w) at hist_g[(t*W + w)*G]) from the start state down to
// decode_start, packed bits out.
__device__ __forceinline__ void serial_walk(const unsigned* hist_g, int G, int T, int B, int b,
                                            int log2n, const int* __restrict__ start,
                                            int decode_start, int n_decode,
                                            int* __restrict__ bits) {
  const int N = 1 << log2n;
  const int W = (N + 31) >> 5;
  const int n_words = n_decode >> 5;
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
    const unsigned sw = hist_g[(static_cast<size_t>(st) * W + (state >> 5)) * G];
    state = ((state & half_mask) << 1) | ((sw >> (state & 31u)) & 1u);
  }
}

// The warp bodies with the serial walk: one warp (or part of one) per CTA,
// G = blockDim.x / L parallel blocks, lane = sub * G + g. kK = 0: the
// butterfly at kStagesPerStep; kK > 0: the matrix warp body's k-stage steps
// (int32 metrics, kStagesPerStep 1, kNarrow false: its narrow modes are
// norm_every > 0 and qmax > 0 at run time).
template <class Code, int kS, int kStagesPerStep, bool kNarrow, typename Acc, int kK = 0>
__global__ void fused_warp_kernel(const void* __restrict__ y, int dtype,
                                  const int* __restrict__ start, int T, int B, int norm_every,
                                  int qmax, int decode_start, int n_decode, int prefix,
                                  pbvd::PrefixGeometry geo, int* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned hist_smem[];
  constexpr int L = pbvd::WarpMap<Code, kS>::L;
  constexpr int W = Code::W;
  const int G = blockDim.x / L;
  const int sub = threadIdx.x / G;
  const int g = threadIdx.x % G;
  const int b = blockIdx.x * G + g;
  const bool valid = b < B;
  const unsigned lanes = blockDim.x >= 32 ? 0xffffffffu : ((1u << blockDim.x) - 1u);

  // ---- phase 1: forward ACS, survivor words into shared memory -------------
  auto store = [&](int t, int w, unsigned word, bool ok) {
    if (ok && valid) hist_smem[(static_cast<size_t>(t) * W + w) * G + g] = word;
  };
  auto no_pm = [](int, Acc) {};
  if constexpr (kK == 0) {
    auto load = [&](int t0, Acc (&dst)[Code::v][Code::R]) {
      pbvd::load_block<kNarrow>(y, dtype, t0, T, B, b, valid, qmax, dst);
    };
    pbvd::forward_acs_warp<Code, kS, kStagesPerStep, kNarrow, Acc>(T, norm_every, sub, G, lanes,
                                                                   load, store, no_pm);
  } else {
    constexpr int kLoad = pbvd::WarpMatrix<Code, kS, kK>::kLoad;
  auto load = [&](int t0, int (&dst)[kLoad][Code::R]) {  // narrow modes clip
      if (qmax) {
        pbvd::load_block<true>(y, dtype, t0, T, B, b, valid, qmax, dst);
      } else {
        pbvd::load_block<false>(y, dtype, t0, T, B, b, valid, qmax, dst);
      }
    };
    pbvd::forward_acs_matrix_warp<Code, kS, kK>(T, norm_every, sub, G, lanes, load, store,
                                                no_pm);
  }
  __syncwarp(lanes);  // a block's lanes are in one warp
  if (prefix) {  // ---- phase 2 (prefix): the CTA's chunked walks on its lanes
    prefix_tail_warp<W>(hist_smem, G, B, blockIdx.x * G, Code::v, n_decode >> 5,
                        hist_smem + static_cast<size_t>(G) * T * W, start, geo, lanes, bits);
  } else if (sub == 0 && valid) {  // ---- phase 2 (serial)
    serial_walk(hist_smem + g, G, T, B, b, Code::v, start, decode_start, n_decode, bits);
  }
}

// The table bodies. kMatrix: kStagesPerStep is the matrix k (integer
// symbols, Acc = int); otherwise 1 (radix 2) or 2 (radix 4).
template <int kStagesPerStep, bool kMatrix, bool kNarrow, typename Sym, typename Acc>
__global__ void fused_table_kernel(const Sym* __restrict__ y, const int* __restrict__ labels,
                                   const int* __restrict__ mtab, const int* __restrict__ start,
                                   int T, int R, int B, int log2n, int norm_every, int qmax,
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

  // ---- phase 1: forward ACS, survivor words into shared memory -------------
  auto store = [&](int t, int w, unsigned word) {
    hist[(static_cast<size_t>(t) * W + w) * G + g] = word;
  };
  // both end with a __syncthreads()
  if constexpr (kMatrix) {
    forward_acs_matrix<kStagesPerStep, kNarrow, Sym>(y, labels, mtab, T, R, B, log2n,
                                                     norm_every, qmax, acc_smem, store);
  } else {
    forward_acs_table<kStagesPerStep, kNarrow, Sym>(y, labels, T, R, B, log2n, norm_every, qmax,
                                                    acc_smem, store);
  }
  if (prefix) {  // ---- phase 2 (prefix): chunked walk of the shared history
    const int n_words = n_decode >> 5;
    int* scratch = reinterpret_cast<int*>(hist + static_cast<size_t>(G) * T * W) +
                   g * (geo.n_act * N + geo.nc_e + n_words);
    prefix_tail(hist + g, G, W, B, b, log2n, n_words, scratch, start, geo, bits);
  } else if ((threadIdx.x & (N - 1)) == 0 && b < B) {  // ---- phase 2 (serial)
    serial_walk(hist + g, G, T, B, b, log2n, start, decode_start, n_decode, bits);
  }
}

struct Launch {
  const void* y;
  int dtype;
  const int* labels;
  const int* mtab;
  const int* start;
  int T, R, B, log2n, norm_every, qmax, decode_start, n_decode, prefix, radix, k, S, G;
  pbvd::PrefixGeometry geo;
  int* bits;
  cudaStream_t stream;

  int prefix_words() const {
    return prefix ? geo.n_act * (1 << log2n) + geo.nc_e + (n_decode >> 5) : 0;
  }
};

template <typename Kernel>
int raise_smem_limit(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return 1001;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// ---- the warp body's launch ---------------------------------------------------

template <class Code, int kS, int kStagesPerStep, bool kNarrow, typename Acc, int kK = 0>
int launch_warp(const Launch& a) {
  constexpr int L = pbvd::WarpMap<Code, kS>::L;
  if ((a.G & (a.G - 1)) != 0 || a.G * L > 32) return 1000;
  const size_t smem = fused_smem_bytes(a.G, 0, a.log2n, a.T, a.prefix_words());
  auto kernel = fused_warp_kernel<Code, kS, kStagesPerStep, kNarrow, Acc, kK>;
  if (const int e = raise_smem_limit(kernel, smem)) return e;
  kernel<<<(a.B + a.G - 1) / a.G, a.G * L, smem, a.stream>>>(
      a.y, a.dtype, a.start, a.T, a.B, a.norm_every, a.qmax, a.decode_start, a.n_decode,
      a.prefix, a.geo, a.bits);
  return static_cast<int>(cudaGetLastError());
}

template <class Code, int kS, int kStagesPerStep>
int warp_mode(const Launch& a) {
  if (a.dtype == 3) {
    return a.norm_every > 0 ? 1000 : launch_warp<Code, kS, kStagesPerStep, false, float>(a);
  }
  return a.norm_every > 0 ? launch_warp<Code, kS, kStagesPerStep, true, int>(a)
                          : launch_warp<Code, kS, kStagesPerStep, false, int>(a);
}

template <class Code, int kS>
int warp_radix(const Launch& a) {
  return a.radix == 4 ? warp_mode<Code, kS, 2>(a) : warp_mode<Code, kS, 1>(a);
}

// the matrix warp body: its one S per (code, k), integer symbols
template <class Code, int kK>
int launch_matrix_warp(const Launch& a) {
  constexpr int S = pbvd::matrix_warp_states<Code>(kK);
  if (a.S != S || a.dtype == 3) return 1000;
  return launch_warp<Code, S, 1, false, int, kK>(a);
}

template <class Code>
int matrix_warp_k(const Launch& a) {
  switch (a.k) {
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

// the S variants, as K1's: 64, 32, 16 at N = 64; 64, 32 at N = 256; k > 0:
// the matrix warp body
template <class Code>
int warp_states(const Launch& a) {
  if (a.log2n != Code::v || a.R != Code::R) return 1000;
  if (a.k > 0) return matrix_warp_k<Code>(a);
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

// ---- the table bodies' launch -------------------------------------------------

template <int kStagesPerStep, bool kMatrix, bool kNarrow, typename Sym, typename Acc>
int launch(const Launch& a) {
  const int k = kMatrix ? kStagesPerStep : 0;
  const size_t smem = fused_smem_bytes(a.G, acs_slots(a.G, a.log2n, k, a.R), a.log2n, a.T,
                                       a.prefix_words());
  auto kernel = fused_table_kernel<kStagesPerStep, kMatrix, kNarrow, Sym, Acc>;
  if (const int e = raise_smem_limit(kernel, smem)) return e;
  kernel<<<(a.B + a.G - 1) / a.G, a.G << a.log2n, smem, a.stream>>>(
      static_cast<const Sym*>(a.y), a.labels, a.mtab, a.start, a.T, a.R, a.B, a.log2n,
      a.norm_every, a.qmax, a.decode_start, a.n_decode, a.prefix, a.geo, a.bits);
  return static_cast<int>(cudaGetLastError());
}

template <int kStagesPerStep, bool kMatrix, bool kNarrow>
int dispatch(const Launch& a) {
  switch (a.dtype) {
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
int dispatch_mode(const Launch& a) {
  return a.norm_every > 0 ? dispatch<kStagesPerStep, kMatrix, true>(a)
                          : dispatch<kStagesPerStep, kMatrix, false>(a);
}

}  // namespace

// y: (T, R, B) symbols, dtype 0 = int8, 1 = int16, 2 = int32, 3 = float32.
// labels: (N, 2) int32 even/odd predecessor labels (read by the table
// bodies); table: the matrix table of pbvd_acs_forward_matrix (read by the
// table body when k > 0); start: (B,) int32 start states. norm_every,
// qmax, radix: as pbvd_acs_forward; k: 0 for the butterfly at radix, else
// the matrix steps' k (1..4, integer symbols). prefix: 0 for the serial walk,
// 1 for the prefix walk with the geometry C, P, n_chunks, c_lo, c_hi of
// prefix_chunk_geometry(T, decode_start, min(n_decode, T - decode_start),
// tb_chunk), either walk on either body. code, S: as pbvd_acs_forward; 0
// for the table bodies; with k > 0 a code runs the matrix warp body at its
// one S for (code, k) (pbvd_acs_forward_matrix). G: parallel blocks per CTA: the
// table bodies run G * N <= 1024 threads, the warp body G * N/S <= 32 (G a
// power of two). bits: (n_decode / 32, B) int32 out. Requires
// 0 <= decode_start < T, n_decode a multiple of 32.
// Returns cudaGetLastError() after the launch (or the error of raising the
// shared-memory limit); 1000 for a bad argument, 1001 for a history (and
// scratch) that does not fit in shared memory.
extern "C" int pbvd_fused(const void* y, int dtype, int T, int R, int B, int log2n,
                          const void* labels, const void* table, const void* start,
                          int decode_start, int n_decode, int norm_every, int qmax, int radix,
                          int k, int prefix, int C, int P, int n_chunks, int c_lo, int c_hi,
                          int code, int S, int G, void* bits, void* stream) {
  const int n_window = n_decode < T - decode_start ? n_decode : T - decode_start;
  if (log2n < 1 || log2n > 10 || R < 1 || R > pbvd::kMaxR || T < 1 || B < 1 || G < 1 ||
      decode_start < 0 || decode_start >= T || n_decode < 32 || (n_decode & 31) ||
      norm_every < 0 || qmax < 0 || (norm_every > 0) != (qmax > 0) ||
      !(radix == 2 || (radix == 4 && log2n >= 2)) || k < 0 || k > 4 || k > log2n ||
      k * R > 8 || (k > 0 && code == pbvd::kCodeTable && table == nullptr) ||
      (prefix != 0 && prefix != 1) || dtype < 0 || dtype > 3 ||
      (code == pbvd::kCodeTable && (G << log2n) > 1024)) {
    return 1000;
  }
  if (prefix && (C < 1 || P < 0 || P >= C || n_chunks * C != T + P || c_lo < 0 ||
                 c_hi < c_lo || c_hi >= n_chunks ||
                 (decode_start + P + n_window - 1) / C != c_hi ||
                 (decode_start + P) / C != c_lo)) {
    return 1000;
  }
  Launch a{y, dtype, static_cast<const int*>(labels), static_cast<const int*>(table),
           static_cast<const int*>(start), T, R, B, log2n, norm_every, qmax, decode_start,
           n_decode, prefix, radix, k, S, G,
           pbvd::PrefixGeometry{C, P, c_lo, n_chunks - c_lo, c_hi - c_lo + 1,
                                decode_start + P - c_lo * C, n_window},
           static_cast<int*>(bits), static_cast<cudaStream_t>(stream)};
  switch (code) {
    case pbvd::kCodeTable: break;
    case pbvd::kCodeCcsds: return warp_states<pbvd::Ccsds>(a);
    case pbvd::kCodeIs95: return warp_states<pbvd::Is95>(a);
    case pbvd::kCodeLte: return warp_states<pbvd::Lte>(a);
    default: return 1000;
  }
  switch (k) {
    case 0: return radix == 4 ? dispatch_mode<2, false>(a) : dispatch_mode<1, false>(a);
    case 1: return dispatch_mode<1, true>(a);
    case 2: return dispatch_mode<2, true>(a);
    case 3: return dispatch_mode<3, true>(a);
    default: return dispatch_mode<4, true>(a);
  }
}

// The labels of the warp body's instantiation of code id `code`, as
// pbvd_acs_code_labels.
extern "C" int pbvd_fused_code_labels(int code, int* out) { return pbvd::code_labels(code, out); }

// The matrix table of the matrix warp body's instantiation of code id
// `code`, as pbvd_acs_code_matrix_table.
extern "C" int pbvd_fused_code_matrix_table(int code, int k, int* out) {
  return pbvd::code_matrix_table(code, k, out);
}
