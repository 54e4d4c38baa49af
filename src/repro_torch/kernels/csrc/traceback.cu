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
// Design: a staged walk. One warp walks 32 consecutive parallel blocks, one
// per lane, as the paper's one thread per block. A walker no longer loads
// the one word its state selects, whose address depends on the previous
// load: the stage slabs sp[s][0..W)[b0..b0+32) (W rows of 128 contiguous
// bytes) of a chunk of kChunk stages are copied into a ring of kSlots
// shared-memory slots, and while the next kSlots - 1 chunks are in flight
// the lanes walk the current one from shared memory. This is the TPU
// kernel's own choice (it fetched all W words of a stage and selected,
// repro/kernels/traceback.py:68-112); here it turns the chain of dependent
// global loads into independent, coalesced, asynchronous copies. For W <= 4
// a lane also reads all W words of a stage and selects, so no shared load
// sits in the dependent chain either; above that it reads word state >> 5.
// kChunk = 64 / W keeps a slot at 8 KB for every W = 1 ... 32; four slots
// keep 24 KB in flight per warp, about what the HBM latency needs with the
// two warps per SM of the main path (8192 blocks). Stages at or below
// decode_start are never copied. Two routes copy the slabs:
// - TMA (traceback_tma_kernel), where B % 4 == 0 (a tensor map's row stride
//   must be a multiple of 16 bytes): one lane issues one bulk tensor copy of
//   a (32 blocks, W, kChunk) box per chunk, completing on the slot's
//   mbarrier; lanes past B read zeros and store nothing;
// - cp.async (traceback_staged_kernel), any B: each lane copies its own
//   block's W words of each stage (a row of the slab is one coalesced
//   128-byte request) and reads only what it copied, so no barrier is
//   needed; lanes past B exit at once.
// TMA was the faster on the H100 at every W measured (PERF.md), so it is
// taken wherever B allows it. repro_torch/kernels/traceback.py::stage_chunk
// and tests/test_torch_k2.py's numpy model hold the same geometry.
//
// Bound on the H100. The function moves 4 bytes in per walked stage (the
// word the walk selects) and 4 bytes out per decoded bit, 0.0104 ms at the
// main shapes; this algorithm copies all W words of every walked stage,
// about 53 MB there (0.0158 ms at 3.35 TB/s). With only 256 warps in all,
// the walk's chain (a select, a shift and two logic operations per stage,
// or a shared load at W > 4) should set the time, near the copy's.
//
// K2-prefix (pbvd_traceback_prefix) replaces the TPU kernel
// repro/kernels/traceback.py::_traceback_prefix_kernel (driven by
// traceback_prefix_pallas): the same bits from the chunked parallel-prefix
// walk (traceback_core.cuh: compose the active chunks' maps, walk them,
// expand the decode chunks). The longest dependent chain drops from
// T - 1 - decode_start steps to about C (compose) + n_act (walk) + C
// (expand), 137 at the main geometry against K2's 553, for n_act * N * C
// composed steps per block instead of 553: operations, not bytes or
// latency, bound it (the algorithm's own floor, 0.1100 ms at the main
// shapes on the H100 80GB HBM3, 700 W).
//
// Design: lanes on blocks, the TPU kernel's own layout. Neighbouring lanes
// hold neighbouring parallel blocks, so a row's W words for a warp's 32
// blocks are W coalesced 128-byte rows; the warps of a CTA and 32 chains
// per thread (K = min(N, 32) states of one (block, chunk)) split the N
// states and the chunks. A thread loads a row's W words once, kLaneDepth
// rows ahead, at addresses that do not depend on the chains, and steps its
// K chains with a select and two funnel shifts each; no load sits in a
// chain for W <= 4 (above that the chain loads the word its state selects,
// through the read-only cache). The maps live in shared memory as
// [c][s][Gb], so the Gb lanes of phase B and the stores of phase A fall on
// distinct banks; phase C puts (decode chunk, block) on threads, block
// fastest, reading coalesced rows and storing coalesced bits. A CTA holds
// Gb = 32 blocks where their maps fit, else the largest power of two that
// fits down to 1 (traceback.py::prefix_smem_plan: every geometry whose
// maps fit at one block is taken), and fewer where the batch is too small
// to give every SM a CTA (traceback.py::prefix_plan): a CTA's composition
// runs on one SM, so 32 blocks in one CTA took 0.078 ms of device time
// where K2 took 0.028 ms on the H100 80GB HBM3 (700 W). Staging the words
// through shared memory by cp.async instead of loading them into
// registers ran no faster there (PERF.md), so the loads stay direct.

#include <cstdint>
#include <cuda.h>
#include <cuda_runtime.h>

#include "tma.cuh"
#include "traceback_core.cuh"

namespace {

constexpr size_t kMaxSmem = 232448;  // per-CTA dynamic shared memory on the H100
constexpr size_t kDefaultSmem = 48 * 1024;

constexpr int kSlots = 4;           // the ring: kSlots - 1 chunks in flight while one is walked
constexpr int kSlotWords = 64 * 32;  // 8 KB: kChunk * W rows of 32 words

constexpr int kPrefixMaxWarps = 16;  // K2-prefix: warps per CTA, at most

__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One step of the walk from stage s to s - 1: the predecessor of `state`
// through the stage's W words in shared memory (this lane's column of the
// slab). At W <= 4 the lane reads every word and selects with bit tests, so
// no shared load sits in the chain (a select loop over an array let the
// compiler index the array in local memory instead).
template <int kW>
__device__ __forceinline__ unsigned walk_stage(const int (&words)[kW][32], int lane,
                                               unsigned state, unsigned half_mask) {
  unsigned word;
  if constexpr (kW == 1) {
    word = static_cast<unsigned>(words[0][lane]);
  } else if constexpr (kW == 2) {
    const unsigned w0 = words[0][lane], w1 = words[1][lane];
    word = state & 32u ? w1 : w0;
  } else if constexpr (kW == 4) {
    const unsigned w0 = words[0][lane], w1 = words[1][lane];
    const unsigned w2 = words[2][lane], w3 = words[3][lane];
    const unsigned lo = state & 32u ? w1 : w0, hi = state & 32u ? w3 : w2;
    word = state & 64u ? hi : lo;
  } else {
    word = static_cast<unsigned>(words[state >> 5][lane]);
  }
  return ((state & half_mask) << 1) | ((word >> (state & 31u)) & 1u);
}

// The staged walk with W = kW words per stage (kW = 1, 2, 4, ..., 32), the
// slabs copied by the lanes themselves with cp.async: any B.
template <int kW>
__global__ void __launch_bounds__(32)
    traceback_staged_kernel(const int* __restrict__ sp, const int* __restrict__ start, int T,
                            int B, int log2n, int decode_start, int n_decode,
                            int* __restrict__ bits) {
  constexpr int kChunk = kSlotWords / (32 * kW);  // stages per slot
  __shared__ int ring[kSlots][kChunk][kW][32];
  const int lane = threadIdx.x;
  const int b = blockIdx.x * 32 + lane;
  if (b >= B) return;  // the ragged last warp: nothing copied, walked or stored
  const unsigned n_mask = (1u << log2n) - 1u;
  const unsigned half_mask = n_mask >> 1;
  const int top = T - 1;
  const int n_walk = top - decode_start;  // stages whose words the walk reads
  const int n_chunks = (n_walk + kChunk - 1) / kChunk;
  const int emit_end = decode_start + n_decode;

  // chunk c holds stages top - c*kChunk - j, j = 0 .. kChunk-1, above decode_start
  auto issue = [&](int c) {
    if (c < n_chunks) {
      int(*slot)[kW][32] = ring[c % kSlots];
      const int s_hi = top - c * kChunk;
      const int len = min(kChunk, s_hi - decode_start);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if (j < len) {
          const int* src = sp + static_cast<size_t>(s_hi - j) * kW * B + b;
#pragma unroll
          for (int w = 0; w < kW; ++w) cp_async4(&slot[j][w][lane], src + static_cast<size_t>(w) * B);
        }
      }
    }
    cp_async_commit();  // an empty group past the last chunk keeps the count
  };
#pragma unroll
  for (int c = 0; c < kSlots - 1; ++c) issue(c);

  // start states are in [0, N) by contract; the mask keeps the reads in
  // bounds whatever the caller passes
  unsigned state = static_cast<unsigned>(start[b]) & n_mask;
  long long out = static_cast<long long>(top - decode_start) * B + b;  // bits of the walked stage
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kSlots - 1);
    cp_async_wait<kSlots - 1>();  // chunk c has landed (this lane's copies)
    const int(*slot)[kW][32] = ring[c % kSlots];
    const int s_hi = top - c * kChunk;
    const int len = min(kChunk, s_hi - decode_start);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < len) {
        if (s_hi - j < emit_end) bits[out] = static_cast<int>(state >> (log2n - 1));
        out -= B;
        state = walk_stage<kW>(slot[j], lane, state, half_mask);
      }
    }
  }
  cp_async_wait<0>();  // leave no copy in flight at exit
  bits[b] = static_cast<int>(state >> (log2n - 1));  // stage decode_start
}

// The same walk with each slab chunk copied by one TMA load of a box (32
// blocks, W words, kChunk stages) of the tensor (B, W, T), completing on the
// slot's mbarrier: B % 4 == 0 (the map's row stride is a multiple of 16
// bytes). Chunks are cut from decode_start + 1 upwards, so the top one may
// reach past stage T - 1: those rows, and the lanes past B, are out of
// bounds and read as zeros; no stage at or below decode_start is copied.
template <int kW>
__global__ void __launch_bounds__(32)
    traceback_tma_kernel(const __grid_constant__ CUtensorMap tm, const int* __restrict__ start,
                         int T, int B, int log2n, int decode_start, int n_decode,
                         int* __restrict__ bits) {
  constexpr int kChunk = kSlotWords / (32 * kW);
  __shared__ __align__(128) int ring[kSlots][kChunk][kW][32];
  __shared__ uint64_t full[kSlots];
  const int lane = threadIdx.x;
  const int b0 = blockIdx.x * 32, b = b0 + lane;
  const bool valid = b < B;  // lanes past B walk zeros and store nothing
  const unsigned n_mask = (1u << log2n) - 1u;
  const unsigned half_mask = n_mask >> 1;
  const int lo = decode_start + 1;  // the lowest stage the walk reads
  const int n_chunks = (T - lo + kChunk - 1) / kChunk;
  const int emit_end = decode_start + n_decode;
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < kSlots; ++s) pbvd::mbar_init(&full[s], 1);
    pbvd::mbar_init_fence();
  }
  __syncwarp();
  // chunk c (c = 0 the top) holds stages lo + (n_chunks - 1 - c) * kChunk + j
  auto issue = [&](int c) {
    if (lane == 0 && c < n_chunks) {
      pbvd::mbar_expect_tx(&full[c % kSlots], kSlotWords * 4);
      pbvd::tma_load_3d(ring[c % kSlots], &tm, &full[c % kSlots], b0, 0,
                        lo + (n_chunks - 1 - c) * kChunk);
    }
  };
#pragma unroll
  for (int c = 0; c < kSlots - 1; ++c) issue(c);

  unsigned state = valid ? static_cast<unsigned>(start[b]) & n_mask : 0u;
  long long out = static_cast<long long>(T - 1 - decode_start) * B + b;  // bits of the walked stage
  for (int c = 0; c < n_chunks; ++c) {
    issue(c + kSlots - 1);  // into the slot of chunk c - 1, which every lane has walked
    pbvd::mbar_wait(&full[c % kSlots], (c / kSlots) & 1);
    const int(*slot)[kW][32] = ring[c % kSlots];
    const int s_lo = lo + (n_chunks - 1 - c) * kChunk;
    const int j_top = min(kChunk - 1, T - 1 - s_lo);
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      if (j <= j_top) {
        if (valid && s_lo + j < emit_end) bits[out] = static_cast<int>(state >> (log2n - 1));
        out -= B;
        state = walk_stage<kW>(slot[j], lane, state, half_mask);
      }
    }
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
  if (valid) bits[b] = static_cast<int>(state >> (log2n - 1));  // stage decode_start
}

// The TMA map of sp (T, W, B) int32 as the 3-D tensor (B, W, T), innermost
// first, box (32, W, kChunk). 0, or 1002 when it cannot be made.
int make_sp_map(CUtensorMap* map, const void* sp, int T, int W, int B) {
  const pbvd::EncodeTiledFn encode = pbvd::tensor_map_encoder();
  if (encode == nullptr) return 1002;
  const cuuint64_t dims[3] = {(cuuint64_t)B, (cuuint64_t)W, (cuuint64_t)T};
  const cuuint64_t strides[2] = {(cuuint64_t)B * 4, (cuuint64_t)W * B * 4};
  const cuuint32_t box[3] = {32, (cuuint32_t)W, (cuuint32_t)(kSlotWords / (32 * W))};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<void*>(sp), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1002;
}

// K2-prefix with lanes on blocks (see the header). A CTA holds Gb = 2^log2g
// parallel blocks (Gb <= 32) and nw warps; lane l of a warp is block
// l & (Gb - 1), sub-lane j = l >> log2g. The work of a block in phase A is
// n_act * N / kK items (chunk c, state group), item i = (c, i mod N/kK);
// sub-lane j of warp w takes items j + (32/Gb) * (w + nw * r). Maps are
// [c][s][Gb] in shared memory, entries [ci][Gb]: a warp's loads in phase
// B (Gb lanes, one block each) and stores in phase A fall on distinct banks.
template <int kW, int kK>
__global__ void __launch_bounds__(kPrefixMaxWarps * 32)
    traceback_prefix_lanes_kernel(const int* __restrict__ sp, const int* __restrict__ start,
                                  int B, int log2n, int log2g, pbvd::PrefixGeometry geo,
                                  int* __restrict__ bits) {
  extern __shared__ __align__(16) unsigned smem_u[];
  const int N = 1 << log2n, Gb = 1 << log2g;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int blk = lane & (Gb - 1), J = 32 >> log2g, j = lane >> log2g;
  const int b = blockIdx.x * Gb + blk;
  const bool valid = b < B;
  const unsigned n_mask = static_cast<unsigned>(N) - 1u;
  unsigned* maps = smem_u;                                         // [n_act][N][Gb]
  unsigned* entry = maps + static_cast<size_t>(geo.n_act) * N * Gb;  // [nc_e][Gb]
  const size_t row_words = static_cast<size_t>(kW) * B;

  // ---- A: compose; the loaders of block b (words past B never read) -------
  constexpr int log2k = pbvd::log2_exact(kK);
  const int log2sg = log2n - log2k;  // state groups per chunk: N / kK
  const int n_items = geo.n_act << log2sg;
  auto load_word = [&](int stage, unsigned w) -> unsigned {
    return ~(stage < 0 ? 0u : static_cast<unsigned>(__ldg(sp + stage * row_words + w * B + b)));
  };
  for (int i = j + J * warp; valid && i < n_items; i += J * nw) {
    const int c = i >> log2sg;
    const unsigned s0 = static_cast<unsigned>(i & ((1 << log2sg) - 1)) << log2k;
    const int stage0 = (geo.c_lo + c) * geo.C - geo.P;
    auto out = [&](int q, unsigned m) {
      maps[((static_cast<size_t>(c) << log2n) + s0 + q) * Gb + blk] = m;
    };
    auto load_row = [&](int stage, unsigned (&rw)[kW]) {
#pragma unroll
      for (int k = 0; k < kW; ++k) rw[k] = load_word(stage, kW - 1 - k);
    };
    pbvd::compose_chains<kW, kK>(geo.C, stage0, s0, n_mask, load_row, load_word, out);
  }
  __syncthreads();

  // ---- B: one thread per block walks the maps -----------------------------
  if (threadIdx.x < Gb && valid) {
    unsigned state = static_cast<unsigned>(start[b]) & n_mask;
    for (int c = geo.n_act - 1; c >= 0; --c) {
      if (c < geo.nc_e) entry[c * Gb + blk] = state;
      state = maps[((static_cast<size_t>(c) << log2n) + state) * Gb + blk];
    }
  }
  __syncthreads();

  // ---- C: (decode chunk, block) on threads, block fastest -----------------
  for (int t = threadIdx.x; t < (geo.nc_e << log2g); t += blockDim.x) {
    const int ci = t >> log2g, bt = blockIdx.x * Gb + (t & (Gb - 1));
    if (bt >= B) continue;
    auto word = [&](int stage, unsigned w) -> unsigned {
      return ~(stage < 0 ? 0u : static_cast<unsigned>(__ldg(sp + stage * row_words + w * B + bt)));
    };
    auto load_row = [&](int stage, unsigned (&rw)[kW]) {
#pragma unroll
      for (int k = 0; k < kW; ++k) rw[k] = word(stage, kW - 1 - k);
    };
    const int idx0 = ci * geo.C - geo.ds_local;  // window position of row 0
    auto emit = [&](int row, unsigned bit) {
      const int idx = idx0 + row;
      if (idx >= 0 && idx < geo.n_window) bits[static_cast<size_t>(idx) * B + bt] = static_cast<int>(bit);
    };
    pbvd::expand_chain<kW>(geo.C, (geo.c_lo + ci) * geo.C - geo.P, entry[t], log2n, load_row,
                           word, emit);
  }
}

}  // namespace

// sp: (T, W, B) int32 packed survivor words; start: (B,) int32 start states.
// bits: (n_decode, B) int32 out. Requires 0 <= decode_start,
// decode_start + n_decode <= T, n_decode >= 1, 1 <= log2n <= 10, B >= 1.
// copy: 0 chooses (TMA when B % 4 == 0, else cp.async), 1 cp.async, 2 TMA.
// Returns cudaGetLastError() after the launch; 1000 for a bad argument, 1002
// when the TMA map cannot be made.
extern "C" int pbvd_traceback_copy(const void* sp, const void* start, int T, int W, int B,
                                   int log2n, int decode_start, int n_decode, int copy,
                                   void* bits, void* stream) {
  if (log2n < 1 || log2n > 10 || B < 1 || decode_start < 0 || n_decode < 1 ||
      decode_start + n_decode > T || W != ((1 << log2n) + 31) / 32 || copy < 0 || copy > 2 ||
      (copy == 2 && B % 4)) {
    return 1000;
  }
  const bool tma = copy == 2 || (copy == 0 && B % 4 == 0);
  CUtensorMap tm;
  if (tma && make_sp_map(&tm, sp, T, W, B)) return 1002;
  const dim3 grid((B + 31) / 32);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp_i = static_cast<const int*>(sp);
  const int* start_i = static_cast<const int*>(start);
  int* bits_i = static_cast<int*>(bits);
  switch (W) {
#define PBVD_K2(KW)                                                                          \
  case KW:                                                                                   \
    if (tma) {                                                                               \
      traceback_tma_kernel<KW><<<grid, 32, 0, st>>>(tm, start_i, T, B, log2n, decode_start,  \
                                                    n_decode, bits_i);                       \
    } else {                                                                                 \
      traceback_staged_kernel<KW><<<grid, 32, 0, st>>>(sp_i, start_i, T, B, log2n,           \
                                                       decode_start, n_decode, bits_i);      \
    }                                                                                        \
    break;
    PBVD_K2(1)
    PBVD_K2(2)
    PBVD_K2(4)
    PBVD_K2(8)
    PBVD_K2(16)
    PBVD_K2(32)
#undef PBVD_K2
    default: return 1000;
  }
  return static_cast<int>(cudaGetLastError());
}

// K2 with the copy route chosen: pbvd_traceback_copy(..., copy = 0, ...).
extern "C" int pbvd_traceback(const void* sp, const void* start, int T, int W, int B,
                              int log2n, int decode_start, int n_decode, void* bits,
                              void* stream) {
  return pbvd_traceback_copy(sp, start, T, W, B, log2n, decode_start, n_decode, 0, bits, stream);
}

namespace {

// Warps per K2-prefix CTA: enough to take the block's items in as few
// rounds as kPrefixMaxWarps warps take them, and no more.
int prefix_warps(int n_items, int log2g) {
  const int rounds = (n_items + (32 >> log2g) - 1) / (32 >> log2g);  // warp-rounds of a CTA
  const int per_warp = (rounds + kPrefixMaxWarps - 1) / kPrefixMaxWarps;
  return (rounds + per_warp - 1) / per_warp;
}

template <int kW, int kK>
int launch_prefix(const int* sp, const int* start, int B, int log2n, int log2g,
                  const pbvd::PrefixGeometry& geo, int* bits, cudaStream_t stream) {
  const int nw = prefix_warps(geo.n_act * ((1 << log2n) / kK), log2g);
  const size_t smem =
      4 * (static_cast<size_t>(geo.n_act) * (1 << log2n) + geo.nc_e) * (size_t(1) << log2g);
  if (smem > kMaxSmem) return 1001;
  auto kernel = traceback_prefix_lanes_kernel<kW, kK>;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int Gb = 1 << log2g;
  kernel<<<(B + Gb - 1) / Gb, nw * 32, smem, stream>>>(sp, start, B, log2n, log2g, geo, bits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2-prefix. sp, start, bits: as pbvd_traceback. C, P, n_chunks, c_lo,
// c_hi: prefix_chunk_geometry(T, decode_start, n_decode, tb_chunk). G:
// parallel blocks per CTA, a power of two <= 32 (traceback.py::
// prefix_plan). Returns cudaGetLastError() after the launch (or the error
// of raising the shared-memory limit); 1000 for a bad argument, 1001 for
// scratch that does not fit in shared memory.
extern "C" int pbvd_traceback_prefix(const void* sp, const void* start, int T, int W, int B,
                                     int log2n, int decode_start, int n_decode, int C, int P,
                                     int n_chunks, int c_lo, int c_hi, int G, void* bits,
                                     void* stream) {
  if (log2n < 1 || log2n > 10 || B < 1 || decode_start < 0 || n_decode < 1 ||
      decode_start + n_decode > T || W != ((1 << log2n) + 31) / 32 || C < 1 || P < 0 ||
      P >= C || n_chunks * C != T + P || c_lo < 0 || c_hi < c_lo || c_hi >= n_chunks ||
      G < 1 || G > 32 || (G & (G - 1))) {
    return 1000;
  }
  const pbvd::PrefixGeometry geo{C, P, c_lo, n_chunks - c_lo, c_hi - c_lo + 1,
                                 decode_start + P - c_lo * C, n_decode};
  const int log2g = __builtin_ctz(G);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sp_i = static_cast<const int*>(sp);
  const int* start_i = static_cast<const int*>(start);
  int* bits_i = static_cast<int*>(bits);
#define PBVD_K2P(KW, KK) launch_prefix<KW, KK>(sp_i, start_i, B, log2n, log2g, geo, bits_i, st)
  switch (log2n) {  // kK = min(N, 32) chains per thread
    case 1: return PBVD_K2P(1, 2);
    case 2: return PBVD_K2P(1, 4);
    case 3: return PBVD_K2P(1, 8);
    case 4: return PBVD_K2P(1, 16);
    case 5: return PBVD_K2P(1, 32);
    case 6: return PBVD_K2P(2, 32);
    case 7: return PBVD_K2P(4, 32);
    case 8: return PBVD_K2P(8, 32);
    case 9: return PBVD_K2P(16, 32);
    default: return PBVD_K2P(32, 32);
  }
#undef PBVD_K2P
}
