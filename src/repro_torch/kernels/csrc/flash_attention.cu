// Flash attention forward: grouped-query attention with an online softmax
// over blocks of keys, float32 accumulation.
//
// Replaces the TPU kernel repro/_unused/flash_attention.py::_flash_kernel
// (driven by flash_attention). It computes the same function: q (B, S, Hkv,
// G, D) and k, v (B, T, Hkv, D); per (query row, group member) one running
// max, denominator and accumulator in float32 over the keys of the band
// (causal: key <= query; window w: key > query - w; non-causal: every key
// below T); the output is acc / max(l, 1e-30), cast to q's dtype. Scores
// outside the band are -1e30, the reference's sentinel, not -inf: a block
// entirely masked for a row before that row's first valid key gives
// exp(-1e30 - (-1e30)) = 1 per key, which the first valid key's alpha =
// exp(-1e30 - m) = 0 later cancels; with -inf it would give NaN. Windowed
// rows reach that case. Keys past T, which the reference does not have,
// score -inf: they weigh 0 even for a row that sees no key at all (p >= T +
// w - 1 under a window), which then averages V over all T keys, as the
// reference's softmax of equal scores does; a CTA that holds such a row
// walks every block (band_blocks).
//
// The rows of one (batch, kv head) are the S*G (position, member) pairs in
// memory order (row R = s*G + g), so the G query heads that share a kv head
// share every K/V tile; a CTA walks the 64-key blocks of the band of its
// rows' positions (band_blocks: the TPU kernel's block skipping, at these
// tiles), heaviest row tiles first. Two bodies:
// - bfloat16 inputs: the tensor-core body (flash_tc_kernel, below), wgmma
//   on bf16 tiles fed by TMA;
// - float32 inputs: the CUDA-core body (flash_fwd_kernel), float32 FMA.
//
// The CUDA-core body. One CTA of 256 threads takes 64 consecutive rows. Per
// block it stages K and V in shared memory as float32 (row pitch D + 4, so
// that float4 reads of 8 neighbouring rows hit distinct banks), then each
// thread computes a 4 x 4 tile of scores (rows 4*rg + i, keys cg + 16*j) by
// FMA on the CUDA cores from float4 reads of q (scaled before the product)
// and k, masks it, reduces the row max and sum over the 16 threads of its
// row group by warp shuffles, writes its probabilities over the K tile it
// has finished reading, and updates its 4 rows x D/16 dims of the
// accumulator from them and V. Every thread keeps the same 4 rows in both
// products, so m, l and acc stay in its registers.
//
// Bound on the H100. The band's work is 4*D FLOP per (row, key) pair, about
// 6.2e11 FLOP per StarCoder2-3B layer at 2 x 8192 tokens (B=2, H=24, D=128,
// window 4096), 0.62 ms at the 989 TFLOP/s bf16 tensor-core peak; Q, K, V
// and O are about 218 MB, 0.065 ms at 3.35 TB/s. So operations bound it.
// The CUDA-core body's peak is 67 TFLOP/s (>= 9.2 ms per launch at those
// shapes); it serves float32 inputs only.

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tma.cuh"

namespace {

constexpr int kThreads = 256;      // 16 row groups x 16 column groups
constexpr int kRows = 64;          // (position, member) rows per CTA
constexpr int kKeys = 64;          // keys per block
constexpr float kMasked = -1e30f;  // the reference's NEG_INF
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // per-CTA dynamic shared memory on the H100

__host__ __device__ constexpr int row_pitch(int d) { return d + 4; }
__host__ __device__ constexpr int p_pitch() { return kRows + 4; }

// Floats of shared memory per CTA: q tile, the K tile (which the block's
// probabilities reuse once the scores are taken), the V tile.
__host__ __device__ constexpr int smem_floats(int d) {
  return kRows * row_pitch(d) +
         (kKeys * row_pitch(d) > kKeys * p_pitch() ? kKeys * row_pitch(d) : kKeys * p_pitch()) +
         kKeys * row_pitch(d);
}

// The blocks [lo_blk, hi_blk) of keys that rows [row0, row0 + rows) can see;
// every block when one of the rows sees no key.
// repro_torch/_unused/flash_attention.py::band_blocks computes the same.
__device__ inline void band_blocks(int row0, int rows, int G, int T, int causal, int window,
                                   int* lo_blk, int* hi_blk) {
  const int p_lo = row0 / G, p_hi = (row0 + rows - 1) / G;
  if (window > 0 && p_hi >= T + window - 1) {
    *lo_blk = 0;
    *hi_blk = (T + kKeys - 1) / kKeys;
    return;
  }
  int lo = 0, hi = T;
  if (window > 0) lo = p_lo - window + 1 > 0 ? p_lo - window + 1 : 0;
  if (causal) hi = p_hi + 1 < T ? p_hi + 1 : T;
  *lo_blk = lo / kKeys;
  *hi_blk = hi > lo ? (hi + kKeys - 1) / kKeys : lo / kKeys;
}

template <typename In>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  static __device__ __forceinline__ float store(float x) { return x; }
};


__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename In, int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const In* __restrict__ q, const In* __restrict__ k,
                     const In* __restrict__ v, In* __restrict__ o, int S, int T, int Hkv,
                     int G, int causal, int window, float scale) {
  constexpr int P = row_pitch(D);
  constexpr int PP = p_pitch();
  constexpr int VEC = D >= 64 ? 4 : D / 16;  // consecutive dims per read in the PV product
  constexpr int NV = D / (16 * VEC);         // reads per key and thread
  constexpr int KS = kKeys * P > kKeys * PP ? kKeys * P : kKeys * PP;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kRows][P]: q * scale
  float* Ks = Qs + kRows * P;                   // [kKeys][P]; then Ps [kKeys][PP]
  float* Ps = Ks;
  float* Vs = Ks + KS;  // [kKeys][P]

  const int tid = threadIdx.x, rg = tid >> 4, cg = tid & 15;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int n_rows = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // heaviest row tiles first
  const int rows = min(kRows, n_rows - row0);
  const size_t q_base = ((size_t)b * S * Hkv + h) * G * D;  // row R at q_base + (R/G)*qs + (R%G)*D
  const size_t qs = (size_t)Hkv * G * D;
  const size_t kv_base = ((size_t)b * T * Hkv + h) * D;  // key t at kv_base + t*kvs
  const size_t kvs = (size_t)Hkv * D;

  for (int i = tid; i < kRows * (D / 4); i += kThreads) {
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows) {
      const int R = row0 + r;
      x = Elem<In>::load4(q + q_base + (size_t)(R / G) * qs + (size_t)(R % G) * D + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(Qs + r * P + c) = x;
  }

  int pos[4];
  float m[4], l[4], acc[4][NV * VEC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    pos[i] = (row0 + rg * 4 + i) / G;  // rows past the end compute on zeros and store nothing
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NV * VEC; ++e) acc[i][e] = 0.f;
  }

  int kb_lo, kb_hi;
  band_blocks(row0, rows, G, T, causal, window, &kb_lo, &kb_hi);
  for (int kb = kb_lo; kb < kb_hi; ++kb) {
    const int t0 = kb * kKeys;
    __syncthreads();  // q is staged; the previous block's Ps and Vs are read
    for (int i = tid; i < kKeys * (D / 4); i += kThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 kx = make_float4(0.f, 0.f, 0.f, 0.f), vx = kx;
      if (t0 + r < T) {
        const size_t off = kv_base + (size_t)(t0 + r) * kvs + c;
        kx = Elem<In>::load4(k + off);
        vx = Elem<In>::load4(v + off);
      }
      *reinterpret_cast<float4*>(Ks + r * P + c) = kx;
      *reinterpret_cast<float4*>(Vs + r * P + c) = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * P + d);
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = *reinterpret_cast<const float4*>(Ks + (cg + 16 * j) * P + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i].x, ka[j].x, s[i][j]);
          s[i][j] = fmaf(qa[i].y, ka[j].y, s[i][j]);
          s[i][j] = fmaf(qa[i].z, ka[j].z, s[i][j]);
          s[i][j] = fmaf(qa[i].w, ka[j].w, s[i][j]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = t0 + cg + 16 * j;
        const bool ok = (!causal || t <= pos[i]) && (window <= 0 || t > pos[i] - window);
        if (t >= T) {
          s[i][j] = -INFINITY;
        } else if (!ok) {
          s[i][j] = kMasked;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      alpha[i] = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha[i] + group_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();  // every thread has read the K tile: the probabilities take its place
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Ps + (cg + 16 * j) * PP + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < NV * VEC; ++e) acc[i][e] *= alpha[i];
#pragma unroll 4
    for (int t = 0; t < kKeys; ++t) {
      const float4 p = *reinterpret_cast<const float4*>(Ps + t * PP + rg * 4);
#pragma unroll
      for (int nv = 0; nv < NV; ++nv) {
        const float* src = Vs + t * P + nv * 16 * VEC + cg * VEC;
        float vv[VEC];
        if constexpr (VEC == 4) {
          const float4 x = *reinterpret_cast<const float4*>(src);
          vv[0] = x.x;
          vv[1] = x.y;
          vv[2] = x.z;
          vv[3] = x.w;
        } else if constexpr (VEC == 2) {
          const float2 x = *reinterpret_cast<const float2*>(src);
          vv[0] = x.x;
          vv[1] = x.y;
        } else {
          vv[0] = src[0];
        }
#pragma unroll
        for (int c = 0; c < VEC; ++c) {
          acc[0][nv * VEC + c] = fmaf(p.x, vv[c], acc[0][nv * VEC + c]);
          acc[1][nv * VEC + c] = fmaf(p.y, vv[c], acc[1][nv * VEC + c]);
          acc[2][nv * VEC + c] = fmaf(p.z, vv[c], acc[2][nv * VEC + c]);
          acc[3][nv * VEC + c] = fmaf(p.w, vv[c], acc[3][nv * VEC + c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (rg * 4 + i >= rows) continue;
    const int R = row0 + rg * 4 + i;
    In* dst = o + q_base + (size_t)(R / G) * qs + (size_t)(R % G) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int nv = 0; nv < NV; ++nv)
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        dst[nv * 16 * VEC + cg * VEC + c] = Elem<In>::store(acc[i][nv * VEC + c] / denom);
  }
}

// ---- The tensor-core body (bfloat16 inputs) -------------------------------------
//
// Design. A CTA takes kTcRows = 128 consecutive rows of one (batch, kv head)
// and walks the 64-key blocks of their band (band_blocks), heaviest row
// tiles first, as the CUDA-core body. Its 288 threads are two consumer
// warpgroups of 64 rows each (wgmma's M = 64) and one producer warp.
// - Q: rows straddle positions when G does not divide 128 (G = 12 at the
//   main shapes), so the consumers load Q once with 16-byte vector loads,
//   not a TMA box, into shared memory in the swizzled K-major layout a wgmma
//   descriptor reads (Swizzle<B,4,3> of the byte offset: the 16-byte chunk
//   index XOR the row bits, 1024-byte aligned tiles).
// - K and V: one lane of the producer warp keeps a ring of kTcStages K and
//   V tiles of 64 keys full by TMA (a 4-D tensor map over (dh, Hkv, T, B),
//   box (min(dh, 64), 1, 64, 1), the same swizzle; keys past T are filled
//   with zeros), each stage completing on its "full" mbarrier; the eight
//   consumer warps release a stage on its "empty" mbarrier.
// - S = Q·Kᵀ: wgmma m64n64k16, bf16 x bf16 -> f32, A = Q and B = K both from
//   shared memory, K-major (the K tile [key][dh] already is). The products
//   of bf16 values are exact in f32; the scale (times log2 e, for exp2) is
//   applied in f32 after the product.
// - Mask and online softmax in registers: only the blocks at the band's
//   edges are masked (block_needs_mask), with the -1e30 sentinel (-inf past
//   T). In the
//   accumulator layout a row's 64 scores lie in one quad of threads, so a
//   row max takes two shuffles; each thread keeps its share of the row sum
//   and the quad adds them once, at the end.
// - O += P·V: P stays in registers as the A operand (the accumulator's
//   fragment of 16 keys is the A fragment of a k16 step), V is the B operand
//   from shared memory with the transpose flag (MN-major). P is split into
//   hi = bf16(p) and lo = bf16(p - hi), and both products accumulate into
//   the same f32 accumulator: a single bf16 P moves the output by up to
//   2^-9 * sum(p|v|)/l, far above the bf16 check's atol; the split leaves
//   about 2^-17 of that (tests/test_torch_flash_tc.py models it).
// - Epilogue: acc / max(l, 1e-30), rounded to bf16, stored row by row to
//   its (position, member).
//
// Bound on the H100. The function's 4*dh FLOP per (row, key) of the band
// bound it (0.625 ms at the main shapes at 989 TFLOP/s); this body does
// 1.5x that on the tensor cores (QKᵀ plus twice PV), 0.938 ms. Each
// warpgroup runs its products, its softmax and its PV products in turn;
// the two warpgroups of a CTA overlap only with each other.

constexpr int kTcRows = 128;
constexpr int kTcKeys = 64;
constexpr int kTcThreads = 288;  // two consumer warpgroups and one producer warp
constexpr int kTcStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from touching registers an asynchronous wgmma owns
// before its wait (and from moving their reads above it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// A wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle (1: 128 B, 2: 64 B, 3: 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32) | (swizzle << 62);
}

// D (64 x 64, f32) (+)= A (64 x 16, bf16, shared, K-major) * B (16 x 64, bf16, shared,
// K-major): scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 16, f32) += A (64 x 16, bf16, registers) * B (16 x 16, bf16, shared,
// MN-major: the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 32, f32) += A (64 x 16, bf16, registers) * B (16 x 32, bf16, shared,
// MN-major: the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16, shared,
// MN-major: the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16, registers) * B (16 x 128, bf16, shared,
// MN-major: the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (N == 16) wgmma_rs_n16(d, a, desc_b);
  if constexpr (N == 32) wgmma_rs_n32(d, a, desc_b);
  if constexpr (N == 64) wgmma_rs_n64(d, a, desc_b);
  if constexpr (N == 128) wgmma_rs_n128(d, a, desc_b);
}

// Whether rows [r0, r0 + 64) need key block kb masked: unless every key of
// the block lies below T and inside every valid row's band.
// repro_torch/_unused/flash_attention.py::tc_block_needs_mask computes the same.
__device__ __forceinline__ bool block_needs_mask(int r0, int n_rows, int G, int T, int kb,
                                                 int causal, int window) {
  const int last = min(r0 + 64, n_rows) - 1;
  if (last < r0) return true;
  const int p_lo = r0 / G, p_hi = last / G;
  const int t0 = kb * kTcKeys, t1 = t0 + kTcKeys - 1;
  return t1 >= T || (causal && t1 > p_lo) || (window > 0 && t0 <= p_hi - window);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void fence_p(uint32_t (&phi)[4][4], uint32_t (&plo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    fence_regs(phi[kk]);
    fence_regs(plo[kk]);
  }
}

// S (64 x 64 keys) = Q (64 rows of this warpgroup) Kᵀ over dh, 16 at a time:
// both operands K-major in shared memory, swizzled by SWB-byte rows; a k16
// step is 32 bytes along a row, a column block of SWB bytes the next tile.
template <int D, int SWB, uint64_t SWIZZLE>
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col = (kk * 32) % SWB;
    const uint64_t da =
        smem_desc(q_addr + (kk * 32 / SWB) * (kTcRows * SWB) + col, 16, 8 * SWB, SWIZZLE);
    const uint64_t db =
        smem_desc(k_addr + (kk * 32 / SWB) * (kTcKeys * SWB) + col, 16, 8 * SWB, SWIZZLE);
    wgmma_ss_n64(s, da, db, kk > 0);
  }
}

// O (64 x dh) += P_hi V + P_lo V over the block's 64 keys, 16 at a time: V
// MN-major (the transpose flag), 16 keys = 16 rows of SWB bytes, a column
// block of dh the next tile (leading byte offset).
template <int D, int SWB, uint64_t SWIZZLE>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], const uint32_t (&phi)[4][4],
                                         const uint32_t (&plo)[4][4], uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<D>(acc, phi[kk], smem_desc(v_addr + kk * 16 * SWB, kTcKeys * SWB, 8 * SWB, SWIZZLE));
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_rs<D>(acc, plo[kk], smem_desc(v_addr + kk * 16 * SWB, kTcKeys * SWB, 8 * SWB, SWIZZLE));
  }
}

// 2^x on the special-function unit (MUFU.EX2, about 2^-22 relative error;
// results below 2^-126 flush to 0, which a sum of probabilities cannot see).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// What a thread needs to mask its two rows (my_row, my_row + 8).
struct RowBand {
  int G, T, causal, window, pos0, pos1, n_rows, r0, col;  // col: 2 * (lane % 4)
};

// Scale, mask (the band's edge blocks only) and the online softmax (base 2)
// of block kb, in place: s becomes p = exp2(s - m_new); m, this thread's
// share of l and the rescale factors alpha of the thread's two rows.
__device__ __forceinline__ void online_softmax(float (&s)[32], int kb, const RowBand& rb,
                                               float scale_log2, float& m0, float& m1,
                                               float& l0, float& l1, float& alpha0,
                                               float& alpha1) {
  const bool edge = block_needs_mask(rb.r0, rb.n_rows, rb.G, rb.T, kb, rb.causal, rb.window);
  const int t0 = kb * kTcKeys + rb.col;
  float mx0 = kMasked, mx1 = kMasked;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale_log2;
      if (edge) {
        const int t = t0 + 8 * j + (e & 1);
        const int p = e < 2 ? rb.pos0 : rb.pos1;
        if (t >= rb.T) {
          x = -INFINITY;
        } else if ((rb.causal && t > p) || (rb.window > 0 && t <= p - rb.window)) {
          x = kMasked;
        }
      }
      s[4 * j + e] = x;
    }
    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {  // a row's 64 scores lie in one quad
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
  alpha0 = exp2_approx(m0 - mn0);
  alpha1 = exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s[4 * j] = exp2_approx(s[4 * j] - mn0);
    s[4 * j + 1] = exp2_approx(s[4 * j + 1] - mn0);
    s[4 * j + 2] = exp2_approx(s[4 * j + 2] - mn1);
    s[4 * j + 3] = exp2_approx(s[4 * j + 3] - mn1);
    sum0 += s[4 * j] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + sum0;  // this thread's share of the row sums
  l1 = l1 * alpha1 + sum1;
}

// P as A fragments: the k16 step kk holds the accumulator's values 8kk ..
// 8kk+7, as (row, 2 keys), (row + 8, 2 keys), then the next 8 keys; each
// value split into hi = bf16(p) and lo = bf16(p - hi).
__device__ __forceinline__ void split_p(const float (&s)[32], uint32_t (&phi)[4][4],
                                        uint32_t (&plo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = s[8 * kk + 2 * r], x1 = s[8 * kk + 2 * r + 1];
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x0, x1);
      phi[kk][r] = *reinterpret_cast<const uint32_t*>(&hi);
      plo[kk][r] = pack_bf16(x0 - __low2float(hi), x1 - __high2float(hi));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __nv_bfloat16* __restrict__ q,
                    __nv_bfloat16* __restrict__ o, int S, int T, int Hkv, int G, int causal,
                    int window, float scale_log2) {
  constexpr int SWB = D >= 64 ? 128 : 2 * D;  // swizzle span, bytes: one row of a TMA box
  constexpr int CB = 2 * D / SWB;            // column blocks of dh (1, or 2 at dh = 128)
  constexpr uint32_t SW_MASK = SWB / 16 - 1;
  constexpr uint64_t SWIZZLE = SWB == 128 ? 1 : SWB == 64 ? 2 : 3;
  constexpr int Q_BYTES = kTcRows * D * 2;
  constexpr int KV_BYTES = kTcKeys * D * 2;  // one K or V tile
  constexpr int NS = D / 2;                  // accumulator registers of O per thread

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                             ~static_cast<uintptr_t>(1023));
  uint8_t* Qs = base;
  uint8_t* Ks = Qs + Q_BYTES;
  uint8_t* Vs = Ks + kTcStages * KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(Vs + kTcStages * KV_BYTES);
  uint64_t* empty = full + kTcStages;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / Hkv, h = blockIdx.y % Hkv;
  const int n_rows = S * G;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest row tiles first
  const int rows = min(kTcRows, n_rows - row0);
  int kb_lo, kb_hi;
  band_blocks(row0, rows, G, T, causal, window, &kb_lo, &kb_hi);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      pbvd::mbar_init(&full[s], 1);
      pbvd::mbar_init(&empty[s], 8);  // lane 0 of each consumer warp
    }
    pbvd::mbar_init_fence();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: one lane keeps the ring full
    if (tid == 256) {
      for (int i = 0; kb_lo + i < kb_hi; ++i) {
        const int st = i % kTcStages;
        pbvd::mbar_wait(&empty[st], ((i / kTcStages) & 1) ^ 1);
        pbvd::mbar_expect_tx(&full[st], 2 * KV_BYTES);
        const int t0 = (kb_lo + i) * kTcKeys;
#pragma unroll
        for (int cb = 0; cb < CB; ++cb) {
          pbvd::tma_load_4d(Ks + st * KV_BYTES + cb * kTcKeys * SWB, &tm_k, &full[st], cb * (SWB / 2),
                      h, t0, b);
          pbvd::tma_load_4d(Vs + st * KV_BYTES + cb * kTcKeys * SWB, &tm_v, &full[st], cb * (SWB / 2),
                      h, t0, b);
        }
      }
    }
    return;
  }

  // ---- the consumers: Q into shared memory, swizzled -----------------------------
  const size_t q_base = ((size_t)b * S * Hkv + h) * G * D;  // row R at q_base + (R/G)*qs + (R%G)*D
  const size_t qs = (size_t)Hkv * G * D;
  for (int i = tid; i < kTcRows * (D / 8); i += 256) {
    const int r = i / (D / 8), c = i % (D / 8);
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      const int R = row0 + r;
      x = *reinterpret_cast<const uint4*>(q + q_base + (size_t)(R / G) * qs + (size_t)(R % G) * D +
                                          c * 8);
    }
    const uint32_t off = (c * 16 / SWB) * (kTcRows * SWB) + r * SWB + (c * 16) % SWB;
    *reinterpret_cast<uint4*>(Qs + (off ^ (((off >> 7) & SW_MASK) << 4))) = x;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // visible to wgmma
  asm volatile("bar.sync 1, 256;\n" ::: "memory");

  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int r0 = row0 + wg * 64;                     // this warpgroup's first row
  const int my_row = r0 + warp * 16 + (lane >> 2);   // and this thread's (and my_row + 8)
  const int pos0 = my_row / G, pos1 = (my_row + 8) / G;
  const uint32_t q_addr = pbvd::smem_u32(Qs) + wg * 64 * SWB;

  float acc[NS];
#pragma unroll
  for (int i = 0; i < NS; ++i) acc[i] = 0.f;
  float m0 = kMasked, m1 = kMasked, l0 = 0.f, l1 = 0.f;
  float s[32];                      // the scores of a block, then its probabilities
  uint32_t phi[4][4], plo[4][4];    // P = hi + lo as A fragments, one per k16 step
  const RowBand band{G, T, causal, window, pos0, pos1, n_rows, r0, 2 * (lane & 3)};

  // Software pipeline: block i's QKᵀ and block i-1's PV products are issued
  // together; block i's softmax then runs while PV(i-1) is on the tensor
  // cores, and only after PV(i-1) has finished are O rescaled and the P
  // fragments overwritten.
  const int n_blk = kb_hi - kb_lo;
  if (n_blk > 0) {
    pbvd::mbar_wait(&full[0], 0);
    wgmma_fence();
    issue_qk<D, SWB, SWIZZLE>(s, q_addr, pbvd::smem_u32(Ks));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    float alpha0, alpha1;  // O is zero: nothing to rescale
    online_softmax(s, kb_lo, band, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
    split_p(s, phi, plo);
  }
  for (int i = 1; i < n_blk; ++i) {
    const int st = i % kTcStages, prev = (i - 1) % kTcStages;
    pbvd::mbar_wait(&full[st], (i / kTcStages) & 1);
    wgmma_fence();
    issue_qk<D, SWB, SWIZZLE>(s, q_addr, pbvd::smem_u32(Ks + st * KV_BYTES));
    wgmma_commit();
    issue_pv<D, SWB, SWIZZLE>(acc, phi, plo, pbvd::smem_u32(Vs + prev * KV_BYTES));
    wgmma_commit();
    wgmma_wait<1>();  // QKᵀ(i) done; PV(i-1) may still run
    fence_regs(s);
    float alpha0, alpha1;
    online_softmax(s, kb_lo + i, band, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
    wgmma_wait<0>();  // PV(i-1) done: its stage, O and the P fragments are free
    fence_regs(acc);
    fence_p(phi, plo);
    if (lane == 0) pbvd::mbar_arrive(&empty[prev]);
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
    split_p(s, phi, plo);
  }
  if (n_blk > 0) {
    const int prev = (n_blk - 1) % kTcStages;
    wgmma_fence();
    issue_pv<D, SWB, SWIZZLE>(acc, phi, plo, pbvd::smem_u32(Vs + prev * KV_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_p(phi, plo);
  }

  // ---- epilogue ---------------------------------------------------------------
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int R = my_row + 8 * half;
    if (R >= n_rows) continue;
    __nv_bfloat16* dst = o + q_base + (size_t)(R / G) * qs + (size_t)(R % G) * D + 2 * (lane & 3);
    const float den = half ? d1 : d0;
#pragma unroll
    for (int j = 0; j < NS / 4; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] / den, acc[4 * j + 2 * half + 1] / den);
    }
  }
}

template <typename In, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S, int T, int Hkv,
           int G, int causal, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(smem_floats(D));
  if (smem > kMaxSmem) return 1001;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<In, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S * G + kRows - 1) / kRows, B * Hkv);
  flash_fwd_kernel<In, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(q), static_cast<const In*>(k), static_cast<const In*>(v),
      static_cast<In*>(o), S, T, Hkv, G, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename In>
int dispatch_dim(const void* q, const void* k, const void* v, void* o, int B, int S, int T,
                 int Hkv, int G, int D, int causal, int window, float scale,
                 cudaStream_t stream) {
  switch (D) {
    case 16: return launch<In, 16>(q, k, v, o, B, S, T, Hkv, G, causal, window, scale, stream);
    case 32: return launch<In, 32>(q, k, v, o, B, S, T, Hkv, G, causal, window, scale, stream);
    case 64: return launch<In, 64>(q, k, v, o, B, S, T, Hkv, G, causal, window, scale, stream);
    case 128: return launch<In, 128>(q, k, v, o, B, S, T, Hkv, G, causal, window, scale, stream);
    default: return 1000;
  }
}

// The TMA map of k or v, (B, T, Hkv, D) bf16, as the 4-D tensor (D, Hkv, T, B)
// innermost first; box (min(D, 64), 1, 64 keys, 1) with the swizzle of a
// 2*min(D, 64)-byte row; keys past T read as zeros. 0, or 1002 on failure.
int make_kv_map(CUtensorMap* map, const void* ptr, int B, int T, int Hkv, int D) {
  const pbvd::EncodeTiledFn encode = pbvd::tensor_map_encoder();
  if (encode == nullptr) return 1002;
  const int swb = D >= 64 ? 128 : 2 * D;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hkv, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hkv * D * 2,
                                 (cuuint64_t)T * Hkv * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(swb / 2), 1, (cuuint32_t)kTcKeys, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = swb == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : swb == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                 : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                            strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 1002;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int T, int Hkv,
              int G, int causal, int window, float scale, cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  if (make_kv_map(&tm_k, k, B, T, Hkv, D) || make_kv_map(&tm_v, v, B, T, Hkv, D)) return 1002;
  // Q, the ring of K and V tiles, 1 KB to align the swizzled tiles, the barriers
  const size_t smem = 2 * D * (kTcRows + 2 * kTcStages * kTcKeys) + 1024 + 64;
  if (smem > kMaxSmem) return 1001;
  if (smem > kDefaultSmem) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((S * G + kTcRows - 1) / kTcRows, B * Hkv);
  flash_tc_kernel<D><<<grid, kTcThreads, smem, stream>>>(
      tm_k, tm_v, static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o), S, T, Hkv,
      G, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_tc(const void* q, const void* k, const void* v, void* o, int B, int S, int T, int Hkv,
                int G, int D, int causal, int window, float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_tc<16>(q, k, v, o, B, S, T, Hkv, G, causal, window, scale, stream);
    case 32: return launch_tc<32>(q, k, v, o, B, S, T, Hkv, G, causal, window, scale, stream);
    case 64: return launch_tc<64>(q, k, v, o, B, S, T, Hkv, G, causal, window, scale, stream);
    case 128: return launch_tc<128>(q, k, v, o, B, S, T, Hkv, G, causal, window, scale, stream);
    default: return 1000;
  }
}

}  // namespace

// q, o: contiguous (B, S, Hkv, G, D); k, v: contiguous (B, T, Hkv, D), all of
// one dtype (0 float32: the CUDA-core body; 1 bfloat16: the tensor-core
// body, and only it), 16-byte aligned. window <= 0: none. Returns
// cudaGetLastError() after the launch (or the error of raising the
// shared-memory limit); 1000 for a bad argument, 1001 for tiles that do not
// fit in shared memory, 1002 when the TMA maps of k and v cannot be made.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int T, int Hkv, int G, int D, int dtype, int causal,
                                   int window, float scale, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || G < 1 || B * Hkv > 65535 ||
      static_cast<long long>(S) * G > (1LL << 30)) {
    return 1000;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(q, k, v, o, B, S, T, Hkv, G, D, causal, window, scale, st);
  if (dtype == 1) return dispatch_tc(q, k, v, o, B, S, T, Hkv, G, D, causal, window, scale, st);
  return 1000;
}
