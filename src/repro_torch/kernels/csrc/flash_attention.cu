// Flash attention forward: grouped-query attention with an online softmax
// over blocks of keys, float32 math.
//
// Replaces the TPU kernel repro/_unused/flash_attention.py::_flash_kernel
// (driven by flash_attention). It computes the same function: q (B, S, Hkv,
// G, D) and k, v (B, T, Hkv, D), upcast to float32, q scaled before the
// product; per (query row, group member) one running max, denominator and
// accumulator in float32 over the keys of the band (causal: key <= query;
// window w: key > query - w; non-causal: every key below T); the output is
// acc / max(l, 1e-30), cast to q's dtype. Masked scores are -1e30, the
// reference's sentinel, not -inf: a block entirely masked for a row before
// that row's first valid key gives exp(-1e30 - (-1e30)) = 1 per key, which
// the first valid key's alpha = exp(-1e30 - m) = 0 later cancels; with -inf
// it would give NaN. Windowed rows reach that case.
//
// Design. The rows of one (batch, kv head) are the S*G (position, member)
// pairs in memory order (row R = s*G + g), so the G query heads that share a
// kv head share every K/V tile. One CTA of 256 threads takes 64 consecutive
// rows and walks the 64-key blocks of the band of their positions
// (band_blocks: the TPU kernel's block skipping, at this kernel's tiles),
// heaviest row tiles first. Per block it stages K and V in shared memory as
// float32 (row pitch D + 4, so that float4 reads of 8 neighbouring rows hit
// distinct banks), then each thread computes a 4 x 4 tile of scores (rows
// 4*rg + i, keys cg + 16*j) by FMA on the CUDA cores from float4 reads of q
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
// This kernel does its products in float32 on the CUDA cores, whose peak is
// 67 TFLOP/s (>= 9.2 ms per launch): wgmma on bf16 tiles with TMA-fed
// shared memory is the redesign that closes that gap.

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// The blocks [lo_blk, hi_blk) of keys that rows [row0, row0 + rows) can see.
// repro_torch/_unused/flash_attention.py::band_blocks computes the same.
__device__ inline void band_blocks(int row0, int rows, int G, int T, int causal, int window,
                                   int* lo_blk, int* hi_blk) {
  const int p_lo = row0 / G, p_hi = (row0 + rows - 1) / G;
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

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) { return __float2bfloat16(x); }
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
        const bool ok = t < T && (!causal || t <= pos[i]) && (window <= 0 || t > pos[i] - window);
        if (!ok) s[i][j] = kMasked;
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

}  // namespace

// q, o: contiguous (B, S, Hkv, G, D); k, v: contiguous (B, T, Hkv, D), all of
// one dtype (0 float32, 1 bfloat16), 16-byte aligned. window <= 0: none.
// Returns cudaGetLastError() after the launch (or the error of raising the
// shared-memory limit); 1000 for a bad argument, 1001 for tiles that do not
// fit in shared memory.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B,
                                   int S, int T, int Hkv, int G, int D, int dtype, int causal,
                                   int window, float scale, void* stream) {
  if (B < 1 || S < 1 || T < 1 || Hkv < 1 || G < 1 || B * Hkv > 65535 ||
      static_cast<long long>(S) * G > (1LL << 30)) {
    return 1000;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_dim<float>(q, k, v, o, B, S, T, Hkv, G, D, causal, window, scale, st);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(q, k, v, o, B, S, T, Hkv, G, D, causal, window, scale, st);
  return 1000;
}
