// Flash attention (causal or full) over contiguous Q/K/V for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:_flash_kernel
// (launched by flash_attention_pallas; wrapper flash_attention, reached by
// Runtime(flash_kernel=True) in self-attention without a cache, i.e. the
// held-out evaluation forward).  For q, k, v (BH, S, dh) in f32 or bf16:
//
//     out[b, r] = Σ_j softmax_j(q[b, r] · k[b, j] · dh^-0.5) v[b, j]
//
// over j <= r when causal, with the finite mask NEG = -1e30 and the
// online-softmax schedule of the TPU kernel (running max m, normalizer
// l, accumulator acc; out = acc / max(l, 1e-30)), in f32 arithmetic and
// written in q's dtype.  S need not be a multiple of the tile: keys past
// S are masked (their p is exactly 0), query rows past S are not stored.
//
// What bounds it on this card: the operations.  At the evaluation shape
// (BH 48, S 2048, dh 64, causal) it does ~25.8 GFLOP of dot products on
// 25 MB of bf16 inputs and output, ~1000 operations a byte; the floor is
// 0.026 ms on the bf16 tensor cores, 0.39 ms in f32 on the CUDA cores.
// Design (simple, f32 CUDA cores first): one block of 256 threads owns a
// (bh, 64-query tile) and loops over 64-key tiles of K and V staged in
// shared memory (as f32, rows padded by 4 so the float4 reads are free of
// bank conflicts).  Thread (ty, tx) of a 16 × 16 grid computes the scores
// of 4 query rows × 4 keys, the 16 lanes of a row group reduce the row
// max and sum with shuffles, and (m, l, acc) stay in registers: each
// thread accumulates 4 rows × dh/16 output columns from P staged in
// shared memory.  Key tiles wholly above the diagonal are skipped, which
// is exact: there the TPU kernel gets p = 0 and alpha = 1.  The heaviest
// causal query tiles launch first.  A tensor-core (wgmma) P·V, which
// rounds P to bf16, is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int TQ = 64;  // query rows per block
constexpr int TK = 64;  // keys per tile
constexpr int THREADS = 256;
constexpr int PP = TK + 4;  // row stride of the staged P

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* dst, int row0, int S,
                                          int tid) {
  constexpr int DP = D + 4;
  for (int e = tid; e < TQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[r * DP + d] = row < S ? to_f32(src[static_cast<size_t>(row) * D + d]) : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int causal, float scale) {
  constexpr int DP = D + 4;
  constexpr int VEC = D >= 64 ? 4 : 2;  // output columns per vector read
  constexpr int NV = D / (16 * VEC);    // vector reads per thread and key
  constexpr int CPT = NV * VEC;         // output columns per thread (D / 16)
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;             // TQ × DP
  float* k_s = q_s + TQ * DP;    // TK × DP
  float* v_s = k_s + TK * DP;    // TK × DP
  float* p_s = v_s + TK * DP;    // TQ × PP

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * TQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  load_tile<T, D>(q + base, q_s, q0, S, tid);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }
  int n_kt = (S + TK - 1) / TK;
  if (causal) n_kt = min(n_kt, (q0 + TQ - 1) / TK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * TK;
    __syncthreads();  // previous tile's readers are done with k_s / v_s / p_s
    load_tile<T, D>(k + base, k_s, k0, S, tid);
    load_tile<T, D>(v + base, v_s, k0, S, tid);
    __syncthreads();

    // ---- scores of rows ty·4 + i against keys tx + 16 j ----
    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&q_s[(ty * 4 + i) * DP + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&k_s[(tx + 16 * j) * DP + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                     qv[i].w * kv[j].w;
    }

    // ---- online softmax; the 16 lanes of a row group share each row ----
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < S && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * scale : NEG;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[(ty * 4 + i) * PP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // ---- acc += P · V over this tile's keys ----
#pragma unroll 2
    for (int j = 0; j < TK; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&p_s[(ty * 4 + i) * PP + j]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[CPT];
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          const float* src = &v_s[(j + jj) * DP + c * 16 * VEC + tx * VEC];
          if constexpr (VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[c * VEC] = t.x;
            vv[c * VEC + 1] = t.y;
            vv[c * VEC + 2] = t.z;
            vv[c * VEC + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[c * VEC] = t.x;
            vv[c * VEC + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj == 0 ? pv[i].x : jj == 1 ? pv[i].y : jj == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] += p * vv[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(&o[c * 16 * VEC + tx * VEC + e], acc[i][c * VEC + e] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int BH, int S, int causal,
           float scale, cudaStream_t st) {
  const size_t smem = ((TQ + 2 * TK) * (D + 4) + TQ * PP) * sizeof(float);
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TQ - 1) / TQ, BH);
  kern<<<grid, THREADS, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                    static_cast<const T*>(v), static_cast<T*>(out), S, causal,
                                    scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int BH, int S, int D,
             int causal, float scale, cudaStream_t st) {
  if (D == 32) return launch<T, 32>(q, k, v, out, BH, S, causal, scale, st);
  if (D == 64) return launch<T, 64>(q, k, v, out, BH, S, causal, scale, st);
  if (D == 128) return launch<T, 128>(q, k, v, out, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry: launches on ``stream``, allocates nothing, returns the
// launch status.  dtype: 0 f32, 1 bf16 (q, k, v and out alike, each a
// contiguous (BH, S, D) tensor); D in {32, 64, 128}; the wrapper checks.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* out, int BH, int S, int D, int causal, float scale,
                                      void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_d<float>(q, k, v, out, BH, S, D, causal, scale, st);
  if (dtype == 1) return launch_d<__nv_bfloat16>(q, k, v, out, BH, S, D, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
