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
// Key tiles wholly above the diagonal are skipped, which is exact: there
// the TPU kernel gets p = 0 and alpha = 1.  The heaviest causal query
// tiles launch first.
//
// What bounds it on this card: the operations.  At the evaluation shape
// (BH 48, S 2048, dh 64, causal) it does ~25.8 GFLOP of dot products on
// 25 MB of bf16 inputs and output, ~1000 operations a byte; the floor is
// 0.026 ms on the bf16 tensor cores, 0.39 ms in f32 on the CUDA cores.
//
// bf16 inputs (flash_bf16_mma_kernel): both products on the bf16 tensor
// cores, mma.sync.m16n8k16 with f32 accumulation.  One block of 4 warps
// owns a (bh, 64·MT-query tile); each warp owns MT m-tiles of 16 query
// rows (MT = 2 at d_head <= 64, so every K and V fragment it loads feeds
// two MMAs; 1 at d_head 128, where two would not fit the registers),
// holds their Q fragments in registers, and walks 64-key tiles:
//   * S = Q·Kᵀ: a product of two bf16 values is exact in f32, so S is the
//     reference's f32 dot up to summation order;
//   * the online softmax in f32 registers (each row lives in the 4 lanes
//     of a quad: row max by two shuffles, l as per-lane partial sums that
//     the quad adds once at the end), in base 2: scores are scaled by
//     dh^-0.5 · log2 e, so p = 2^(x − m) is one MUFU.EX2, the same
//     e^(s·dh^-0.5 − max) up to its rounding;
//   * O += P·V with P rounded to bf16 straight from the score
//     accumulators: the C fragment of a 16 × 8 score tile has the layout
//     of the A fragment of the P·V product (FlashAttention-2), so P never
//     touches shared memory.  The TPU's MXU rounds the f32 operands of the
//     kernel's dots to bf16 at JAX's default precision, so this is what
//     the TPU kernel did on its own chip; l sums the f32 p.
// K/V tiles: a two-stage cp.async ring (tile j + 1 loads while tile j is
// multiplied), rows padded to D + 8 bf16 so the ldmatrix reads of K
// (row-major fragments) and V (transposed) hit distinct banks.  The output
// tile is staged through the Q tile's shared memory for 16-byte stores.
// mma.sync rather than wgmma: the FA-2 register layout needs no shared-
// memory descriptors, swizzle modes or warpgroup synchronisation, which
// keeps a kernel that can only be compiled on the card simple; a wgmma
// version with 64-row warpgroup tiles (FlashAttention-3) is later work.
//
// f32 inputs (flash_f32_cuda_cores_kernel): the reference's f32 dots on
// the CUDA cores (TF32 tensor cores would not hold the 2e-4 tolerance of
// the f32 checks).  One block of 256 threads owns a (bh, 64-query tile)
// and loops over 64-key tiles of K and V staged in shared memory (rows
// padded by 4 so the float4 reads are free of bank conflicts).  Thread
// (ty, tx) of a 16 × 16 grid computes the scores of 4 query rows × 4
// keys, the 16 lanes of a row group reduce the row max and sum with
// shuffles, and (m, l, acc) stay in registers: each thread accumulates 4
// rows × dh/16 output columns from P staged in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int TQ = 64;  // query rows per block (f32 kernel)
constexpr int TK = 64;  // keys per tile (both kernels)

// ========================================================== bf16: mma.sync
constexpr int MMA_THREADS = 128;  // 4 warps, each 16 · MT query rows
constexpr float LOG2E = 1.4426950408889634f;

// m-tiles of 16 query rows per warp: two where the registers allow (each
// K and V fragment then feeds two MMAs), one at d_head 128.
template <int D>
__host__ __device__ constexpr int mma_mt() { return D <= 64 ? 2 : 1; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ float ex2(float x) {  // 2^x, MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + ROWS) of a (S, D) bf16 matrix into a tile of padded
// rows (D + 8), by 16-byte cp.async; rows past S are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int S, int tid) {
  constexpr int LD = D + 8, CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < ROWS * CPR / MMA_THREADS; ++i) {
    const int e = tid + i * MMA_THREADS;
    const int r = e / CPR, c = e % CPR, row = row0 + r;
    const bool ok = row < S;
    ptx::cp_async16(dst + r * LD + c * 8, src + static_cast<size_t>(ok ? row : 0) * D + c * 8, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS) flash_bf16_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int causal,
    float scale) {
  constexpr int MT = mma_mt<D>();
  constexpr int BM = 64 * MT;  // query rows per block
  constexpr int WR = 16 * MT;  // query rows per warp
  constexpr int LD = D + 8;    // padded row (bf16 elements)
  constexpr int KD = D / 16;   // k-steps of Q·Kᵀ
  constexpr int NT = TK / 8;   // 8-key tiles of a score row block
  constexpr int OT = D / 8;    // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem);  // BM × LD, later the output
  __nv_bfloat16* k_s = q_s + BM * LD;                             // 2 × TK × LD
  __nv_bfloat16* v_s = k_s + 2 * TK * LD;                         // 2 × TK × LD

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * BM, w0 = q0 + warp * WR;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  int n_kt = (S + TK - 1) / TK;
  if (causal) n_kt = min(n_kt, (q0 + BM - 1) / TK + 1);
  const float sl = scale * LOG2E;  // scores in log2 units: p = 2^(s·sl − m)

  copy_tile<D, BM>(q_s, q + base, q0, S, tid);
  copy_tile<D, TK>(k_s, k + base, 0, S, tid);
  copy_tile<D, TK>(v_s, v + base, 0, S, tid);
  ptx::cp_async_commit();

  // Fragment rows of m-tile mt: lane holds rows r_lo = w0 + 16 mt + lane / 4
  // (c0, c1) and r_lo + 8 (c2, c3), columns 2 (lane % 4) and 2 (lane % 4) + 1.
  const int r_lo = w0 + (lane >> 2), c_lo = (lane & 3) * 2;
  uint32_t qf[MT][KD][4];
  float o[MT][OT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < OT; ++t) o[mt][t][0] = o[mt][t][1] = o[mt][t][2] = o[mt][t][3] = 0.f;
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) m[mt][0] = m[mt][1] = NEG, l[mt][0] = l[mt][1] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_kt) {
      copy_tile<D, TK>(k_s + (buf ^ 1) * TK * LD, k + base, (kt + 1) * TK, S, tid);
      copy_tile<D, TK>(v_s + (buf ^ 1) * TK * LD, v + base, (kt + 1) * TK, S, tid);
      ptx::cp_async_commit();
      ptx::cp_async_wait<1>();
    } else {
      ptx::cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          ptx::ldmatrix_x4(qf[mt][kk], q_s + (warp * WR + mt * 16 + (lane & 15)) * LD + kk * 16 +
                                           (lane >> 4) * 8);
    }
    const __nv_bfloat16* kb = k_s + buf * TK * LD;
    const __nv_bfloat16* vb = v_s + buf * TK * LD;

    // ---- S = Q·Kᵀ over this tile's 64 keys; each K fragment feeds MT MMAs ----
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < NT; ++t) s[mt][t][0] = s[mt][t][1] = s[mt][t][2] = s[mt][t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];  // keys np·16 + {0–7, 8–15} × dims kk·16 + {0–7, 8–15}
        ptx::ldmatrix_x4(b, kb + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                                ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ptx::mma_bf16(s[mt][2 * np], qf[mt][kk], b[0], b[1]);
          ptx::mma_bf16(s[mt][2 * np + 1], qf[mt][kk], b[2], b[3]);
        }
      }

    // ---- online softmax (mask only on the diagonal and ragged tiles) ----
    const int k0 = kt * TK;
    const bool edge = k0 + TK > S || (causal && k0 + TK - 1 > w0);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][t][e] * sl;
          if (edge) {
            const int col = k0 + t * 8 + c_lo + (e & 1), row = r_lo + mt * 16 + (e >> 1) * 8;
            if (col >= S || (causal && col > row)) x = NEG;
          }
          s[mt][t][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[mt][h], mx[h]);
        alpha[h] = ex2(m[mt][h] - m_new);
        m[mt][h] = m_new;
        l[mt][h] *= alpha[h];
      }
#pragma unroll
      for (int t = 0; t < OT; ++t) {
        o[mt][t][0] *= alpha[0];
        o[mt][t][1] *= alpha[0];
        o[mt][t][2] *= alpha[1];
        o[mt][t][3] *= alpha[1];
      }
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[mt][t][e] - m[mt][e >> 1]);
          s[mt][t][e] = p;
          l[mt][e >> 1] += p;
        }
    }

    // ---- O += P·V, P from the score registers; each V fragment feeds MT MMAs ----
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        a[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
        a[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
        a[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
        a[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
      }
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t b[4];  // V transposed: keys kk·16 + {0–7, 8–15} × dims dp·16 + {0–7, 8–15}
        ptx::ldmatrix_x4_trans(b, vb + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                      dp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          ptx::mma_bf16(o[mt][2 * dp], a[mt], b[0], b[1]);
          ptx::mma_bf16(o[mt][2 * dp + 1], a[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled at the top of the next tile
  }

  // ---- out = acc / max(l, 1e-30), staged through the warp's Q rows ----
  __nv_bfloat16* o_s = q_s + warp * WR * LD;
  const int g = lane >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float den[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 1);
      l[mt][h] += __shfl_xor_sync(0xffffffffu, l[mt][h], 2);
      den[h] = fmaxf(l[mt][h], 1e-30f);
    }
#pragma unroll
    for (int t = 0; t < OT; ++t) {
      *reinterpret_cast<__nv_bfloat162*>(o_s + (mt * 16 + g) * LD + t * 8 + c_lo) =
          __floats2bfloat162_rn(o[mt][t][0] / den[0], o[mt][t][1] / den[0]);
      *reinterpret_cast<__nv_bfloat162*>(o_s + (mt * 16 + g + 8) * LD + t * 8 + c_lo) =
          __floats2bfloat162_rn(o[mt][t][2] / den[1], o[mt][t][3] / den[1]);
    }
  }
  __syncwarp();
  constexpr int CPR = D / 8;
#pragma unroll
  for (int e = lane; e < WR * CPR; e += 32) {
    const int r = e / CPR, c = e % CPR, row = w0 + r;
    if (row < S)
      *reinterpret_cast<uint4*>(out + base + static_cast<size_t>(row) * D + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + r * LD + c * 8);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out, int BH, int S,
                int causal, float scale, cudaStream_t st) {
  constexpr int BM = 64 * mma_mt<D>();
  const size_t smem = (BM + 4 * TK) * (D + 8) * sizeof(__nv_bfloat16);
  auto kern = flash_bf16_mma_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BM - 1) / BM, BH);
  kern<<<grid, MMA_THREADS, smem, st>>>(static_cast<const __nv_bfloat16*>(q),
                                        static_cast<const __nv_bfloat16*>(k),
                                        static_cast<const __nv_bfloat16*>(v),
                                        static_cast<__nv_bfloat16*>(out), S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ===================================================== f32: CUDA cores
constexpr int F32_THREADS = 256;
constexpr int PP = TK + 4;  // row stride of the staged P

template <int D>
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ src, float* dst, int row0,
                                              int S, int tid) {
  constexpr int DP = D + 4;
  for (int e = tid; e < TQ * D; e += F32_THREADS) {
    const int r = e / D, d = e % D;
    const int row = row0 + r;
    dst[r * DP + d] = row < S ? src[static_cast<size_t>(row) * D + d] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS) flash_f32_cuda_cores_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int S, int causal, float scale) {
  constexpr int DP = D + 4;
  constexpr int VEC = D >= 64 ? 4 : 2;  // output columns per vector read
  constexpr int NV = D / (16 * VEC);    // vector reads per thread and key
  constexpr int CPT = NV * VEC;         // output columns per thread (D / 16)
  extern __shared__ __align__(16) float smem_f[];
  float* q_s = smem_f;           // TQ × DP
  float* k_s = q_s + TQ * DP;    // TK × DP
  float* v_s = k_s + TK * DP;    // TK × DP
  float* p_s = v_s + TK * DP;    // TQ × PP

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int q0 = qt * TQ;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D;
  load_tile_f32<D>(q + base, q_s, q0, S, tid);

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
    load_tile_f32<D>(k + base, k_s, k0, S, tid);
    load_tile_f32<D>(v + base, v_s, k0, S, tid);
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
    float* o = out + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int c = 0; c < NV; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[c * 16 * VEC + tx * VEC + e] = acc[i][c * VEC + e] / den;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int BH, int S,
               int causal, float scale, cudaStream_t st) {
  const size_t smem = ((TQ + 2 * TK) * (D + 4) + TQ * PP) * sizeof(float);
  auto kern = flash_f32_cuda_cores_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TQ - 1) / TQ, BH);
  kern<<<grid, F32_THREADS, smem, st>>>(static_cast<const float*>(q),
                                        static_cast<const float*>(k),
                                        static_cast<const float*>(v), static_cast<float*>(out),
                                        S, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* out, int BH, int S,
           int causal, float scale, cudaStream_t st) {
  if (dtype == 0) return launch_f32<D>(q, k, v, out, BH, S, causal, scale, st);
  if (dtype == 1) return launch_bf16<D>(q, k, v, out, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry: launches on ``stream``, allocates nothing, returns the
// launch status.  dtype: 0 f32 (CUDA cores), 1 bf16 (tensor cores); q, k,
// v and out alike, each a contiguous (BH, S, D) tensor, bf16 ones 16-byte
// aligned; D in {32, 64, 128}; the wrapper checks.
extern "C" int flash_attention_launch(int dtype, const void* q, const void* k, const void* v,
                                      void* out, int BH, int S, int D, int causal, float scale,
                                      void* stream) {
  if (BH <= 0 || S <= 0 || BH > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 32) return launch<32>(dtype, q, k, v, out, BH, S, causal, scale, st);
  if (D == 64) return launch<64>(dtype, q, k, v, out, BH, S, causal, scale, st);
  if (D == 128) return launch<128>(dtype, q, k, v, out, BH, S, causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
