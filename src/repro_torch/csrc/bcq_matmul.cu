// W4A4 GEMM of two packed LO-BCQ operands for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bcq_matmul.py:_matmul_kernel
// (helper _decode_tile; launched by bcq_matmul_pallas, reached through
// ops.matmul and ops.w4a4_linear).  Computes
//
//     out (M, N) f32 = Â · Ŵᵀ,   Â[m, k] = cb_a[sel · 16 + idx] · a_inv[m, k / 64]
//                               Ŵ[n, k] = cb_w[sel · 16 + idx] · w_inv[n, k / 64]
//
// from packed rows: idx u8 (R, K/2) nibbles, sel u8 (R, K/16) selector
// nibbles, inv f32 (R, K/64) dequant scales 1 / (ŝ_A · s_X).
//
// What bounds it on this card: the multiply-adds.  At the evaluation
// shape (M 8192, K 768, N 3072) it does 38.7 GFLOP on 4.5-bit operands of
// a few MB, so it is far above the card's ridge point; in f32 on the CUDA
// cores the floor is 0.58 ms.  Design: B1's tile structure
// (bcq_linear.cu) with a register tile.  One block of 256 threads owns a
// 64 × 64 output tile and walks K one 64-scalar array at a time: half the
// threads decode the 64 A rows, half the 64 W rows (one row-half of 32
// scalars each, bcq::decode_half: an indexed codebook table in shared
// memory, not the TPU's masked-sum mux) into k-major shared memory; then
// each thread accumulates a 4 × 4 sub-tile in f32 registers from float4
// reads.  Ragged M and N decode as zeros and are not stored.  The int8
// tensor-core route (codewords are INT6 integers, scales per array) is
// later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bcq_encode.cuh"

namespace {

using bcq::LA;
using bcq::NC;
using bcq::NE;
constexpr int TM = 64;  // output rows per block
constexpr int TN = 64;  // output columns per block
constexpr int THREADS = 256;

__device__ __forceinline__ void decode_rows(const uint8_t* __restrict__ idx,
                                            const uint8_t* __restrict__ sel,
                                            const float* __restrict__ inv, const float* cb_s,
                                            float (*dst)[64], int row0, int R, int K, int k0,
                                            int t) {
  const int r = t & 63, half = t >> 6;
  const int row = row0 + r;
  if (row < R) {
    bcq::decode_half(idx + static_cast<size_t>(row) * (K / 2) + k0 / 2 + half * 16,
                     sel + static_cast<size_t>(row) * (K / 16) + k0 / 16 + half * 2,
                     inv[static_cast<size_t>(row) * (K / LA) + k0 / LA], cb_s,
                     &dst[half * 32][r], 64);
  } else {
#pragma unroll
    for (int j = 0; j < 32; ++j) dst[half * 32 + j][r] = 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) bcq_matmul_kernel(
    const uint8_t* __restrict__ a_idx, const uint8_t* __restrict__ a_sel,
    const float* __restrict__ a_inv, const uint8_t* __restrict__ w_idx,
    const uint8_t* __restrict__ w_sel, const float* __restrict__ w_inv,
    const float* __restrict__ cb_a, const float* __restrict__ cb_w, float* __restrict__ out,
    int M, int N, int K) {
  __shared__ float cba_s[NC * NE];
  __shared__ float cbw_s[NC * NE];
  __shared__ __align__(16) float a_s[LA][TM];  // decoded A, k-major
  __shared__ __align__(16) float w_s[LA][TN];  // decoded W, k-major

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  if (tid < NC * NE) cba_s[tid] = cb_a[tid];
  else if (tid < 2 * NC * NE) cbw_s[tid - NC * NE] = cb_w[tid - NC * NE];

  // compute-phase ownership: rows ty·4 .. +3, columns tx·4 .. +3
  const int ty = tid >> 4, tx = tid & 15;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += LA) {
    __syncthreads();  // tables staged; previous step's readers are done
    if (tid < THREADS / 2)
      decode_rows(a_idx, a_sel, a_inv, cba_s, a_s, m0, M, K, k0, tid);
    else
      decode_rows(w_idx, w_sel, w_inv, cbw_s, w_s, n0, N, K, k0, tid - THREADS / 2);
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < LA; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 w = *reinterpret_cast<const float4*>(&w_s[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * wv[j];
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

}  // namespace

// Plain C entry: launches on ``stream``, allocates nothing, returns the
// launch status (cudaGetLastError).  Requires K % 64 == 0 and the paper
// config (L_A 64, L_b 8, 16 entries, 8 codebooks); the wrapper checks.
extern "C" int bcq_matmul_launch(const uint8_t* a_idx, const uint8_t* a_sel, const float* a_inv,
                                 const uint8_t* w_idx, const uint8_t* w_sel, const float* w_inv,
                                 const float* cb_a, const float* cb_w, float* out, int M, int N,
                                 int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % LA) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  bcq_matmul_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a_idx, a_sel, a_inv, w_idx, w_sel, w_inv, cb_a, cb_w, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}
