// Fused W4A4 LO-BCQ linear for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bcq_linear.py:_fused_kernel
// (launched by bcq_linear_pallas).  Computes
//
//     out (M, N) f32 = Â · Ŵᵀ,
//
// where Â is the LO-BCQ encode-decode of the raw activation x (M, K),
// done inside the kernel with the per-tensor scale s_x the caller
// reduced, and Ŵ decodes from the packed weight bytes: w_idx (N, K/2)
// nibbles, w_sel (N, K/16) selector nibbles, w_inv (N, K/64) f32
// dequant scales.  The encode follows repro/kernels/common.py:
// encode_tile: per 64-scalar array amax, ratio = e4m3_snap(s_a / s_x),
// y = x · (ratio · s_x), 15 threshold compares per scalar and codebook,
// a strict-< running argmin over the 8 codebooks per 8-scalar block.
//
// What bounds it on this card: at decode (M = n_slots = 8) the packed
// weight stream (4.5 bits per weight) — a few hundred KB per linear, far
// below a microsecond of HBM time — so the kernel is latency bound; at
// prefill (M = bucket · chunk, up to 512) the in-kernel encode, which
// every N tile repeats (15 compares × 8 codebooks per scalar), and the
// f32 multiply-adds on the CUDA cores.
//
// Design: one block owns a TM × TN output tile and walks K one 64-scalar
// array at a time.  Per step the first four warps encode and decode the
// TM activation rows into shared memory while the other four decode the
// TN weight rows from their packed bytes (codebook and thresholds held in
// shared memory: an indexed table, not the TPU's one-hot MXU lookup);
// then all eight warps accumulate the TM × TN tile in f32 registers.  No
// K · TN decoded-weight slab: it would not fit in shared memory at
// K = 3072.  The encode repeats per N tile (accepted for now; the first
// known cost in PERF.md).  wgmma, TMA and an exact int8 route are later
// work.
//
// The encode and the weight decode are the shared device functions of
// bcq_encode.cuh (bit-exact with the plain PyTorch encode; see there).
#include <cuda_runtime.h>
#include <stdint.h>

#include "bcq_encode.cuh"

namespace {

using bcq::LA;
using bcq::LB;
using bcq::NC;
using bcq::NE;
constexpr int TM = 16;   // output rows per block
constexpr int TN = 64;   // output columns per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) bcq_linear_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ w_idx,
    const uint8_t* __restrict__ w_sel, const float* __restrict__ w_inv,
    const float* __restrict__ cb, const float* __restrict__ s_x_ptr,
    float* __restrict__ out, int M, int N, int K, float cw_max) {
  __shared__ float cb_s[NC * NE];
  __shared__ float thr_s[NC * (NE - 1)];
  __shared__ float a_s[LA][TM];  // decoded activations, k-major
  __shared__ float w_s[LA][TN];  // decoded weights, k-major

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * TN;
  const int m0 = blockIdx.y * TM;
  bcq::load_tables(cb, cb_s, thr_s, tid);
  const float s_x = *s_x_ptr;
  const int kb = K / 2, ks = K / 16, ka = K / LA;

  // compute-phase ownership: one column, four rows
  const int cn = tid & (TN - 1);
  const int cr = (tid >> 6) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  for (int k0 = 0; k0 < K; k0 += LA) {
    __syncthreads();  // previous step's readers are done with a_s / w_s
    if (tid < TM * LA / LB) {
      // ---- activation: thread = one 8-scalar block of one row ----
      const int r = tid >> 3, b = tid & 7;
      const int m = m0 + r;
      float y[LB];
#pragma unroll
      for (int i = 0; i < LB; ++i)
        y[i] = m < M ? x[static_cast<size_t>(m) * K + k0 + b * LB + i] : 0.f;
      int bidx[LB], bsel;
      float ratio, scale;
      bcq::encode_block(y, cb_s, thr_s, s_x, cw_max, bidx, bsel, ratio, scale);
      const float inv = __fdiv_rn(1.f, scale);
#pragma unroll
      for (int i = 0; i < LB; ++i) a_s[b * LB + i][r] = __fmul_rn(cb_s[bsel * NE + bidx[i]], inv);
    } else {
      // ---- weight: thread = one row, half of the array (32 scalars) ----
      const int t = tid - TM * LA / LB;
      const int wn = t & (TN - 1), half = t >> 6;
      const int n = n0 + wn;
      if (n < N) {
        bcq::decode_half(w_idx + static_cast<size_t>(n) * kb + k0 / 2 + half * 16,
                         w_sel + static_cast<size_t>(n) * ks + k0 / 16 + half * 2,
                         w_inv[static_cast<size_t>(n) * ka + k0 / LA], cb_s,
                         &w_s[half * 32][wn], TN);
      } else {
#pragma unroll
        for (int j = 0; j < 32; ++j) w_s[half * 32 + j][wn] = 0.f;
      }
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < LA; ++k) {
      const float w = w_s[k][cn];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] += a_s[k][cr + i] * w;
    }
  }
  const int n = n0 + cn;
  if (n < N) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + cr + i;
      if (m < M) out[static_cast<size_t>(m) * N + n] = acc[i];
    }
  }
}

}  // namespace

// Plain C entry: launches on ``stream``, allocates nothing, returns the
// launch status (cudaGetLastError).  Requires K % 64 == 0 and the paper
// config (L_A 64, L_b 8, 16 entries, 8 codebooks); the wrapper checks.
extern "C" int bcq_linear_launch(const float* x, const uint8_t* w_idx, const uint8_t* w_sel,
                                 const float* w_inv, const float* cb, const float* s_x,
                                 float* out, int M, int N, int K, float cw_max, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % LA) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  bcq_linear_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w_idx, w_sel, w_inv, cb, s_x, out, M, N, K, cw_max);
  return static_cast<int>(cudaGetLastError());
}
