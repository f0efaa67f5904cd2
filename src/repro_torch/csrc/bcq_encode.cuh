// LO-BCQ encode and packed-operand decode, shared by the W4A4 kernels
// (bcq_linear.cu, bcq_quantize.cu, bcq_matmul.cu).
//
// Device counterparts of repro/kernels/common.py: encode_tile (per-array
// amax, ratio = e4m3_snap(s_a / s_x), 15 threshold compares per scalar
// and codebook, a strict-< running argmin over the codebooks per 8-scalar
// block) and of the packed decode cb[sel · 16 + idx] · inv.
//
// Bit-exactness with the plain PyTorch encode: every product and sum
// that feeds a compare or a stored value uses the _rn intrinsics, so no
// multiply-add is contracted into an FMA; the block error is summed left
// to right; rintf rounds half to even like torch.round.  Build without
// --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bcq {

constexpr int LA = 64;  // L_A: scalars per block array
constexpr int LB = 8;   // L_b: scalars per block
constexpr int NE = 16;  // 2^B codebook entries
constexpr int NC = 8;   // N_c codebooks

__device__ __forceinline__ float pow2i(int e) { return __int_as_float((e + 127) << 23); }

// E4M3 round to nearest even for positive values, clamped to [2^-9, 448]
// (repro/kernels/common.py: e4m3_snap).
__device__ __forceinline__ float e4m3_snap(float a) {
  float e = floorf(log2f(fmaxf(a, 1e-38f)));
  e = fminf(fmaxf(e, -6.f), 8.f);
  const float ulp = pow2i(static_cast<int>(e) - 3);
  float q = __fmul_rn(rintf(__fdiv_rn(a, ulp)), ulp);
  q = fminf(q, 448.f);
  return fmaxf(q, 0.001953125f);
}

// Stage the codebooks (NC × NE) and their midpoint thresholds
// (NC × (NE − 1)) in shared memory; needs at least NC · NE threads and
// leaves the tables readable after the caller's next __syncthreads().
__device__ __forceinline__ void load_tables(const float* __restrict__ cb, float* cb_s,
                                            float* thr_s, int tid) {
  if (tid < NC * NE) cb_s[tid] = cb[tid];
  __syncthreads();
  if (tid < NC * (NE - 1)) {
    const int c = tid / (NE - 1), t = tid % (NE - 1);
    thr_s[tid] = 0.5f * (cb_s[c * NE + t] + cb_s[c * NE + t + 1]);
  }
}

// Encode one 8-scalar block y in place of a thread.  The 8 blocks of a
// 64-scalar array must sit on 8 neighbouring lanes (lane & 7 = block of
// the array), and every lane of the warp must call (full-mask shuffles).
// On return: idx the nearest entry per scalar of codebook sel, ratio the
// array's E4M3-snapped s_a / s_x, scale = ratio · s_x (y is left scaled).
__device__ __forceinline__ void encode_block(float (&y)[LB], const float* cb_s,
                                             const float* thr_s, float s_x, float cw_max,
                                             int (&idx)[LB], int& sel, float& ratio,
                                             float& scale) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < LB; ++i) amax = fmaxf(amax, fabsf(y[i]));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s_a = amax > 0.f ? __fdiv_rn(cw_max, amax) : s_x;
  ratio = e4m3_snap(__fdiv_rn(s_a, s_x));
  scale = __fmul_rn(ratio, s_x);
#pragma unroll
  for (int i = 0; i < LB; ++i) y[i] = __fmul_rn(y[i], scale);

  float best = INFINITY;
  sel = 0;
#pragma unroll
  for (int i = 0; i < LB; ++i) idx[i] = 0;
  for (int c = 0; c < NC; ++c) {
    int id[LB];
    float err = 0.f;
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      int k = 0;
#pragma unroll
      for (int t = 0; t < NE - 1; ++t) k += y[i] >= thr_s[c * (NE - 1) + t];
      id[i] = k;
      const float d = __fsub_rn(y[i], cb_s[c * NE + k]);
      err = __fadd_rn(err, __fmul_rn(d, d));
    }
    if (err < best) {
      best = err;
      sel = c;
#pragma unroll
      for (int i = 0; i < LB; ++i) idx[i] = id[i];
    }
  }
}

// Decode 32 scalars (half of one array: 4 blocks) of a packed operand row
// into dst[0], dst[stride], ..., dst[31 · stride].  ib: the 16 index
// bytes (two nibbles each, low nibble first), sb: the 2 selector bytes of
// those 4 blocks, inv: the array's dequant scale 1 / (ŝ_A · s_X).
__device__ __forceinline__ void decode_half(const uint8_t* __restrict__ ib,
                                            const uint8_t* __restrict__ sb, float inv,
                                            const float* cb_s, float* dst, int stride) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const uint8_t byte = ib[j];
    const uint8_t sbyte = sb[j / 8];
    const int sel = (j / 4) & 1 ? sbyte >> 4 : sbyte & 15;
    dst[(2 * j) * stride] = __fmul_rn(cb_s[sel * NE + (byte & 15)], inv);
    dst[(2 * j + 1) * stride] = __fmul_rn(cb_s[sel * NE + (byte >> 4)], inv);
  }
}

}  // namespace bcq
