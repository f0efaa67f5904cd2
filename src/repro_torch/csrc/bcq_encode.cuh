// LO-BCQ encode, shared by the W4A4 kernels (bcq_linear.cu's encode pass,
// bcq_quantize.cu).
//
// Device counterpart of repro/kernels/common.py: encode_tile: per-array
// amax, ratio = e4m3_snap(s_a / s_x), the nearest entry of each codebook
// per scalar, a strict-< running argmin over the codebooks per 8-scalar
// block.
//
// The nearest entry is one table lookup per scalar and codebook, not 15
// threshold compares.  Codewords are integers (core/bcq.CodebookSet checks
// it when the codebooks are loaded), so every midpoint threshold thr has
// an integer 2·thr, and doubling y is exact:
//
//     y ≥ thr  ⇔  2y ≥ 2·thr  ⇔  floor(2y) ≥ 2·thr,
//
// so idx_c(y) = LUT_c[clamp(floor(2y), -64, 63) + 64] with LUT_c[v] the
// number of thresholds whose 2·thr ≤ v − 64.  |2·thr| ≤ 62 for INT6
// codewords, so the clamp changes no count.  That is the k of 15
// threshold compares exactly, NaN included (fmaxf maps NaN to −64: no
// threshold passes).
// A table entry also carries its codeword, as f32 bits (an integer ≤ 31
// leaves the low 19 mantissa bits zero) with the int8 codeword in bits
// 4–11 and the index in bits 0–3, so one shared-memory read gives the
// index, the value the block error needs and the int8 code the W4A4 GEMM
// multiplies.
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

constexpr int LA = 64;       // L_A: scalars per block array
constexpr int LB = 8;        // L_b: scalars per block
constexpr int NE = 16;       // 2^B codebook entries
constexpr int NC = 8;        // N_c codebooks
constexpr int LUT_N = 128;   // table rows per codebook: floor(2y) in [-64, 63]
constexpr int ENC_THREADS = 256;

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

// A table entry's parts: the codeword as f32, its index, its int8 code.
__device__ __forceinline__ float entry_value(uint32_t e) { return __uint_as_float(e & 0xFFFFF000u); }
__device__ __forceinline__ uint32_t entry_idx(uint32_t e) { return e & 15u; }
__device__ __forceinline__ uint32_t entry_code(uint32_t e) { return (e >> 4) & 0xFFu; }

// Build the index tables (NC × LUT_N entries, see the note above) in
// shared memory from the f32 codebooks (NC × NE) in device memory; the
// tables are readable after the caller's next __syncthreads().
__device__ __forceinline__ void load_tables(const float* __restrict__ cb, uint32_t* lut_s,
                                            int tid, int nthreads) {
  for (int i = tid; i < NC * LUT_N; i += nthreads) {
    const int c = i / LUT_N;
    const float v = static_cast<float>(i % LUT_N - 64);
    int k = 0;
#pragma unroll
    for (int t = 0; t < NE - 1; ++t) k += v >= __fadd_rn(cb[c * NE + t], cb[c * NE + t + 1]);
    const float w = cb[c * NE + k];
    const uint32_t code = static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(w)));
    lut_s[i] = __float_as_uint(w) | (code << 4) | static_cast<uint32_t>(k);
  }
}

// Encode one 8-scalar block y in place of a thread.  The 8 blocks of a
// 64-scalar array must sit on 8 neighbouring lanes (lane & 7 = block of
// the array), and every lane of the warp must call (full-mask shuffles).
// On return: ent the table entry of the chosen codebook per scalar (index
// and code), sel that codebook, ratio the array's E4M3-snapped s_a / s_x,
// scale = ratio · s_x (y is left scaled).
__device__ __forceinline__ void encode_block(float (&y)[LB], const uint32_t* lut_s, float s_x,
                                             float cw_max, uint32_t (&ent)[LB], int& sel,
                                             float& ratio, float& scale) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < LB; ++i) amax = fmaxf(amax, fabsf(y[i]));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s_a = amax > 0.f ? __fdiv_rn(cw_max, amax) : s_x;
  ratio = e4m3_snap(__fdiv_rn(s_a, s_x));
  scale = __fmul_rn(ratio, s_x);
  int v[LB];
#pragma unroll
  for (int i = 0; i < LB; ++i) {
    y[i] = __fmul_rn(y[i], scale);
    // floor(2y) + 64 from the low mantissa bits: adding 1.5·2^23 + 64
    // rounding down leaves floor(c) + 64 in bits 0–6 for c in [-64, 63]
    const float c = fminf(fmaxf(__fadd_rn(y[i], y[i]), -64.f), 63.f);
    v[i] = __float_as_int(__fadd_rd(c, 12582976.f)) & (LUT_N - 1);
  }

  float best = INFINITY;
  sel = 0;
#pragma unroll
  for (int i = 0; i < LB; ++i) ent[i] = lut_s[0];  // codebook 0, entry 0
  for (int c = 0; c < NC; ++c) {
    uint32_t e[LB];
    float err = 0.f;
#pragma unroll
    for (int i = 0; i < LB; ++i) {
      e[i] = lut_s[c * LUT_N + v[i]];
      const float d = __fsub_rn(y[i], entry_value(e[i]));
      err = __fadd_rn(err, __fmul_rn(d, d));
    }
    if (err < best) {
      best = err;
      sel = c;
#pragma unroll
      for (int i = 0; i < LB; ++i) ent[i] = e[i];
    }
  }
}

// The encode pass: one thread per 8-scalar block of a row-major (M, K)
// f32 operand (K % 64 == 0, x 16-byte aligned), the 8 blocks of an array
// on 8 neighbouring lanes, a grid-stride loop so that each block of
// threads builds its tables once for many arrays.  ``out(g, ent, sel,
// pair_sel, ratio, scale)`` stores block g (pair_sel: block g + 1's
// selector, for packed selector bytes).
template <class Out>
__global__ void __launch_bounds__(ENC_THREADS) encode_kernel(const float* __restrict__ x,
                                                             const float* __restrict__ cb,
                                                             const float* __restrict__ s_x_ptr,
                                                             Out out, long long n_blocks,
                                                             float cw_max) {
  __shared__ uint32_t lut_s[NC * LUT_N];
  load_tables(cb, lut_s, threadIdx.x, ENC_THREADS);
  __syncthreads();
  const float s_x = *s_x_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * ENC_THREADS;
  for (long long g0 = static_cast<long long>(blockIdx.x) * ENC_THREADS; g0 < n_blocks;
       g0 += stride) {
    // K % 64 == 0, so an array never straddles two rows and g & 7 is the
    // block's place in its array (= lane & 7, as encode_block needs)
    const long long g = g0 + threadIdx.x;
    const bool live = g < n_blocks;
    float y[LB];
    if (live) {
      const float4* src = reinterpret_cast<const float4*>(x + g * LB);
      const float4 lo = src[0], hi = src[1];
      y[0] = lo.x; y[1] = lo.y; y[2] = lo.z; y[3] = lo.w;
      y[4] = hi.x; y[5] = hi.y; y[6] = hi.z; y[7] = hi.w;
    } else {
#pragma unroll
      for (int i = 0; i < LB; ++i) y[i] = 0.f;  // whole dead arrays: lanes still shuffle
    }
    uint32_t ent[LB];
    int sel;
    float ratio, scale;
    encode_block(y, lut_s, s_x, cw_max, ent, sel, ratio, scale);
    const int pair = __shfl_down_sync(0xffffffffu, sel, 1);
    if (live) out(g, ent, sel, pair, ratio, scale);
  }
}

// Grid of the encode pass: at most 8 blocks of threads per SM of an H100
// (132 SMs), each thread walking several 8-scalar blocks when x is large.
inline unsigned encode_grid(long long n_blocks) {
  const long long need = (n_blocks + ENC_THREADS - 1) / ENC_THREADS;
  return static_cast<unsigned>(need < 1056 ? need : 1056);
}

}  // namespace bcq
