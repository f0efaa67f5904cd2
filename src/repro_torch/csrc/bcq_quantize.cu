// LO-BCQ encode of an operand for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bcq_quantize.py:_quantize_kernel
// (launched by bcq_quantize_pallas, reached through ops.quantize and
// ops.w4a4_linear).  Encodes x f32 (M, K) with the per-tensor scale s_x
// the caller reduced:
//
//     idx   u8  (M, K/2)   codeword indices, two nibbles a byte, low first
//     sel   u8  (M, K/16)  codebook selectors, two nibbles a byte
//     ratio f32 (M, K/64)  E4M3-snapped s_A / s_X per 64-scalar array
//
// with the encode of repro/kernels/common.py:encode_tile (bcq_encode.cuh,
// shared with the fused linear, so the two encode bit-identically).
//
// What bounds it on this card: its compares, not its bytes.  Each scalar
// takes 15 threshold compares and three error operations under each of
// the 8 codebooks (144 f32 operations) against 4 bytes read and ~0.6
// written, so at 67 TFLOP/s of f32 the operations outweigh 3.35 TB/s of
// HBM about 1.5 to 1.  Design: one thread per 8-scalar block, the 8
// blocks of an array on 8 neighbouring lanes (the amax is a 3-step
// shuffle), codebooks and thresholds in shared memory; every thread
// loads its 8 scalars as two float4 and stores its 8 packed indices as
// one 32-bit word, and the even lane of each block pair stores the pair's
// selector byte, so the stores stay contiguous across the warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bcq_encode.cuh"

namespace {

using bcq::LA;
using bcq::LB;
using bcq::NC;
using bcq::NE;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) bcq_quantize_kernel(
    const float* __restrict__ x, const float* __restrict__ cb,
    const float* __restrict__ s_x_ptr, uint32_t* __restrict__ idx_out,
    uint8_t* __restrict__ sel_out, float* __restrict__ ratio_out, long long n_blocks,
    float cw_max) {
  __shared__ float cb_s[NC * NE];
  __shared__ float thr_s[NC * (NE - 1)];
  const int tid = threadIdx.x;
  bcq::load_tables(cb, cb_s, thr_s, tid);
  __syncthreads();
  const float s_x = *s_x_ptr;

  // block g holds scalars [8g, 8g + 8) of the row-major (M, K) operand;
  // K % 64 == 0, so an array never straddles two rows and g & 7 is the
  // block's place in its array (= lane & 7, as encode_block needs)
  const long long g = static_cast<long long>(blockIdx.x) * THREADS + tid;
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
  int idx[LB], sel;
  float ratio, scale;
  bcq::encode_block(y, cb_s, thr_s, s_x, cw_max, idx, sel, ratio, scale);

  const int pair = __shfl_down_sync(0xffffffffu, sel, 1);
  if (!live) return;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < LB; ++i) word |= static_cast<uint32_t>(idx[i]) << (4 * i);
  idx_out[g] = word;
  if ((g & 1) == 0) sel_out[g / 2] = static_cast<uint8_t>(sel | (pair << 4));
  if ((g & 7) == 0) ratio_out[g / 8] = ratio;
}

}  // namespace

// Plain C entry: launches on ``stream``, allocates nothing, returns the
// launch status (cudaGetLastError).  Requires K % 64 == 0, 16-byte
// aligned x and 4-byte aligned idx (fresh torch allocations are) and the
// paper config (L_A 64, L_b 8, 16 entries, 8 codebooks); the wrapper
// checks.
extern "C" int bcq_quantize_launch(const float* x, const float* cb, const float* s_x,
                                   uint8_t* idx, uint8_t* sel, float* ratio, int M, int K,
                                   float cw_max, void* stream) {
  if (M <= 0 || K <= 0 || K % LA) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = static_cast<long long>(M) * (K / LB);
  const unsigned grid = static_cast<unsigned>((n_blocks + THREADS - 1) / THREADS);
  bcq_quantize_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, cb, s_x, reinterpret_cast<uint32_t*>(idx), sel, ratio, n_blocks, cw_max);
  return static_cast<int>(cudaGetLastError());
}
