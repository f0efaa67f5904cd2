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
// with the encode of repro/kernels/common.py:encode_tile.  The kernel is
// bcq_encode.cuh's encode pass, shared with the fused linear's first
// launch, so the two W4A4 routes encode bit-identically by construction.
//
// What bounds it on this card: its bytes, once the index is a table
// lookup (bcq_encode.cuh): per scalar and codebook one shared-memory read
// and three error operations (32 f32 operations a scalar) against 4 bytes
// read and ~0.6 written.  Design: one thread per 8-scalar block, the 8
// blocks of an array on 8 neighbouring lanes (the amax is a 3-step
// shuffle), the index tables in shared memory, built once per block of
// threads for the many arrays of its grid-stride loop; every thread loads
// its 8 scalars as two float4 and stores its 8 packed indices as one
// 32-bit word, and the even lane of each block pair stores the pair's
// selector byte, so the stores stay contiguous across the warp.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bcq_encode.cuh"

namespace {

using bcq::LA;
using bcq::LB;

// Stores block g as packed indices, a packed selector byte per block pair
// and the array's ratio.
struct PackedOut {
  uint32_t* idx;
  uint8_t* sel;
  float* ratio;
  __device__ void operator()(long long g, const uint32_t (&ent)[LB], int s, int pair,
                             float r, float) const {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < LB; ++i) word |= bcq::entry_idx(ent[i]) << (4 * i);
    idx[g] = word;
    if ((g & 1) == 0) sel[g / 2] = static_cast<uint8_t>(s | (pair << 4));
    if ((g & 7) == 0) ratio[g / 8] = r;
  }
};

}  // namespace

// Plain C entry: launches on ``stream``, allocates nothing, returns the
// launch status (cudaGetLastError).  Requires K % 64 == 0, 16-byte
// aligned x and 4-byte aligned idx (fresh torch allocations are) and the
// paper config (L_A 64, L_b 8, 16 entries, 8 integer codebooks); the
// wrapper checks.
extern "C" int bcq_quantize_launch(const float* x, const float* cb, const float* s_x,
                                   uint8_t* idx, uint8_t* sel, float* ratio, int M, int K,
                                   float cw_max, void* stream) {
  if (M <= 0 || K <= 0 || K % LA) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = static_cast<long long>(M) * (K / LB);
  const PackedOut out{reinterpret_cast<uint32_t*>(idx), sel, ratio};
  bcq::encode_kernel<<<bcq::encode_grid(n_blocks), bcq::ENC_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(x, cb, s_x, out, n_blocks, cw_max);
  return static_cast<int>(cudaGetLastError());
}
