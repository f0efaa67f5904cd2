// W4A4 GEMM of two packed LO-BCQ operands for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bcq_matmul.py:_matmul_kernel
// (helper _decode_tile; launched by bcq_matmul_pallas, reached through
// ops.matmul and ops.w4a4_linear).  Computes
//
//     out (M, N) f32 = Â · Ŵᵀ,   Â[m, k] = cb_a[sel · 16 + idx] · a_inv[m, k / 64]
//                               Ŵ[n, k] = cb_w[sel · 16 + idx] · w_inv[n, k / 64]
//
// from packed rows: idx u8 (R, K/2) nibbles, sel u8 (R, K/(2·L_b))
// selector nibbles, inv f32 (R, K/L_A) dequant scales 1 / (ŝ_A · s_X), in
// any LO-BCQ format the reference's kernel takes (L_A 64 and 16 above for
// the default's).
//
// What bounds it on this card: at the evaluation shape (M 8192, K 768,
// N 3072) its bytes, the f32 output above all (100 MB against 5 MB of
// packed operands), with the int8 product (38.7 G operations) close
// behind.  Design: the fused linear's GEMM (bcq_gemm.cuh) with A packed
// too: both operands' packed tiles are staged by cp.async and decoded
// through int8 tables into swizzled shared-memory rows, each 64-wide
// array is an exact int32 product on the int8 tensor cores (mma.sync
// m16n8k32), folded into f32 by the same expression as the fused linear,
// so the two W4A4 routes give the same bits from the same codes.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bcq_gemm.cuh"

// Plain C entry: launches on ``stream``, allocates nothing, returns the
// launch status (cudaGetLastError).  Requires K % 64 == 0 and K % la ==
// 0, 16-byte aligned idx and 4-byte aligned sel, and a format (lb, la, nc,
// ne) the kernels take with nc × ne integer codebooks within ±127: the
// default (L_A 64, L_b 8, 16 entries, N_c 8) through the specialised GEMM
// when special (core/bcq.kernel_route), any format through gemm_fmt; the
// wrapper checks.
extern "C" int bcq_matmul_launch(const uint8_t* a_idx, const uint8_t* a_sel, const float* a_inv,
                                 const uint8_t* w_idx, const uint8_t* w_sel, const float* w_inv,
                                 const float* cb_a, const float* cb_w, float* out, int M, int N,
                                 int K, int lb, int la, int nc, int ne, int special,
                                 void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % bcq::LA || !bcq::format_ok(lb, la, nc, ne) || K % la ||
      (special && !bcq::default_format(lb, la, nc, ne)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bcq::Operand a{nullptr, a_idx, a_sel, a_inv, cb_a};
  const bcq::Operand w{nullptr, w_idx, w_sel, w_inv, cb_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (special)
    return static_cast<int>(bcq::gemm<false>(a, w, out, M, N, K, st));
  return static_cast<int>(bcq::gemm_fmt<false>(a, w, out, M, N, K, bcq::GemmFmt{la, lb, nc, ne}, st));
}
