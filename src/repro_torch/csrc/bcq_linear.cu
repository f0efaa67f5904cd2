// Fused W4A4 LO-BCQ linear for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bcq_linear.py:_fused_kernel
// (launched by bcq_linear_pallas).  Computes
//
//     out (M, N) f32 = Â · Ŵᵀ,
//
// where Â is the LO-BCQ encode-decode of the raw activation x (M, K) with
// the per-tensor scale s_x the caller reduced, and Ŵ decodes from the
// packed weight bytes: w_idx (N, K/2) nibbles, w_sel (N, K/16) selector
// nibbles, w_inv (N, K/64) f32 dequant scales.  The encode follows
// repro/kernels/common.py:encode_tile (bcq_encode.cuh).
//
// What bounds it on this card: at decode (M = n_slots = 8) the packed
// weight stream (4.5 bits per weight, a few hundred KB per linear, well
// under a microsecond of HBM time), so the kernel is latency bound; at
// evaluation and prefill (M up to 8192) the int8 product (2·M·N·K
// operations at 1979 TOP/s) and the f32 output it writes, with the encode
// of x (32 f32 operations a scalar) well below either.
//
// Every LO-BCQ format the reference's kernel takes runs here: the default
// (L_A 64, L_b 8, 16 entries, N_c 8, INT6) through the table encode and
// the specialised GEMM below, any other through the threshold-search
// encode and the general GEMM (bcq_encode.cuh, bcq_gemm.cuh: gemm_fmt),
// the format passed at run time.
//
// Design: two launches behind this one C entry, on one stream.
//
// 1. The encode pass (bcq_encode.cuh's encode_kernel) touches each
//    activation scalar once: it writes the int8 codewords cb[sel][idx]
//    (M, K) and a_inv = 1 / (ratio · s_x) (M, K/64) into a workspace the
//    wrapper allocates.  A scalar's nearest entries in the 8 codebooks are
//    two 128-bit reads of a banked shared-memory table.
// 2. The GEMM (bcq_gemm.cuh, shared with bcq_matmul.cu) reads those codes
//    as its A operand and decodes W's packed tiles through an int8 table;
//    each 64-wide array is an exact int32 product on the int8 tensor cores
//    (mma.sync m16n8k32), folded into f32 by one fixed expression.
//
// The expert-stacked form (bcq_linear_experts_launch) computes E of these
// linears at once, one per expert of a mixture-of-experts layer, all
// sharing the caller's s_x: x (E, C, K) rows against E packed weights
// (E, N, K) gives out (E, C, N).  Its encode pass is the same one pass
// over all E·C rows (a row's codes do not depend on its neighbours); its
// GEMM is the same kernel with blockIdx.z as the expert, each expert's
// pointers offset by its stride, and the tile shape chosen by C — so
// every expert's output has the bits of its own launch, and a layer's
// 64 experts cost one launch pair, not 64.
//
// Two launches, not one persistent cooperative launch with a grid-wide
// barrier between the passes: the encode is a grid-stride pass over x with
// its own block size and no shared state with the GEMM, a cooperative
// launch would cap the GEMM's grid at the blocks resident at once, and
// the second launch costs a few microseconds that the decode path (72
// linears a tick, host bound) does not see.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bcq_encode.cuh"
#include "bcq_gemm.cuh"

namespace {

using bcq::LA;
using bcq::LB;

// Reads block g of x; stores its 8 int8 codewords and, once per array,
// its dequant scale 1 / (ratio · s_x).
struct CodesIo : bcq::RowMajorIn {
  uint2* codes;
  float* a_inv;
  __device__ void store_codes(long long g, const uint32_t (&ent)[LB]) const {
    uint2 c;
    c.x = bcq::entry_code(ent[0]) | bcq::entry_code(ent[1]) << 8 |
          bcq::entry_code(ent[2]) << 16 | bcq::entry_code(ent[3]) << 24;
    c.y = bcq::entry_code(ent[4]) | bcq::entry_code(ent[5]) << 8 |
          bcq::entry_code(ent[6]) << 16 | bcq::entry_code(ent[7]) << 24;
    codes[g] = c;
  }
  __device__ void store(long long g, long long, const uint32_t (&ent)[LB], int, int, float,
                        float scale) const {
    store_codes(g, ent);
    if ((g & 7) == 0) a_inv[g / 8] = __fdiv_rn(1.f, scale);
  }
  __device__ void store_fmt(long long g, long long, const uint32_t (&ent)[LB], uint32_t, float,
                            float scale, const bcq::Fmt& f) const {
    store_codes(g, ent);
    if ((g & (f.lanes - 1)) == 0) a_inv[g >> f.sh] = __fdiv_rn(1.f, scale);
  }
};

// The encode pass and the GEMM of E · C rows (C a GEMM, E of them stacked
// on grid z) in the format (lb, la, nc, ne): the table encode or the
// threshold search (table), the specialised GEMM or gemm_fmt (special).
int linear(const float* x, const uint8_t* w_idx, const uint8_t* w_sel, const float* w_inv,
           const float* cb, const float* s_x, int8_t* codes, float* a_inv, float* out, int E,
           int C, int N, int K, float cw_max, int lb, int la, int nc, int ne, int table,
           int special, cudaStream_t st) {
  const long long n_blocks = static_cast<long long>(E) * C * (K / LB);
  CodesIo enc;
  enc.x = x;
  enc.s_x = s_x;
  enc.codes = reinterpret_cast<uint2*>(codes);
  enc.a_inv = a_inv;
  const bcq::Fmt f = bcq::make_fmt(la, nc, ne, lb);
  cudaError_t e = table ? bcq::encode_launch<bcq::TABLE>(enc, cb, n_blocks, cw_max, f, st)
                        : bcq::encode_launch<bcq::SEARCH>(enc, cb, n_blocks, cw_max, f, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bcq::Operand a{codes, nullptr, nullptr, a_inv, nullptr};
  const bcq::Operand w{nullptr, w_idx, w_sel, w_inv, cb};
  if (special) return static_cast<int>(bcq::gemm<true>(a, w, out, C, N, K, st, E));
  return static_cast<int>(
      bcq::gemm_fmt<true>(a, w, out, C, N, K, bcq::GemmFmt{la, lb, nc, ne}, st, E));
}

// The routes a format can take: the table and the specialised GEMM only in
// the default format, the table only with |codeword| ≤ 31.
bool route_ok(int lb, int la, int nc, int ne, float cw_max, int table, int special) {
  const bool dflt = bcq::default_format(lb, la, nc, ne);
  return (!table || (dflt && cw_max <= 31.f)) && (!special || dflt);
}

}  // namespace

// Plain C entry: launches the encode pass and the GEMM on ``stream``,
// allocates nothing (codes (M, K) int8 and a_inv (M, K/la) f32 are the
// caller's workspace), returns the launch status (cudaGetLastError).
// Requires K % 64 == 0 and K % la == 0, 16-byte aligned x, w_idx and
// codes, 4-byte aligned w_sel, a format (lb, la, nc, ne) the kernels take
// (bcq_encode.cuh: format_ok) and nc × ne integer codebooks within
// ±cw_max ≤ 127; the wrapper checks.  table, special: the route
// (core/bcq.kernel_route); one the format cannot take is refused.
extern "C" int bcq_linear_launch(const float* x, const uint8_t* w_idx, const uint8_t* w_sel,
                                 const float* w_inv, const float* cb, const float* s_x,
                                 int8_t* codes, float* a_inv, float* out, int M, int N, int K,
                                 float cw_max, int lb, int la, int nc, int ne, int table,
                                 int special, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % LA || !bcq::format_ok(lb, la, nc, ne) || K % la ||
      !route_ok(lb, la, nc, ne, cw_max, table, special))
    return static_cast<int>(cudaErrorInvalidValue);
  return linear(x, w_idx, w_sel, w_inv, cb, s_x, codes, a_inv, out, 1, M, N, K, cw_max, lb, la,
                nc, ne, table, special, static_cast<cudaStream_t>(stream));
}

// Plain C entry of the expert-stacked form: E linears of C rows each,
// x (E, C, K) f32 against w_idx (E, N, K/2), w_sel (E, N, K/(2·lb)), w_inv
// (E, N, K/la), one s_x for all; codes (E·C, K) and a_inv (E·C, K/la) are
// the caller's workspace, out (E, C, N).  Returns the launch status.
// Requires 1 ≤ E ≤ 65535 and what bcq_linear_launch requires.
extern "C" int bcq_linear_experts_launch(const float* x, const uint8_t* w_idx,
                                         const uint8_t* w_sel, const float* w_inv,
                                         const float* cb, const float* s_x, int8_t* codes,
                                         float* a_inv, float* out, int E, int C, int N, int K,
                                         float cw_max, int lb, int la, int nc, int ne,
                                         int table, int special, void* stream) {
  if (E <= 0 || E > 65535 || C <= 0 || N <= 0 || K <= 0 || K % LA ||
      !bcq::format_ok(lb, la, nc, ne) || K % la ||
      !route_ok(lb, la, nc, ne, cw_max, table, special))
    return static_cast<int>(cudaErrorInvalidValue);
  return linear(x, w_idx, w_sel, w_inv, cb, s_x, codes, a_inv, out, E, C, N, K, cw_max, lb, la,
                nc, ne, table, special, static_cast<cudaStream_t>(stream));
}
