// Page-gather attention core for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/common.py:_page_gather_kernel
// (launched by page_gather_attention; wrappers paged_attention.py for
// decode, C == 1, and chunked_prefill.py for C > 1).  Computes, for
// q (B, C, H, D) f32, the online-softmax attention of each query over the
// pages its row's block table names:
//
//   query c of row b sits at qpos = kv_len[b] - C + c and sees page token
//   t iff t <= qpos (finite mask NEG = -1e30); a row walks
//   clip(ceil(kv_len / ps), 1, MAXP) pages, so a zero-length row still
//   takes one step and writes finite output; out = acc / max(l, 1e-30).
//
// Pages are dequantized in the kernel from the pool's own layout: bf16;
// int8 with a per-(token, head) f32 scale; or bcq4 nibble indices and
// selectors with E4M3 scale bits (decoded like bits_to_e4m3_impl) and the
// pool-global k_sx / v_sx, with L_A shrunk to d_head when d_head < 64.
//
// What bounds it on this card: the page bytes it must read.  A bcq4 page
// holds 4.6 bits per scalar, so even a 500-token row is ~0.1 MB per
// layer; at serving batch sizes the kernel is latency bound on the
// per-page loop, not on HBM.  Design: one block per (row b, kv head g,
// tile of 16 query vectors); the rep = H / Hkv query heads of a group
// share one dequantized page in shared memory (GQA without repeating
// K/V).  The block loops over only that row's live pages: dequantize the
// page's K and V for head g into shared memory, then each warp updates
// the online softmax of its four query vectors (lane = page token for the
// scores, lane = head dimension for the accumulator), with m, l and the
// accumulator in registers.  Query rows are tiled by 16, so shared
// memory stays bounded (< 42 KB) at any prefill chunk length.  Split-KV
// for long contexts and cp.async/TMA page pipelining are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int VPW = 4;               // query vectors per warp
constexpr int RB = WARPS * VPW;      // query vectors per block
constexpr int DPL = 4;               // head dims per lane (D <= 128)
constexpr int NE = 16;               // codebook entries
constexpr int NCB = 8;               // codebooks

enum Kind { BF16 = 0, INT8 = 1, BCQ4 = 2 };

__device__ __forceinline__ float pow2i(int e) { return __int_as_float((e + 127) << 23); }

// repro/core/formats.py:bits_to_e4m3_impl
__device__ __forceinline__ float bits_to_e4m3(int code) {
  const int code_e = code >> 3;
  const float man = static_cast<float>(code & 7);
  if (code_e == 0) return 0.015625f * (man * 0.125f);
  return pow2i(code_e - 7) * (1.f + man * 0.125f);
}

template <int KIND>
__device__ __forceinline__ float dequant(const void* l0, const void* l1, const void* l2,
                                         const float* cb_s, float sx, size_t row, int d,
                                         int D, int la) {
  if (KIND == BF16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(l0)[row * D + d]);
  } else if (KIND == INT8) {
    const float v = static_cast<float>(static_cast<const int8_t*>(l0)[row * D + d]);
    return __fmul_rn(v, static_cast<const float*>(l1)[row]);
  } else {
    const uint8_t ib = static_cast<const uint8_t*>(l0)[row * (D / 2) + d / 2];
    const int idx = d & 1 ? ib >> 4 : ib & 15;
    const int blk = d / 8;
    const uint8_t sb = static_cast<const uint8_t*>(l1)[row * (D / 16) + blk / 2];
    const int sel = blk & 1 ? sb >> 4 : sb & 15;
    const int code = static_cast<const uint8_t*>(l2)[row * (D / la) + d / la];
    const float ratio = bits_to_e4m3(code);
    const float inv = ratio > 0.f ? __fdiv_rn(1.f, __fmul_rn(ratio, sx)) : 0.f;
    return __fmul_rn(cb_s[sel * NE + idx], inv);
  }
}

template <int KIND>
__global__ void __launch_bounds__(THREADS) page_gather_kernel(
    const float* __restrict__ q, const void* k0, const void* k1, const void* k2,
    const void* v0, const void* v1, const void* v2, const float* __restrict__ k_sx_ptr,
    const float* __restrict__ v_sx_ptr, const float* __restrict__ cb,
    const int* __restrict__ block_tables, const int* __restrict__ kv_len,
    float* __restrict__ out, int C, int H, int Hkv, int D, int ps, int maxp, int la,
    float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;  // padded rows: lane-per-token reads hit distinct banks
  float* ks = smem;
  float* vs = ks + ps * ldk;
  float* qs = vs + ps * ldk;
  float* cb_s = qs + RB * D;

  const int b = blockIdx.x, g = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rep = H / Hkv;
  const int nv = C * rep;
  const int vbase = blockIdx.z * RB;

  for (int e = tid; e < RB * D; e += THREADS) {
    const int vi = e / D, d = e % D, v = vbase + vi;
    float val = 0.f;
    if (v < nv) {
      const int c = v / rep, h = g * rep + v % rep;
      val = q[((static_cast<size_t>(b) * C + c) * H + h) * D + d];
    }
    qs[e] = val;
  }
  float k_sx = 0.f, v_sx = 0.f;
  if (KIND == BCQ4) {
    for (int e = tid; e < NCB * NE; e += THREADS) cb_s[e] = cb[e];
    k_sx = *k_sx_ptr;
    v_sx = *v_sx_ptr;
  }

  const int len = kv_len[b];
  int steps = (len + ps - 1) / ps;
  steps = steps < 1 ? 1 : (steps > maxp ? maxp : steps);

  float m[VPW], l[VPW], acc[VPW][DPL];
#pragma unroll
  for (int i = 0; i < VPW; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  for (int j = 0; j < steps; ++j) {
    const size_t pid = static_cast<size_t>(block_tables[static_cast<size_t>(b) * maxp + j]);
    __syncthreads();  // the previous page's readers are done
    for (int e = tid; e < ps * D; e += THREADS) {
      const int t = e / D, d = e % D;
      const size_t row = (pid * ps + t) * Hkv + g;
      ks[t * ldk + d] = dequant<KIND>(k0, k1, k2, cb_s, k_sx, row, d, D, la);
      vs[t * ldk + d] = dequant<KIND>(v0, v1, v2, cb_s, v_sx, row, d, D, la);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < VPW; ++i) {
      const int vi = warp * VPW + i, v = vbase + vi;
      if (v >= nv) continue;  // warp-uniform
      const int qpos = len - C + v / rep;
      float s = -INFINITY;
      if (lane < ps) {
        const float* qr = qs + vi * D;
        const float* kr = ks + lane * ldk;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot += qr[d] * kr[d];
        s = j * ps + lane <= qpos ? dot * scale : NEG;
      }
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float p = lane < ps ? expf(s - m_new) : 0.f;
      float psum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + psum;
#pragma unroll
      for (int jd = 0; jd < DPL; ++jd) acc[i][jd] *= alpha;
      for (int t = 0; t < ps; ++t) {
        const float pt = __shfl_sync(0xffffffffu, p, t);
        const float* vr = vs + t * ldk;
#pragma unroll
        for (int jd = 0; jd < DPL; ++jd) {
          const int d = lane + 32 * jd;
          if (d < D) acc[i][jd] += pt * vr[d];
        }
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < VPW; ++i) {
    const int v = vbase + warp * VPW + i;
    if (v >= nv) continue;
    const int c = v / rep, h = g * rep + v % rep;
    const float den = fmaxf(l[i], 1e-30f);
    float* o = out + ((static_cast<size_t>(b) * C + c) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < DPL; ++jd) {
      const int d = lane + 32 * jd;
      if (d < D) o[d] = acc[i][jd] / den;
    }
  }
}

}  // namespace

// Plain C entry: launches on ``stream``, allocates nothing, returns the
// launch status (cudaGetLastError).  kind: 0 bf16, 1 int8, 2 bcq4.  Pool
// leaves are one layer's (P, ps, Hkv, ...) contiguous tensors (k1/k2 and
// v1/v2 unused for bf16; k2/v2 unused for int8).  Requires ps <= 32,
// D <= 128, D % 16 == 0 and D % la == 0; the wrapper checks.
extern "C" int page_gather_launch(int kind, const float* q, const void* k0, const void* k1,
                                  const void* k2, const void* v0, const void* v1,
                                  const void* v2, const float* k_sx, const float* v_sx,
                                  const float* cb, const int* block_tables, const int* kv_len,
                                  float* out, int B, int C, int H, int Hkv, int D, int ps,
                                  int maxp, int la, float scale, void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv || ps <= 0 || ps > 32 || D <= 0 ||
      D > DPL * 32 || D % 16 || la <= 0 || D % la || maxp <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nv = C * (H / Hkv);
  const dim3 grid(B, Hkv, (nv + RB - 1) / RB);
  const size_t smem = (2 * ps * (D + 1) + RB * D + NCB * NE) * sizeof(float);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == BF16)
    page_gather_kernel<BF16><<<grid, THREADS, smem, st>>>(q, k0, k1, k2, v0, v1, v2, k_sx, v_sx,
                                                           cb, block_tables, kv_len, out, C, H,
                                                           Hkv, D, ps, maxp, la, scale);
  else if (kind == INT8)
    page_gather_kernel<INT8><<<grid, THREADS, smem, st>>>(q, k0, k1, k2, v0, v1, v2, k_sx, v_sx,
                                                           cb, block_tables, kv_len, out, C, H,
                                                           Hkv, D, ps, maxp, la, scale);
  else if (kind == BCQ4)
    page_gather_kernel<BCQ4><<<grid, THREADS, smem, st>>>(q, k0, k1, k2, v0, v1, v2, k_sx, v_sx,
                                                           cb, block_tables, kv_len, out, C, H,
                                                           Hkv, D, ps, maxp, la, scale);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
