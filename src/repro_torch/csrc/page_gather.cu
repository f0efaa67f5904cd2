// Page-gather attention core for Hopper (sm_90a), split over the KV pages.
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
// layer; at serving batch sizes the kernel is bound by latency (dependent
// loads, launches), not by HBM.  The design spreads that latency over
// the card instead of walking a row's pages in series:
//
// * Split-KV, two launches.  A row's walked pages are cut into splits of
//   ``split_pages`` pages (a constant of the wrapper, so a row's result
//   depends only on its own data).  page_gather_split_kernel runs one
//   block per (split, row b, kv head g, tile of NQ query vectors) and
//   writes the split's partial (m, l, acc) to a scratch tensor the
//   wrapper allocates; page_gather_combine_kernel merges a vector's
//   partials in ascending split order into out.  No atomics: the result
//   has the same bits run to run, whatever order the blocks run in.
// * Inside a split, one page per warp: warp w takes the split's pages w,
//   w + 4, …, so all four warps work at C = 1.  Each warp keeps its own
//   (m, l, acc) for the block's NQ query vectors (the rep = H / Hkv heads
//   of group g, times the chunk's queries: GQA without repeating K/V);
//   the four warps' states merge in warp order through shared memory at
//   the end of the split.
// * Per page, a warp copies the page's K and V rows for head g into its
//   own shared memory with cp.async (16-byte chunks where the row allows,
//   else 8), loads the per-token side data (bcq4 selectors and scale
//   codes, int8 scales) into registers, then dequantizes 8 dims a lane at
//   a time into f32 tiles.  The bcq4 inverse scale 1 / (ratio · s_x) is
//   computed once per (token, array), not per scalar.  The next page's
//   copies start right after the dequant, so they fly during this
//   page's math: scores with lane = token, the softmax update by warp
//   shuffles, then P·V with lane = head dimension.
// * Chunked prefill (C > 1) takes the same split as decode, with query
//   tiles of 16 vectors (4 at decode).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr float NEG = -1e30f;
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int DPL = 4;  // head dims per lane in P·V (D <= 128)
constexpr int NE = 16;  // codebook entries
constexpr int NCB = 8;  // codebooks

enum Kind { BF16 = 0, INT8 = 1, BCQ4 = 2 };

__device__ __forceinline__ float pow2i(int e) { return __int_as_float((e + 127) << 23); }

// repro/core/formats.py:bits_to_e4m3_impl
__device__ __forceinline__ float bits_to_e4m3(int code) {
  const int code_e = code >> 3;
  const float man = static_cast<float>(code & 7);
  if (code_e == 0) return 0.015625f * (man * 0.125f);
  return pow2i(code_e - 7) * (1.f + man * 0.125f);
}

// 1 / (ratio · s_x) of one bcq4 array, 0 for a zero ratio.
__device__ __forceinline__ float bcq4_inv(int code, float sx) {
  const float ratio = bits_to_e4m3(code);
  return ratio > 0.f ? __fdiv_rn(1.f, __fmul_rn(ratio, sx)) : 0.f;
}

__host__ __device__ __forceinline__ int align16(int n) { return (n + 15) & ~15; }

// Bytes of one row (token, head) of a pool's first leaf.
__host__ __device__ __forceinline__ int row_bytes(int kind, int D) {
  return kind == BF16 ? 2 * D : kind == INT8 ? D : D / 2;
}

// Shared memory: q tile (NQ × D f32), the bcq4 codebooks (128 f32), then
// one region per warp: raw K and V page rows, per-token side data (16
// bytes a token for K and for V), and the f32 K and V tiles (ps rows of
// D + 1), which the warp's partial state (NQ × (D + 2)) reuses at the end.
struct Layout {
  int raw, side, tiles, warp, total;
  __host__ __device__ Layout(int kind, int D, int ps, int nq) {
    raw = align16(2 * ps * row_bytes(kind, D));
    side = 2 * ps * 16;
    const int t = 2 * ps * (D + 1), p = nq * (D + 2);
    tiles = align16(4 * (t > p ? t : p));
    warp = raw + side + tiles;
    total = 4 * nq * D + 4 * NCB * NE + WARPS * warp;
  }
};

struct Leaves {
  const uint8_t* l0;  // bf16 values, int8 values, or bcq4 nibble indices
  const uint8_t* l1;  // int8 f32 scales, or bcq4 selector nibbles
  const uint8_t* l2;  // bcq4 E4M3 scale codes
  const float* sx;    // bcq4 pool-global s_x (one f32 on the device)
};

// Side data of one token row, in registers between a page's load and its
// dequant: bcq4 selector bytes (up to 8) and scale codes (up to 2), or
// the int8 scale.
struct Side {
  uint32_t sel_lo, sel_hi;
  int code0, code1;
  float scale;
};

template <int KIND>
__device__ __forceinline__ void load_side(Side& sd, const Leaves& lv, size_t row, int D, int la) {
  if (KIND == INT8) {
    sd.scale = reinterpret_cast<const float*>(lv.l1)[row];
  } else if (KIND == BCQ4) {
    const int ns = D / 16, nc = D / la;
    const uint8_t* sp = lv.l1 + row * ns;
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < ns) {
        if (i < 4) lo |= static_cast<uint32_t>(sp[i]) << (8 * i);
        else hi |= static_cast<uint32_t>(sp[i]) << (8 * (i - 4));
      }
    sd.sel_lo = lo;
    sd.sel_hi = hi;
    sd.code0 = lv.l2[row * nc];
    sd.code1 = nc > 1 ? lv.l2[row * nc + 1] : 0;
  }
}

// Side data to shared memory, per token: bcq4 {sel_lo, sel_hi, inv0,
// inv1} with each array's inverse scale computed once; int8 {scale}.
template <int KIND>
__device__ __forceinline__ void store_side(float4* dst, const Side& sd, float sx) {
  if (KIND == INT8)
    dst->x = sd.scale;
  else if (KIND == BCQ4)
    *dst = make_float4(__uint_as_float(sd.sel_lo), __uint_as_float(sd.sel_hi),
                       bcq4_inv(sd.code0, sx), bcq4_inv(sd.code1, sx));
}

// The 8 dims [8c, 8c + 8) of token t, from the raw row and side data, to
// the f32 tile row.
template <int KIND>
__device__ __forceinline__ void dequant8(float* dst, const uint8_t* raw, const float4& side,
                                         const float* cb_s, int c, int la) {
  if (KIND == BF16) {
    const uint4 w = *reinterpret_cast<const uint4*>(raw + 16 * c);
    const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[2 * i] = __uint_as_float(ws[i] << 16);
      dst[2 * i + 1] = __uint_as_float(ws[i] & 0xFFFF0000u);
    }
  } else if (KIND == INT8) {
    const uint2 w = *reinterpret_cast<const uint2*>(raw + 8 * c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int8_t x = static_cast<int8_t>(((i < 4 ? w.x : w.y) >> (8 * (i & 3))) & 0xFF);
      dst[i] = __fmul_rn(static_cast<float>(x), side.x);
    }
  } else {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(raw + 4 * c);
    const uint32_t sel64 = c < 8 ? __float_as_uint(side.x) : __float_as_uint(side.y);
    const int sel = (sel64 >> (4 * (c & 7))) & 15;
    const float inv = (8 * c) / la == 0 ? side.z : side.w;
    const float* row = cb_s + sel * NE;
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[i] = __fmul_rn(row[(w >> (4 * i)) & 15], inv);
  }
}

template <int KIND, int NQ>
__global__ void __launch_bounds__(THREADS) page_gather_split_kernel(
    const float* __restrict__ q, Leaves kl, Leaves vl, const float* __restrict__ cb,
    const int* __restrict__ block_tables, const int* __restrict__ kv_len,
    float* __restrict__ part, int C, int H, int Hkv, int D, int ps, int maxp, int la,
    int split_pages, int n_split, float scale) {
  const int len = kv_len[blockIdx.y / Hkv];
  int steps = (len + ps - 1) / ps;
  steps = steps < 1 ? 1 : (steps > maxp ? maxp : steps);
  const int sp0 = blockIdx.x * split_pages;
  if (sp0 >= steps) return;  // the row has fewer splits (whole block)
  const int sp1 = min(sp0 + split_pages, steps);

  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(KIND, D, ps, NQ);
  float* q_s = reinterpret_cast<float*>(smem);
  float* cb_s = q_s + NQ * D;
  const int b = blockIdx.y / Hkv, g = blockIdx.y % Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  unsigned char* wbase = smem + 4 * NQ * D + 4 * NCB * NE + warp * lay.warp;
  uint8_t* raw_k = wbase;
  uint8_t* raw_v = raw_k + ps * row_bytes(KIND, D);
  float4* side_k = reinterpret_cast<float4*>(wbase + lay.raw);
  float4* side_v = side_k + ps;
  float* kt = reinterpret_cast<float*>(wbase + lay.raw + lay.side);
  const int ldt = D + 1;  // padded rows: lane-per-token reads hit distinct banks
  float* vt = kt + ps * ldt;

  const int rep = H / Hkv;
  const int nv = C * rep;
  const int vbase = blockIdx.z * NQ;
  for (int e = tid; e < NQ * D; e += THREADS) {
    const int vi = e / D, d = e % D, v = vbase + vi;
    float val = 0.f;
    if (v < nv) {
      const int c = v / rep, h = g * rep + v % rep;
      val = q[((static_cast<size_t>(b) * C + c) * H + h) * D + d];
    }
    q_s[e] = val;
  }
  float sxk = 0.f, sxv = 0.f;
  if (KIND == BCQ4) {
    for (int e = tid; e < NCB * NE; e += THREADS) cb_s[e] = cb[e];
    sxk = *kl.sx;
    sxv = *vl.sx;
  }
  __syncthreads();

  // ---- the warp's pages: sp0 + warp, + 4, … (ids preloaded, one a lane)
  const int n_mine = sp0 + warp < sp1 ? (sp1 - sp0 - warp + WARPS - 1) / WARPS : 0;
  const int my_page = sp0 + warp + WARPS * lane;
  const int my_pid = lane < n_mine ? block_tables[static_cast<size_t>(b) * maxp + my_page] : 0;
  const int rb = row_bytes(KIND, D);
  const int chunk = rb % 16 == 0 ? 16 : 8;
  const int cpr = rb / chunk;  // chunks per row

  Side sk{}, sv{};
  auto load_page = [&](int i) {  // copies and side loads of the warp's i-th page
    const size_t pid = static_cast<size_t>(__shfl_sync(0xffffffffu, my_pid, i));
    for (int e = lane; e < ps * cpr; e += 32) {
      const int t = e / cpr, c = e % cpr;
      const size_t off = ((pid * ps + t) * Hkv + g) * rb + c * chunk;
      if (chunk == 16) {
        ptx::cp_async16(raw_k + t * rb + c * 16, kl.l0 + off, true);
        ptx::cp_async16(raw_v + t * rb + c * 16, vl.l0 + off, true);
      } else {
        ptx::cp_async8(raw_k + t * rb + c * 8, kl.l0 + off, true);
        ptx::cp_async8(raw_v + t * rb + c * 8, vl.l0 + off, true);
      }
    }
    ptx::cp_async_commit();
    if (lane < ps) {
      const size_t row = (pid * ps + lane) * Hkv + g;
      load_side<KIND>(sk, kl, row, D, la);
      load_side<KIND>(sv, vl, row, D, la);
    }
  };

  float m[NQ], l[NQ], acc[NQ][DPL];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  if (n_mine > 0) load_page(0);
  for (int i = 0; i < n_mine; ++i) {
    const int tok0 = (sp0 + warp + WARPS * i) * ps;
    ptx::cp_async_wait<0>();
    if (lane < ps) {
      store_side<KIND>(side_k + lane, sk, sxk);
      store_side<KIND>(side_v + lane, sv, sxv);
    }
    __syncwarp();
    for (int u = lane; u < ps * (D / 8); u += 32) {
      const int t = u / (D / 8), c = u % (D / 8);
      dequant8<KIND>(kt + t * ldt + 8 * c, raw_k + t * rb, side_k[t], cb_s, c, la);
      dequant8<KIND>(vt + t * ldt + 8 * c, raw_v + t * rb, side_v[t], cb_s, c, la);
    }
    __syncwarp();
    if (i + 1 < n_mine) load_page(i + 1);  // in flight during this page's math

    // ---- scores: lane = page token ----
    float dot[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k) dot[k] = 0.f;
    if (lane < ps) {
      const float* kr = kt + lane * ldt;
      for (int d = 0; d < D; d += 4) {
        const float k0 = kr[d], k1 = kr[d + 1], k2 = kr[d + 2], k3 = kr[d + 3];
#pragma unroll
        for (int k = 0; k < NQ; ++k) {
          const float4 qv = *reinterpret_cast<const float4*>(q_s + k * D + d);
          dot[k] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
        }
      }
    }
    // ---- online softmax per query vector ----
    float p[NQ];
#pragma unroll
    for (int k = 0; k < NQ; ++k) {
      p[k] = 0.f;
      const int v = vbase + k;
      if (v >= nv) continue;  // warp-uniform
      const int qpos = len - C + v / rep;
      float s = -INFINITY;
      if (lane < ps) s = tok0 + lane <= qpos ? dot[k] * scale : NEG;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[k], mx);
      p[k] = lane < ps ? expf(s - m_new) : 0.f;
      float psum = p[k];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      const float alpha = expf(m[k] - m_new);
      l[k] = l[k] * alpha + psum;
      m[k] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[k][j] *= alpha;
    }
    // ---- acc += P · V: lane = head dimension ----
    for (int t = 0; t < ps; ++t) {
      const float* vr = vt + t * ldt;
      float vd[DPL];
#pragma unroll
      for (int j = 0; j < DPL; ++j) vd[j] = lane + 32 * j < D ? vr[lane + 32 * j] : 0.f;
#pragma unroll
      for (int k = 0; k < NQ; ++k) {
        const float pt = __shfl_sync(0xffffffffu, p[k], t);
#pragma unroll
        for (int j = 0; j < DPL; ++j) acc[k][j] += pt * vd[j];
      }
    }
    __syncwarp();  // the tiles are rewritten by the next page
  }

  // ---- the four warps' states merge in warp order ----
  float* mine = kt;  // NQ × (D + 2): m, l, acc
#pragma unroll
  for (int k = 0; k < NQ; ++k) {
    if (lane == 0) {
      mine[k * (D + 2)] = m[k];
      mine[k * (D + 2) + 1] = l[k];
    }
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (lane + 32 * j < D) mine[k * (D + 2) + 2 + lane + 32 * j] = acc[k][j];
  }
  __syncthreads();
  const float* wpart[WARPS];
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    wpart[w] = reinterpret_cast<const float*>(smem + 4 * NQ * D + 4 * NCB * NE + w * lay.warp +
                                              lay.raw + lay.side);
  for (int e = tid; e < NQ * (D + 2); e += THREADS) {
    const int k = e / (D + 2), x = e % (D + 2), v = vbase + k;
    if (v >= nv) continue;
    float mx = NEG;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) mx = fmaxf(mx, wpart[w][k * (D + 2)]);
    float r = mx;
    if (x > 0) {
      r = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w)
        r += wpart[w][k * (D + 2) + x] * expf(wpart[w][k * (D + 2)] - mx);
    }
    const int c = v / rep, h = g * rep + v % rep;
    const size_t vec = (static_cast<size_t>(b) * C + c) * H + h;
    part[(vec * n_split + blockIdx.x) * (D + 2) + x] = r;
  }
}

// One warp per query vector: merge its splits' (m, l, acc) in ascending
// split order, out = acc / max(l, 1e-30).
__global__ void __launch_bounds__(THREADS) page_gather_combine_kernel(
    const float* __restrict__ part, const int* __restrict__ kv_len, float* __restrict__ out,
    int n_vec, int CH, int D, int ps, int maxp, int split_pages, int n_split) {
  const int vec = blockIdx.x * WARPS + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (vec >= n_vec) return;
  const int len = kv_len[vec / CH];
  int steps = (len + ps - 1) / ps;
  steps = steps < 1 ? 1 : (steps > maxp ? maxp : steps);
  const int ns = (steps + split_pages - 1) / split_pages;
  const float* pv = part + static_cast<size_t>(vec) * n_split * (D + 2);
  float mx = NEG;
  for (int s = 0; s < ns; ++s) mx = fmaxf(mx, pv[s * (D + 2)]);
  float l = 0.f, acc[DPL] = {};
  for (int s = 0; s < ns; ++s) {
    const float* ps_ = pv + s * (D + 2);
    const float w = expf(ps_[0] - mx);
    l += ps_[1] * w;
#pragma unroll
    for (int j = 0; j < DPL; ++j)
      if (lane + 32 * j < D) acc[j] += ps_[2 + lane + 32 * j] * w;
  }
  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int j = 0; j < DPL; ++j)
    if (lane + 32 * j < D) out[static_cast<size_t>(vec) * D + lane + 32 * j] = acc[j] / den;
}

template <int KIND, int NQ>
int launch_split(const dim3& grid, size_t smem, cudaStream_t st, const float* q, Leaves kl,
                 Leaves vl, const float* cb, const int* bt, const int* kv_len, float* part,
                 int C, int H, int Hkv, int D, int ps, int maxp, int la, int split_pages,
                 int n_split, float scale) {
  auto kern = page_gather_split_kernel<KIND, NQ>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<grid, THREADS, smem, st>>>(q, kl, vl, cb, bt, kv_len, part, C, H, Hkv, D, ps, maxp, la,
                                    split_pages, n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NQ>
int launch_kind(int kind, const dim3& grid, size_t smem, cudaStream_t st, const float* q,
                Leaves kl, Leaves vl, const float* cb, const int* bt, const int* kv_len,
                float* part, int C, int H, int Hkv, int D, int ps, int maxp, int la,
                int split_pages, int n_split, float scale) {
  if (kind == BF16)
    return launch_split<BF16, NQ>(grid, smem, st, q, kl, vl, cb, bt, kv_len, part, C, H, Hkv, D,
                                  ps, maxp, la, split_pages, n_split, scale);
  if (kind == INT8)
    return launch_split<INT8, NQ>(grid, smem, st, q, kl, vl, cb, bt, kv_len, part, C, H, Hkv, D,
                                  ps, maxp, la, split_pages, n_split, scale);
  if (kind == BCQ4)
    return launch_split<BCQ4, NQ>(grid, smem, st, q, kl, vl, cb, bt, kv_len, part, C, H, Hkv, D,
                                  ps, maxp, la, split_pages, n_split, scale);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Plain C entry: two launches on ``stream`` (the split kernel, then the
// combine), allocates nothing, returns the launch status
// (cudaGetLastError).  kind: 0 bf16, 1 int8, 2 bcq4.  Pool leaves are one
// layer's (P, ps, Hkv, ...) contiguous tensors (k1/k2 and v1/v2 unused for
// bf16; k2/v2 unused for int8), k0/v0 16-byte aligned.  ``part`` is
// scratch of B·C·H · ceil(MAXP / split_pages) · (D + 2) f32.  Requires
// ps <= 32, D <= 128, D % 16 == 0, D % la == 0, la % 8 == 0 and
// split_pages in [1, 128]; the wrapper checks.
extern "C" int page_gather_launch(int kind, const float* q, const void* k0, const void* k1,
                                  const void* k2, const void* v0, const void* v1,
                                  const void* v2, const float* k_sx, const float* v_sx,
                                  const float* cb, const int* block_tables, const int* kv_len,
                                  float* out, float* part, int B, int C, int H, int Hkv, int D,
                                  int ps, int maxp, int la, int split_pages, float scale,
                                  void* stream) {
  if (B <= 0 || C <= 0 || Hkv <= 0 || H % Hkv || ps <= 0 || ps > 32 || D <= 0 ||
      D > DPL * 32 || D % 16 || la <= 0 || D % la || la % 8 || maxp <= 0 || split_pages <= 0 ||
      split_pages > 128 || static_cast<long long>(B) * Hkv > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Leaves kl{static_cast<const uint8_t*>(k0), static_cast<const uint8_t*>(k1),
                  static_cast<const uint8_t*>(k2), k_sx};
  const Leaves vl{static_cast<const uint8_t*>(v0), static_cast<const uint8_t*>(v1),
                  static_cast<const uint8_t*>(v2), v_sx};
  const int nv = C * (H / Hkv);
  const int n_split = (maxp + split_pages - 1) / split_pages;
  const int nq = nv <= 4 ? 4 : 16;
  const dim3 grid(n_split, B * Hkv, (nv + nq - 1) / nq);
  if (grid.z > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout(kind, D, ps, nq).total;
  const int status =
      nq == 4 ? launch_kind<4>(kind, grid, smem, st, q, kl, vl, cb, block_tables, kv_len, part,
                               C, H, Hkv, D, ps, maxp, la, split_pages, n_split, scale)
              : launch_kind<16>(kind, grid, smem, st, q, kl, vl, cb, block_tables, kv_len, part,
                                C, H, Hkv, D, ps, maxp, la, split_pages, n_split, scale);
  if (status != 0) return status;
  const int n_vec = B * C * H;
  page_gather_combine_kernel<<<(n_vec + WARPS - 1) / WARPS, THREADS, 0, st>>>(
      part, kv_len, out, n_vec, C * H, D, ps, maxp, split_pages, n_split);
  return static_cast<int>(cudaGetLastError());
}
