// LO-BCQ encode, shared by the W4A4 kernels (bcq_linear.cu's encode pass,
// bcq_quantize.cu's quantize and bcq4 KV-page writer).
//
// Device counterpart of repro/kernels/common.py: encode_tile: per-array
// amax, ratio = e4m3_snap(s_a / s_x), the nearest entry of each codebook
// per scalar, a strict-< running argmin over the codebooks per 8-scalar
// block.
//
// The nearest entry is a table lookup, not 15 threshold compares, where
// the codewords are integers (core/bcq.check_kernel_codebooks checks it at
// the kernel's entry): every midpoint threshold thr then has an integer
// 2·thr, and doubling y is exact:
//
//     y ≥ thr  ⇔  2y ≥ 2·thr  ⇔  floor(2y) ≥ 2·thr,
//
// so the nearest entry of codebook c is a function of the table row
// v = clamp(floor(2y), -64, 63) + 64: the number of thresholds whose
// 2·thr ≤ v − 64.  |2·thr| ≤ 62 for INT6 codewords, so the clamp changes
// no count.  That is the k of 15 threshold compares exactly, NaN included
// (fmaxf maps NaN to row 0: no threshold passes).
//
// Two tables per block of threads, in shared memory (Tables):
//
// * val — for row v, the nearest codeword of every codebook as f32:
//   codebooks 0–3 in val_lo, 4–7 in val_hi, one 16-byte row each, so a
//   scalar's 8 candidates are two 128-bit loads.  A 128-bit shared load is
//   served a quarter warp (8 lanes, 128 bytes) at a time; each row is
//   stored VAL_COPIES times and lane l reads copy l & 7 at row·8 + (l & 7),
//   so the 8 lanes of a quarter warp read 8 different 16-byte bank groups
//   whatever their rows: no bank conflict.  (With one copy the row alone
//   picks the bank group, and lanes whose rows differ by a multiple of 8
//   wait on each other.)
// * ent — for (codebook c, row v) the entry: the codeword as f32 bits (an
//   integer ≤ 31 leaves the low 19 mantissa bits zero) with the int8
//   codeword in bits 4–11 and the index in bits 0–3.  It is read once per
//   scalar, for the winning codebook: the index for the packed forms, the
//   int8 code for the W4A4 GEMM.
//
// The running argmin keeps the error and the codebook only; the winner's
// entries are looked up after the last codebook.
//
// Trained codebooks (W4A4 fake-quant training updates them, so after a
// step their levels are sorted but no longer integers) take the threshold
// search instead (ThrTables, encode_block_thr): for any f32 levels,
// barring overflow and subnormal thresholds, doubling y is still exact and
// the reference's threshold 0.5·(l[i] + l[i+1]) is half of the f32 sum
// fadd_rn(l[i], l[i+1]), so
//
//     y ≥ thr  ⇔  2y ≥ fadd_rn(l[i], l[i+1]),
//
// the comparison the table encodes, now made per scalar: 4 halvings over
// a codebook's 15 sums for each of the 8 codebooks, then once more for the
// winner's indices.  That path gives indices only (the QuantizeIo form);
// the int8 codes of B1's GEMM and the page writer need integer levels.
// The caller picks the path from the codebook check at the kernel's entry
// (core/bcq.check_kernel_codebooks): integer books keep the table.
//
// Bit-exactness with the plain PyTorch encode: every product and sum
// that feeds a compare or a stored value uses the _rn intrinsics, so no
// multiply-add is contracted into an FMA; the block error is summed left
// to right; rintf rounds half to even like torch.round.  Build without
// --use_fast_math.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace bcq {

constexpr int LA = 64;       // L_A: scalars per block array
constexpr int LB = 8;        // L_b: scalars per block
constexpr int NE = 16;       // 2^B codebook entries
constexpr int NC = 8;        // N_c codebooks
constexpr int LUT_N = 128;   // table rows per codebook: floor(2y) in [-64, 63]
constexpr int ENC_THREADS = 256;
constexpr int VAL_COPIES = 8;   // one per lane of a quarter warp
constexpr unsigned FULL = 0xffffffffu;

struct Tables {
  float4 val_lo[LUT_N * VAL_COPIES];  // codebooks 0-3 per row
  float4 val_hi[LUT_N * VAL_COPIES];  // codebooks 4-7 per row
  uint32_t ent[NC * LUT_N];           // (codebook, row) entries
  float thr2[NC * NE];                // 2·thr per codebook (15 used), while building
};

// The threshold search's tables: per codebook the 15 sums l[i] + l[i+1]
// (the 16th +inf) and the 16 levels.
struct ThrTables {
  float thr2[NC * NE];
  float lv[NC * NE];
};

__device__ __forceinline__ float pow2i(int e) { return __int_as_float((e + 127) << 23); }

// Shared-memory loads at a 32-bit shared address (see encode_block).
__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float4 lds_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a));
  return v;
}
__device__ __forceinline__ uint32_t lds_u32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// E4M3 round to nearest even for positive values, clamped to [2^-9, 448]
// (repro/kernels/common.py: e4m3_snap).  The reference takes the exponent
// as floor(log2(a)); here it is a's exponent field, which differs only
// where a rounded log2 lands on the far side of an integer, i.e. for a
// within a few ulps of a power of two 2^k — and there both exponents k − 1
// and k round a to 2^k, so q is the same.  a / ulp is a product by the
// exact power of two 1 / ulp.
__device__ __forceinline__ float e4m3_snap(float a) {
  const int biased = (__float_as_int(fmaxf(a, 1e-38f)) >> 23) & 0xFF;
  const int e = min(max(biased - 127, -6), 8);
  float q = __fmul_rn(rintf(__fmul_rn(a, pow2i(3 - e))), pow2i(e - 3));
  q = fminf(q, 448.f);
  return fmaxf(q, 0.001953125f);
}

// The E4M3 bit pattern of an E4M3-grid ratio r in [2^-9, 448]
// (repro/core/formats.py: e4m3_to_bits): exponent and top 3 mantissa bits
// of r's f32 bits for normals, r · 2^9 for subnormals (r < 2^-6).
__device__ __forceinline__ uint32_t e4m3_bits(float r) {
  const uint32_t b = __float_as_uint(r);
  const int e = static_cast<int>(b >> 23) - 127;
  if (e < -6) return __float2uint_rn(__fmul_rn(r, 512.f));
  return static_cast<uint32_t>(e + 7) << 3 | ((b >> 20) & 7u);
}

// A table entry's parts: the codeword as f32, its index, its int8 code.
__device__ __forceinline__ float entry_value(uint32_t e) { return __uint_as_float(e & 0xFFFFF000u); }
__device__ __forceinline__ uint32_t entry_idx(uint32_t e) { return e & 15u; }
__device__ __forceinline__ uint32_t entry_code(uint32_t e) { return (e >> 4) & 0xFFu; }

// The number of a sorted codebook's doubled thresholds thr2[0..15) that
// are ≤ v (thr2[15] is +inf): the index of the entry nearest v / 2, in 4
// halvings.  NaN passes no threshold.
__device__ __forceinline__ int thr_count(const float* thr2, float v) {
  int k = 0;
#pragma unroll
  for (int step = NE / 2; step > 0; step >>= 1) k += thr2[k + step - 1] <= v ? step : 0;
  return k;
}

// Build the tables (see the note above) in shared memory from the f32
// codebooks (NC × NE) in device memory; every thread of the block must
// call, and the tables are readable after the caller's next
// __syncthreads().  First the doubled thresholds (the 16th +inf); then
// the entries, one per (codebook, row) on consecutive words; then each (row, copy) of val
// from the row's 8 entries, 128-bit stores on consecutive 16-byte slots —
// so no pass meets a bank conflict.  (Storing the copies straight from the
// entry pass puts a warp's 32 stores in one bank: on the card that build
// cost more than the conflict-free reads saved.)
__device__ __forceinline__ void load_tables(const float* __restrict__ cb, Tables& t, int tid,
                                            int nthreads) {
  for (int i = tid; i < NC * NE; i += nthreads)
    t.thr2[i] = i % NE < NE - 1 ? __fadd_rn(cb[i], cb[i + 1]) : INFINITY;
  __syncthreads();
  for (int i = tid; i < NC * LUT_N; i += nthreads) {
    const int c = i / LUT_N;
    const float v = static_cast<float>(i % LUT_N - 64);
    // the number of thresholds ≤ v: the codebooks are sorted (CodebookSet
    // checks it), so their thresholds are too and 4 halvings find it
    const int k = thr_count(t.thr2 + c * NE, v);
    const float w = cb[c * NE + k];
    const uint32_t code = static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(w)));
    t.ent[i] = __float_as_uint(w) | (code << 4) | static_cast<uint32_t>(k);
  }
  __syncthreads();
  for (int p = tid; p < LUT_N * VAL_COPIES; p += nthreads) {
    const int row = p / VAL_COPIES;
    float w[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) w[c] = entry_value(t.ent[c * LUT_N + row]);
    t.val_lo[p] = make_float4(w[0], w[1], w[2], w[3]);
    t.val_hi[p] = make_float4(w[4], w[5], w[6], w[7]);
  }
}

// The threshold search's tables from the f32 codebooks (NC × NE) in device
// memory; every thread of the block must call, readable after the
// caller's next __syncthreads().
__device__ __forceinline__ void load_thr_tables(const float* __restrict__ cb, ThrTables& t,
                                                int tid, int nthreads) {
  for (int i = tid; i < NC * NE; i += nthreads) {
    t.thr2[i] = i % NE < NE - 1 ? __fadd_rn(cb[i], cb[i + 1]) : INFINITY;
    t.lv[i] = cb[i];
  }
}

// The array's scales for one 8-scalar block y of a thread: ratio the
// array's E4M3-snapped s_a / s_x, scale = ratio · s_x.  The blocks of an
// array sit on ``lanes`` neighbouring lanes (lanes = L_A / 8, a power of
// two ≤ 8, aligned to it), and every lane of the warp must call
// (full-mask shuffles).
__device__ __forceinline__ void array_scales(const float (&y)[LB], float s_x, float cw_max,
                                             int lanes, float& ratio, float& scale) {
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < LB; ++i) amax = fmaxf(amax, fabsf(y[i]));
  for (int o = 1; o < lanes; o <<= 1) amax = fmaxf(amax, __shfl_xor_sync(FULL, amax, o));
  const float s_a = amax > 0.f ? __fdiv_rn(cw_max, amax) : s_x;
  ratio = e4m3_snap(__fdiv_rn(s_a, s_x));
  scale = __fmul_rn(ratio, s_x);
}

// The first codebook of least block error (a strict-< running argmin).
__device__ __forceinline__ int argmin_codebook(const float (&err)[NC]) {
  float best = INFINITY;
  int sel = 0;
#pragma unroll
  for (int cb = 0; cb < NC; ++cb) {
    if (err[cb] < best) {
      best = err[cb];
      sel = cb;
    }
  }
  return sel;
}

// Encode one 8-scalar block y of a thread through the tables of integer
// codebooks (see array_scales for the lanes).  On return: ent the table
// entry of the chosen codebook per scalar (index and code), sel that
// codebook, ratio and scale as array_scales.
__device__ __forceinline__ void encode_block(const float (&y)[LB], const Tables& t, float s_x,
                                             float cw_max, int lanes, uint32_t (&ent)[LB],
                                             int& sel, float& ratio, float& scale) {
  array_scales(y, s_x, cw_max, lanes, ratio, scale);

  // The table row v = floor(2y) + 64 comes as float bits: c + 1.5·2^23 +
  // 64 rounded down is the float 1.5·2^23 + floor(c) + 64 (spacing 1
  // there), whose bits are ROW0 + v for c in [-64, 63].  Shared addresses
  // are 32 bits, so base + v·stride = (base − ROW0·stride) + bits·stride
  // with the wrap-around cancelling: one multiply-add per address.
  constexpr uint32_t ROW0 = 0x4B400000u;
  const int copy = threadIdx.x & (VAL_COPIES - 1);
  const uint32_t vlo = smem(t.val_lo + copy) - ROW0 * (16u * VAL_COPIES);
  const uint32_t vhi = smem(t.val_hi + copy) - ROW0 * (16u * VAL_COPIES);
  float err[NC];
  uint32_t bits[LB];
#pragma unroll
  for (int i = 0; i < LB; ++i) {
    const float yi = __fmul_rn(y[i], scale);
    const float c = fminf(fmaxf(__fadd_rn(yi, yi), -64.f), 63.f);
    bits[i] = __float_as_uint(__fadd_rd(c, 12582976.f));
    const float4 lo = lds_f4(vlo + bits[i] * (16u * VAL_COPIES));
    const float4 hi = lds_f4(vhi + bits[i] * (16u * VAL_COPIES));
    const float w[NC] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int cb = 0; cb < NC; ++cb) {  // left to right over the block
      const float d = __fsub_rn(yi, w[cb]);
      err[cb] = i == 0 ? __fmul_rn(d, d) : __fadd_rn(err[cb], __fmul_rn(d, d));
    }
  }
  sel = argmin_codebook(err);
  const uint32_t ent_sel = smem(t.ent + sel * LUT_N) - ROW0 * 4u;
#pragma unroll
  for (int i = 0; i < LB; ++i) ent[i] = lds_u32(ent_sel + bits[i] * 4u);
}

// Encode one 8-scalar block y of a thread through the threshold search (any
// sorted f32 codebooks; the note at the top).  The same outputs as
// encode_block, but ent holds the index alone (no int8 code).
__device__ __forceinline__ void encode_block_thr(const float (&y)[LB], const ThrTables& t,
                                                 float s_x, float cw_max, int lanes,
                                                 uint32_t (&ent)[LB], int& sel, float& ratio,
                                                 float& scale) {
  array_scales(y, s_x, cw_max, lanes, ratio, scale);
  float err[NC], y2[LB];
#pragma unroll
  for (int i = 0; i < LB; ++i) {
    const float yi = __fmul_rn(y[i], scale);
    y2[i] = __fadd_rn(yi, yi);
#pragma unroll
    for (int cb = 0; cb < NC; ++cb) {  // left to right over the block
      const float w = t.lv[cb * NE + thr_count(t.thr2 + cb * NE, y2[i])];
      const float d = __fsub_rn(yi, w);
      err[cb] = i == 0 ? __fmul_rn(d, d) : __fadd_rn(err[cb], __fmul_rn(d, d));
    }
  }
  sel = argmin_codebook(err);
#pragma unroll
  for (int i = 0; i < LB; ++i) ent[i] = static_cast<uint32_t>(thr_count(t.thr2 + sel * NE, y2[i]));
}

// The encode pass: one thread per 8-scalar block, a grid-stride loop so
// that each block of threads builds its tables once for many arrays.
// ``Io`` moves the data:
//
//     long long load(long long g, long long n, float (&y)[LB], float& s_x)
//         block g's 8 scalars (zeros for g ≥ n, or where nothing is read)
//         and its per-tensor scale; returns a job < 0 when block g is not
//         stored, else a value ``store`` understands;
//     void store(long long g, long long job, const uint32_t (&ent)[LB],
//                int sel, int pair_sel, float ratio, float scale)
//         stores block g (pair_sel: block g + 1's selector, for packed
//         selector bytes).
//
// Blocks whose job is < 0 are encoded all the same (their lanes join the
// amax shuffles) and not stored.  The next step's loads are issued before
// this step's encode, so their latency hides behind it.  INT_BOOKS: the
// codebooks are integers (the tables); else any sorted f32 levels (the
// threshold search, indices only).
template <class Io, bool INT_BOOKS = true>
__global__ void __launch_bounds__(ENC_THREADS) encode_kernel(Io io, const float* __restrict__ cb,
                                                             long long n_blocks, float cw_max,
                                                             int lanes) {
  __shared__ typename std::conditional<INT_BOOKS, Tables, ThrTables>::type tab;
  if constexpr (INT_BOOKS)
    load_tables(cb, tab, threadIdx.x, ENC_THREADS);
  else
    load_thr_tables(cb, tab, threadIdx.x, ENC_THREADS);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * ENC_THREADS;
  long long g = static_cast<long long>(blockIdx.x) * ENC_THREADS + threadIdx.x;
  float y[LB], s_x;
  long long job = io.load(g, n_blocks, y, s_x);
  // g - threadIdx.x is the same for every lane: the loop is warp-uniform
#pragma unroll 2
  for (; g - threadIdx.x < n_blocks; g += stride) {
    float nxt[LB], nxt_sx;
    const long long nxt_job = io.load(g + stride, n_blocks, nxt, nxt_sx);
    uint32_t ent[LB];
    int sel;
    float ratio, scale;
    if constexpr (INT_BOOKS)
      encode_block(y, tab, s_x, cw_max, lanes, ent, sel, ratio, scale);
    else
      encode_block_thr(y, tab, s_x, cw_max, lanes, ent, sel, ratio, scale);
    const int pair = __shfl_down_sync(FULL, sel, 1);
    if (job >= 0) io.store(g, job, ent, sel, pair, ratio, scale);
#pragma unroll
    for (int i = 0; i < LB; ++i) y[i] = nxt[i];
    s_x = nxt_sx;
    job = nxt_job;
  }
}

// Reads block g of a row-major (M, K) f32 operand, K % 64 == 0 and x
// 16-byte aligned, with one per-tensor scale: the input of B1 and B3.
struct RowMajorIn {
  const float* __restrict__ x;
  const float* __restrict__ s_x;
  __device__ long long load(long long g, long long n, float (&y)[LB], float& sx) const {
    sx = *s_x;
    if (g >= n) {
#pragma unroll
      for (int i = 0; i < LB; ++i) y[i] = 0.f;  // whole dead arrays: lanes still shuffle
      return -1;
    }
    const float4* src = reinterpret_cast<const float4*>(x + g * LB);
    const float4 lo = src[0], hi = src[1];
    y[0] = lo.x; y[1] = lo.y; y[2] = lo.z; y[3] = lo.w;
    y[4] = hi.x; y[5] = hi.y; y[6] = hi.z; y[7] = hi.w;
    return 0;
  }
};

// Grid of the encode pass: as many blocks of threads as the card holds at
// once (each builds its tables once), fewer for small inputs.
template <class Io, bool INT_BOOKS = true>
inline unsigned encode_grid(long long n_blocks) {
  static int per_sm[16], sms[16];  // per device, filled on first use
  int dev = 0;
  cudaGetDevice(&dev);
  int fit = 8 * 132;
  if (dev < 16) {
    if (per_sm[dev] == 0) {
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev],
                                                    encode_kernel<Io, INT_BOOKS>, ENC_THREADS, 0);
    }
    fit = per_sm[dev] > 0 ? per_sm[dev] * sms[dev] : fit;
  }
  const long long need = (n_blocks + ENC_THREADS - 1) / ENC_THREADS;
  return static_cast<unsigned>(need < fit ? need : fit);
}

}  // namespace bcq
