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
// search instead (ThrTables, encode_block_thr8): for any f32 levels,
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
// (core/bcq.check_kernel_codebooks, core/bcq.kernel_route): integer books
// keep the table.
//
// Every other LO-BCQ format takes the threshold search too (Fmt), all at
// run time: L_b ∈ {2, 4, 8}, L_A ∈ {16, 32, 64, 128}, N_c ≤ 16 codebooks
// of 2^B ∈ {4, 8, 16} entries and any B_c ≤ 8.  A thread still encodes 8
// scalars: 8 / L_b blocks, each with its own strict-< running argmin over
// the codebooks in ascending order and its error summed left to right, so
// the bits are the reference's; an array spans L_A / 8 lanes.  The blocks'
// running minima sit in 4 registers, each updated by a predicated compare
// where its block ends (no register array indexed at run time, and one
// kernel a form: the cold build).  The tables are padded to 16 × 16 (a codebook's
// row stride stays 16; padding is never a threshold's neighbour), and the
// winner's entries carry the int8 code as the table's do, for B1's GEMM
// and the page writer.  The table path stays the default format's
// (L_b 8, 16 entries, N_c 8, |codeword| ≤ 31: the rows floor(2y) ∈
// [-64, 63]), bit for bit.  B3's quantize form keeps a third path for
// trained books in the default format (SEARCH8, encode_block_thr8): the
// same search with N_c 8, 16 entries and L_b 8 fixed at compile time, its
// codebook loop and its grid-stride loop unrolled — at run time the
// search's loops do not unroll, and on an H100 (700 W) at (8192, 768) it
// took 1.65× the time (chip_route_study.py).
//
// Which path a launch takes is the caller's (core/bcq.kernel_route): the
// C entries are told the route and refuse one their format cannot take.
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
constexpr int MAX_NC = 16;   // the general path's codebooks, at most
constexpr int MAX_NE = 16;   // and entries: a codebook's row stride in its tables

// The format of the threshold search, at run time: L_A, its lanes (L_A / 8
// scalars a thread, 1 << sh), N_c, 2^B and L_b.  The table path reads only
// lanes (L_A 16, 32, 64 or 128 at L_b 8, N_c 8, 16 entries).
struct Fmt {
  int la, lanes, sh, nc, ne, lb;
};

inline Fmt make_fmt(int la, int nc, int ne, int lb = 8) {
  int sh = 0;
  while ((8 << sh) < la) ++sh;
  return {la, 1 << sh, sh, nc, ne, lb};
}

struct Tables {
  float4 val_lo[LUT_N * VAL_COPIES];  // codebooks 0-3 per row
  float4 val_hi[LUT_N * VAL_COPIES];  // codebooks 4-7 per row
  uint32_t ent[NC * LUT_N];           // (codebook, row) entries
  float thr2[NC * NE];                // 2·thr per codebook (15 used), while building
};

// The threshold search's tables, a row of 16 per codebook: the 2^B − 1
// sums l[i] + l[i+1] (+inf past them) and the 2^B levels (0 past them).
struct ThrTables {
  float thr2[MAX_NC * MAX_NE];
  float lv[MAX_NC * MAX_NE];
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

// The number of a sorted codebook's doubled thresholds thr2[0..ne − 1)
// that are ≤ v: the index of the entry nearest v / 2, in log2(ne)
// halvings (4 for 16 entries; a step of ne or more is skipped, so the
// loop unrolls whatever ne is).  NaN passes no threshold.
__device__ __forceinline__ int thr_count(const float* thr2, float v, int ne = NE) {
  int k = 0;
#pragma unroll
  for (int step = MAX_NE / 2; step > 0; step >>= 1)
    if (step < ne) k += thr2[k + step - 1] <= v ? step : 0;
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

// The threshold search's tables from the f32 codebooks (nc × ne) in
// device memory; every thread of the block must call, readable after the
// caller's next __syncthreads().
__device__ __forceinline__ void load_thr_tables(const float* __restrict__ cb, ThrTables& t,
                                                int tid, int nthreads, int nc, int ne) {
  for (int i = tid; i < MAX_NC * MAX_NE; i += nthreads) {
    const int c = i / MAX_NE, e = i % MAX_NE;
    const bool in = c < nc && e < ne;
    t.thr2[i] = in && e < ne - 1 ? __fadd_rn(cb[c * ne + e], cb[c * ne + e + 1]) : INFINITY;
    t.lv[i] = in ? cb[c * ne + e] : 0.f;
  }
}

// The array's scales for one 8-scalar block y of a thread: ratio the
// array's E4M3-snapped s_a / s_x, scale = ratio · s_x.  The blocks of an
// array sit on ``lanes`` neighbouring lanes (lanes = L_A / 8, a power of
// two ≤ 16, aligned to it), and every lane of the warp must call
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

// Encode one 8-scalar block y of a thread through the threshold search in
// the default format (N_c 8, 16 entries, L_b 8 at compile time; any sorted
// f32 levels).  The same outputs as encode_block, but ent holds the index
// alone (no int8 code): the quantize form's store reads nothing else.
__device__ __forceinline__ void encode_block_thr8(const float (&y)[LB], const ThrTables& t,
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
      const float w = t.lv[cb * MAX_NE + thr_count(t.thr2 + cb * MAX_NE, y2[i])];
      const float d = __fsub_rn(yi, w);
      err[cb] = i == 0 ? __fmul_rn(d, d) : __fadd_rn(err[cb], __fmul_rn(d, d));
    }
  }
  sel = argmin_codebook(err);
#pragma unroll
  for (int i = 0; i < LB; ++i)
    ent[i] = static_cast<uint32_t>(thr_count(t.thr2 + sel * MAX_NE, y2[i]));
}

// Encode the 8 scalars y of a thread through the threshold search (any
// sorted f32 codebooks of the format f; the notes at the top): 8 / L_b
// blocks of L_b scalars.  On return: ent the chosen entry per scalar (the
// index, and the int8 code of an integer level in bits 4–11, as the
// table's entries), sb the blocks' selectors as nibbles (block 0 lowest),
// ratio and scale as array_scales.
__device__ __forceinline__ void encode_block_thr(const float (&y)[LB], const ThrTables& t,
                                                 float s_x, float cw_max, const Fmt& f,
                                                 uint32_t (&ent)[LB], uint32_t& sb,
                                                 float& ratio, float& scale) {
  constexpr int NB = LB / 2;  // blocks of a thread, at most (L_b 2)
  array_scales(y, s_x, cw_max, f.lanes, ratio, scale);
  float yv[LB], y2[LB];
#pragma unroll
  for (int i = 0; i < LB; ++i) {
    yv[i] = __fmul_rn(y[i], scale);
    y2[i] = __fadd_rn(yv[i], yv[i]);
  }
  const int m = f.lb - 1, lsh = f.lb == 8 ? 3 : f.lb == 4 ? 2 : 1;  // L_b = 1 << lsh
  float best[NB];
  int sel[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    best[j] = INFINITY;
    sel[j] = 0;
  }
  for (int c = 0; c < f.nc; ++c) {  // ascending: the strict < keeps the first minimum
    const float* th = t.thr2 + c * MAX_NE;
    const float* lv = t.lv + c * MAX_NE;
    float err = 0.f;
#pragma unroll
    for (int s = 0; s < LB; ++s) {  // left to right over each block
      const float d = __fsub_rn(yv[s], lv[thr_count(th, y2[s], f.ne)]);
      err = (s & m) == 0 ? __fmul_rn(d, d) : __fadd_rn(err, __fmul_rn(d, d));
      if ((s & m) == m) {  // block s / L_b ends here
        const int j = s >> lsh;
#pragma unroll
        for (int jj = 0; jj < NB; ++jj)
          if (jj == j && err < best[jj]) {
            best[jj] = err;
            sel[jj] = c;
          }
      }
    }
  }
  sb = 0;
#pragma unroll
  for (int j = 0; j < NB; ++j) sb |= static_cast<uint32_t>(sel[j]) << (4 * j);  // 0 past the blocks
#pragma unroll
  for (int s = 0; s < LB; ++s) {
    const int j = s >> lsh;
    int sj = sel[0];
#pragma unroll
    for (int jj = 1; jj < NB; ++jj) sj = jj == j ? sel[jj] : sj;
    const int row = sj * MAX_NE;
    const int k = thr_count(t.thr2 + row, y2[s], f.ne);
    const uint32_t code =
        static_cast<uint8_t>(static_cast<int8_t>(__float2int_rn(t.lv[row + k])));
    ent[s] = (code << 4) | static_cast<uint32_t>(k);
  }
}

// The encode pass: one thread per 8 scalars (a "block" g below: one
// L_b block at L_b 8), a grid-stride loop so that each block of threads
// builds its tables once for many arrays.  ``Io`` moves the data:
//
//     long long load(long long g, long long n, float (&y)[LB], float& s_x)
//         block g's 8 scalars (zeros for g ≥ n, or where nothing is read)
//         and its per-tensor scale; returns a job < 0 when block g is not
//         stored, else a value ``store`` understands;
//     void store(long long g, long long job, const uint32_t (&ent)[LB],
//                int sel, int pair_sel, float ratio, float scale)
//         stores block g (pair_sel: block g + 1's selector, for packed
//         selector bytes) — the table path's store (L_A 64 but for the
//         page writer, which reads its own L_A);
//     void store_fmt(long long g, long long job, const uint32_t (&ent)[LB],
//                uint32_t sb, float ratio, float scale, const Fmt& f)
//         the threshold search's: sb the selector nibbles of the 8 / L_b
//         blocks (at L_b 8, block g + 1's in the high nibble).
//
// Blocks whose job is < 0 are encoded all the same (their lanes join the
// amax shuffles) and not stored.  The next step's loads are issued before
// this step's encode, so their latency hides behind it.  PATH: TABLE, the
// default format's integer codebooks; SEARCH8, the threshold search in the
// default format (``store``, as TABLE); SEARCH, the threshold search over
// any sorted f32 levels of the format f, its grid-stride loop not
// unrolled (the cold build).
enum EncodePath { TABLE = 0, SEARCH8 = 1, SEARCH = 2 };

template <class Io, int PATH>
__global__ void __launch_bounds__(ENC_THREADS) encode_kernel(Io io, const float* __restrict__ cb,
                                                             long long n_blocks, float cw_max,
                                                             Fmt f) {
  __shared__ typename std::conditional<PATH == TABLE, Tables, ThrTables>::type tab;
  if constexpr (PATH == TABLE)
    load_tables(cb, tab, threadIdx.x, ENC_THREADS);
  else
    load_thr_tables(cb, tab, threadIdx.x, ENC_THREADS, f.nc, f.ne);
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * ENC_THREADS;
  long long g = static_cast<long long>(blockIdx.x) * ENC_THREADS + threadIdx.x;
  float y[LB], s_x;
  long long job = io.load(g, n_blocks, y, s_x);
  // g - threadIdx.x is the same for every lane: the loop is warp-uniform
#pragma unroll(PATH == SEARCH ? 1 : 2)
  for (; g - threadIdx.x < n_blocks; g += stride) {
    float nxt[LB], nxt_sx;
    const long long nxt_job = io.load(g + stride, n_blocks, nxt, nxt_sx);
    uint32_t ent[LB];
    float ratio, scale;
    if constexpr (PATH == SEARCH) {
      uint32_t sb;
      encode_block_thr(y, tab, s_x, cw_max, f, ent, sb, ratio, scale);
      if (f.lb == LB) sb |= __shfl_down_sync(FULL, sb, 1) << 4;  // warp-uniform
      if (job >= 0) io.store_fmt(g, job, ent, sb, ratio, scale, f);
    } else {
      int sel;
      if constexpr (PATH == TABLE)
        encode_block(y, tab, s_x, cw_max, f.lanes, ent, sel, ratio, scale);
      else
        encode_block_thr8(y, tab, s_x, cw_max, f.lanes, ent, sel, ratio, scale);
      const int pair = __shfl_down_sync(FULL, sel, 1);
      if (job >= 0) io.store(g, job, ent, sel, pair, ratio, scale);
    }
#pragma unroll
    for (int i = 0; i < LB; ++i) y[i] = nxt[i];
    s_x = nxt_sx;
    job = nxt_job;
  }
}

// Stores the selector nibbles ``sb`` of block g (8 scalars: 8 / lb
// blocks) into a row-major run of packed selector bytes, two nibbles a
// byte: at L_b 8 the even block stores its pair's byte.
__device__ __forceinline__ void store_sel(uint8_t* sel, long long g, uint32_t sb, int lb) {
  if (lb == 8) {
    if ((g & 1) == 0) sel[g / 2] = static_cast<uint8_t>(sb);
  } else if (lb == 4) {
    sel[g] = static_cast<uint8_t>(sb);
  } else {
    reinterpret_cast<uint16_t*>(sel)[g] = static_cast<uint16_t>(sb);
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
template <class Io, int PATH>
inline unsigned encode_grid(long long n_blocks) {
  static int per_sm[16], sms[16];  // per device, filled on first use
  int dev = 0;
  cudaGetDevice(&dev);
  int fit = 8 * 132;
  if (dev < 16) {
    if (per_sm[dev] == 0) {
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[dev], encode_kernel<Io, PATH>,
                                                    ENC_THREADS, 0);
    }
    fit = per_sm[dev] > 0 ? per_sm[dev] * sms[dev] : fit;
  }
  const long long need = (n_blocks + ENC_THREADS - 1) / ENC_THREADS;
  return static_cast<unsigned>(need < fit ? need : fit);
}

// Launch the encode pass over n_blocks blocks of 8 scalars on the path
// PATH in the format f.
template <int PATH, class Io>
inline cudaError_t encode_launch(const Io& io, const float* cb, long long n_blocks, float cw_max,
                                 const Fmt& f, cudaStream_t stream) {
  encode_kernel<Io, PATH><<<encode_grid<Io, PATH>(n_blocks), ENC_THREADS, 0, stream>>>(
      io, cb, n_blocks, cw_max, f);
  return cudaGetLastError();
}

// Whether a format is one the kernels take: L_b ∈ {2, 4, 8}, L_A ∈ {16,
// 32, 64, 128} a multiple of 2 · L_b, N_c ≤ 16, 2^B ∈ {4, 8, 16} (the
// wrappers check the same, core/bcq.check_kernel_config).
inline bool format_ok(int lb, int la, int nc, int ne) {
  return (lb == 2 || lb == 4 || lb == 8) && (la == 16 || la == 32 || la == 64 || la == 128) &&
         la % (2 * lb) == 0 && nc >= 1 && nc <= MAX_NC && (ne == 4 || ne == 8 || ne == 16);
}

// Whether (lb, la, nc, ne) is the default format (L_b 8, L_A 64, N_c 8, 16
// entries), the one the compiled-in paths take: the table (with |codeword|
// ≤ 31), SEARCH8, the specialised GEMM.
inline bool default_format(int lb, int la, int nc, int ne) {
  return lb == LB && la == LA && nc == NC && ne == NE;
}

}  // namespace bcq
