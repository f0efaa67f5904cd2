// The W4A4 GEMM mainloop on the int8 tensor cores, shared by the fused
// linear (bcq_linear.cu, its second launch) and the two-launch GEMM's
// matmul (bcq_matmul.cu).
//
//     out (M, N) f32 = Σ_kb  a_inv[m, kb] · w_inv[n, kb] · Σ_{k ∈ kb} ca[m, k] · cw[n, k]
//
// Both operands are LO-BCQ codes: an integer codeword c = cb[sel·16 + idx]
// with |c| ≤ 31 (INT6; core/bcq.CodebookSet checks it at load) per scalar,
// and one f32 dequant scale inv = 1 / (ŝ_A · s_X) per 64-wide array kb.
// Each array's inner sum is therefore an exact integer dot product of at
// most 64 · 31² = 61,504 in magnitude, which an int8 MMA computes in int32.
// Each array's int32 sum is folded into the f32 accumulator by one fixed
// expression, fold() below.  For M > 16 every output folds its arrays in
// ascending kb order, so the result does not depend on the tile size;
// for M ≤ 16 eight warps fold every 8th array each and their partials
// add in warp order, so one row's bits depend on whether M ≤ 16.  The
// fused linear and the two-launch GEMM dispatch on the same M and give
// the same bits, and no float atomics touch the output.  The plain
// versions (ref.fused_linear_ref, ref.matmul_ref) round each decoded value
// before an f32 dot, so the two agree to f32 rounding, not to the bit.
//
// Operand A arrives as ready int8 codes (the fused linear's encode pass)
// or packed like W (idx u8 (R, K/2) nibbles, sel u8 (R, K/16) selector
// nibbles); packed rows decode through a 128-entry int8 table (sel·16 +
// idx) in shared memory, four codes per three byte permutes.
//
// The instruction is mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 fed
// by ldmatrix, not wgmma: the per-array fold needs the int32 fragment in
// registers after every 64-deep step, which suits the synchronous MMA;
// wgmma's asynchronous groups and shared-memory descriptors are later
// work (ROADMAP B′).  Two shapes:
//
// * M > 16 ("large"): a BM × 64 output tile per block of 4 warps (2 × 2,
//   warp tile BM/2 × 32; BM 128 at 2 blocks a SM, or 64 at 3 where 128-row
//   tiles would not fill the card).  Per 64-wide array one stage of a
//   4-deep cp.async ring brings A's codes (or packed bytes), W's packed
//   bytes and both operands' scales.  One barrier per array: after it the
//   block issues the copies three arrays ahead, decodes the next array's
//   packed tiles into the free one of two buffers of swizzled int8 rows
//   (16-byte chunk c of row r at c ^ ((r >> 1) & 3), so ldmatrix reads are
//   conflict-free), and multiplies the current array from the other: two
//   k-32 MMAs per fragment, then the fold.  The MMAs accumulate onto the
//   bits of 1.5·2^23, so the fold's int-to-float is one subtraction.
//   Ragged rows load as zeros with zero scales and are not stored.
// * M ≤ 16 (decode): W fills the MMA's 16-row side and the activation
//   rows its n = 8 side, so a block of 8 warps owns 16 output columns and
//   the grid has N / 16 blocks (48 at N 768).  Each warp takes every 8th
//   array and loads its fragments straight from device memory: within an
//   array the k order is free (the int32 sum is exact), so MMA slot
//   4q + r holds k = 16q + r, and lane (g, q) reads 16 contiguous codes
//   per row.  The 8 warps' partial sums add in warp order through shared
//   memory: deterministic, no split-K pass.
//
// Every other LO-BCQ format runs the same two kernels in their general
// form (GEN, gemm_fmt): L_b ∈ {2, 4, 8}, L_A ∈ {16, 32, 64, 128}, N_c ≤ 16
// codebooks of 2^B ≤ 16 entries, |c| ≤ 127 (INT8: an array's sum is at
// most 128 · 127² = 2,064,512 < 2^22, what ISUM_BIAS needs), K a multiple
// of 64 and of L_A.  The format is a run-time argument; only the packed
// selector decode branches on L_b.  Each array still folds once, in the
// same order as above:
//
// * M > 16: 64-row tiles only (one instantiation a form: the cold
//   build); the ring stages 64 K-columns a step as before, with a row's
//   16 selector bytes and 4 scales a step reserved; L_A 128 folds every
//   second step (its int32 sums kept across the two), L_A 64 every step,
//   L_A 32 after each k-32 MMA, and L_A 16 after each of two m16n8k16
//   MMAs a k-32 half (the k-32 fragments split in two), so no MMA mixes
//   two arrays' scales.  The code tables hold 16 × 16 int8 entries (sel ·
//   16 + idx; padding never selected).
// * M ≤ 16: a warp takes every 8th array and walks it in k-32 MMAs (one
//   m16n8k16 at L_A 16), lane (g, q) reading 8 contiguous codes a row per
//   k-32 (4 at L_A 16): MMA slots 4q … 4q + 3 and 16 + 4q … 16 + 4q + 3
//   hold k = 8q … 8q + 7, the same permutation on both operands.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bcq_encode.cuh"
#include "ptx.cuh"

namespace bcq {

// One operand of R rows × K.
struct Operand {
  const int8_t* codes;  // (R, K) int8 codewords, or nullptr when packed
  const uint8_t* idx;   // (R, K/2) codeword indices, two nibbles a byte
  const uint8_t* sel;   // (R, K/16) codebook selectors, two nibbles a byte
  const float* inv;     // (R, K/64) dequant scales 1 / (ŝ_A · s_X)
  const float* cb;      // (NC, NE) f32 codebooks (integers) of the packed form

  // The operand of GEMM z of a stack of equal GEMMs stored one after
  // another (R rows each): every row pointer moves by z · R rows.
  __device__ __forceinline__ Operand at(int z, int R, int K) const {
    const size_t r = static_cast<size_t>(z) * R;
    return {codes ? codes + r * K : nullptr, idx ? idx + r * (K / 2) : nullptr,
            sel ? sel + r * (K / 16) : nullptr, inv + r * (K / LA), cb};
  }
};

// The format of a general GEMM: L_A, L_b, N_c, 2^B.
struct GemmFmt {
  int la, lb, nc, ne;
};

// Operand::at for a general format: sel rows of K / (2 · L_b) bytes, inv
// rows of K / L_A scales.
__device__ __forceinline__ Operand at_fmt(const Operand& o, int z, int R, int K,
                                          const GemmFmt& f) {
  const size_t r = static_cast<size_t>(z) * R;
  return {o.codes ? o.codes + r * K : nullptr, o.idx ? o.idx + r * (K / 2) : nullptr,
          o.sel ? o.sel + r * (K / (2 * f.lb)) : nullptr, o.inv + r * (K / f.la), o.cb};
}

namespace {

// An array's MMAs accumulate onto ISUM_BIAS, the bits of 1.5·2^23: with
// |isum| < 2^22 the sum's bits are those of the float 1.5·2^23 + isum, so
// one subtraction gives float(isum) exactly, where a conversion
// instruction would run at a quarter of the f32 rate.
constexpr int ISUM_BIAS = 0x4B400000;

// The one expression that folds an array's biased int32 sum into the f32
// accumulator: acc + float(isum) · (a_inv · w_inv), one rounding each.
__device__ __forceinline__ float fold(float acc, int biased, float a_inv, float w_inv) {
  const float isum = __fsub_rn(__int_as_float(biased), 12582912.f);
  return __fmaf_rn(isum, __fmul_rn(a_inv, w_inv), acc);
}

// ---------------------------------------------------------------- decode
// tab[c] holds codebook c's 16 entries as int8.
__device__ __forceinline__ void load_code_table(const float* __restrict__ cb, uint4* tab, int i) {
  reinterpret_cast<int8_t*>(tab)[i] = static_cast<int8_t>(__float2int_rn(cb[i]));
}

// The codes of 4 indices (the low 4 nibbles of x) from one codebook's
// entries t: bytes 0–7 by the low 3 bits, bytes 8–15 likewise, then bit 3
// picks between the two.
__device__ __forceinline__ uint32_t lookup4(uint32_t x, uint4 t) {
  const uint32_t s = x & 0x7777u;
  const uint32_t lo = __byte_perm(t.x, t.y, s);
  const uint32_t hi = __byte_perm(t.z, t.w, s);
  return __byte_perm(lo, hi, 0x3210u | ((x >> 1) & 0x4444u));
}

// The 16 codes of two 8-scalar blocks: lo and hi their index words (8
// nibbles, scalar 0 lowest), sel their selector byte (first block in the
// low nibble).
__device__ __forceinline__ uint4 decode16(uint32_t lo, uint32_t hi, uint32_t sel,
                                          const uint4* tab) {
  const uint4 t0 = tab[sel & 15u], t1 = tab[(sel >> 4) & 15u];
  return make_uint4(lookup4(lo, t0), lookup4(lo >> 16, t0), lookup4(hi, t1),
                    lookup4(hi >> 16, t1));
}

// tab[c] holds codebook c's entries as int8, padded to 16 × 16 with zeros
// (a general format's table: nc × ne levels in cb); all of the block's
// ``nthreads`` threads call.
__device__ __forceinline__ void load_code_table_fmt(const float* __restrict__ cb, uint4* tab,
                                                    int tid, int nthreads, const GemmFmt& f) {
  for (int i = tid; i < MAX_NC * MAX_NE; i += nthreads) {
    const int c = i / MAX_NE, e = i % MAX_NE;
    reinterpret_cast<int8_t*>(tab)[i] =
        c < f.nc && e < f.ne ? static_cast<int8_t>(__float2int_rn(cb[c * f.ne + e])) : 0;
  }
}

// The codes of 4 scalars at a multiple of 4: x their 4 index nibbles (low
// 16 bits), s the selector nibbles of their blocks from the low nibble up
// (one at L_b ≥ 4; two at L_b 2, scalars 0–1 and 2–3).
__device__ __forceinline__ uint32_t code4(uint32_t x, uint32_t s, int lb, const uint4* tab) {
  if (lb != 2) return lookup4(x, tab[s & 15u]);
  return __byte_perm(lookup4(x, tab[s & 15u]), lookup4(x, tab[(s >> 4) & 15u]), 0x7610u);
}

// The 16 codes of 16 scalars starting on a block boundary: lo and hi
// their index words, s the selector nibbles of their 16 / L_b blocks.
__device__ __forceinline__ uint4 decode16_fmt(uint32_t lo, uint32_t hi, uint32_t s, int lb,
                                              const uint4* tab) {
  // scalars 4j … 4j + 3 start at block 4j / L_b: nibble 4j / L_b of s
  return make_uint4(code4(lo, s, lb, tab), code4(lo >> 16, s >> (4 * (4 / lb)), lb, tab),
                    code4(hi, s >> (4 * (8 / lb)), lb, tab),
                    code4(hi >> 16, s >> (4 * (12 / lb)), lb, tab));
}

// ----------------------------------------------------------------- PTX
using namespace ptx;

// d += a · b on one 16 × 8 × 32 int8 tile (int32 accumulate, exact here).
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a · b on one 16 × 8 × 16 int8 tile: one L_A-16 array.
__device__ __forceinline__ void mma_s8_k16(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// ------------------------------------------------------------ M > 16
constexpr int THREADS = 128;  // 4 warps, 2 × 2 over the tile
constexpr int BN = 64;
constexpr int STAGES = 4;

// Shared-memory layout of a BM × BN tile: a STAGES-deep ring of raw
// stages, then two buffers of decoded int8 rows (one is decoded while the
// other is multiplied), then the int8 code tables.
// GEN: a general format's room (a row's 16 selector bytes and 4 scales a
// step, 16 code-table rows).
template <bool A_CODES, int BM, bool GEN = false>
struct Large {
  static constexpr int SEL = GEN ? 16 : 4;  // selector bytes a row and step
  static constexpr int INV = GEN ? 4 : 1;   // scales a row and step
  static constexpr int A_RAW = A_CODES ? BM * 64 : BM * 32 + BM * SEL;  // codes, or idx + sel
  static constexpr int A_INV = A_RAW;                                  // BM × INV f32
  static constexpr int W_IDX = A_INV + BM * 4 * INV;                   // BN × 32 B
  static constexpr int W_SEL = W_IDX + BN * 32;                        // BN × SEL B
  static constexpr int W_INV = W_SEL + BN * SEL;                       // BN × INV f32
  static constexpr int STAGE = W_INV + BN * 4 * INV;
  static constexpr int DEC = (A_CODES ? 0 : BM * 64) + BN * 64;        // [A rows,] W rows
  static constexpr int DEC0 = STAGES * STAGE;
  static constexpr int TAB = DEC0 + 2 * DEC;                           // 2 code tables
  static constexpr int NTAB = GEN ? MAX_NC : NC;                       // uint4 rows a table
  static constexpr int SMEM = TAB + 2 * NTAB * 16;
  static constexpr int WM = BM / 2, MT = WM / 16, NT = 4;              // warp tile WM × 32
  static constexpr int MIN_BLOCKS = BM == 128 ? 2 : 3;                 // per SM, by registers
};

__device__ __forceinline__ int swz(int r, int c) { return r * 64 + ((c ^ ((r >> 1) & 3)) << 4); }

// Decode a staged packed tile (rows × 64 scalars: idx rows of 32 B, sel
// rows of 4 B) into swizzled int8 rows.
__device__ __forceinline__ void decode_tile(const uint8_t* idx_s, const uint8_t* sel_s,
                                            const uint4* tab, uint8_t* dec, int rows, int tid) {
  for (int p = tid; p < rows * 2; p += THREADS) {
    const int r = p >> 1, h = p & 1;
    const uint4 w = *reinterpret_cast<const uint4*>(idx_s + r * 32 + h * 16);
    const uint32_t s = *reinterpret_cast<const uint16_t*>(sel_s + r * 4 + h * 2);
    *reinterpret_cast<uint4*>(dec + swz(r, 2 * h)) = decode16(w.x, w.y, s & 0xFFu, tab);
    *reinterpret_cast<uint4*>(dec + swz(r, 2 * h + 1)) = decode16(w.z, w.w, s >> 8, tab);
  }
}

// Stage array kb's raw bytes and scales: rows r0 … r0 + rows − 1 of a
// packed operand (idx, sel) and its scales.
__device__ __forceinline__ void stage_packed(uint8_t* idx_s, uint8_t* sel_s, float* inv_s,
                                             const Operand& o, int r0, int rows, int R, int K,
                                             int kb, int tid) {
  for (int p = tid; p < rows * 2; p += THREADS) {
    const int r = p >> 1, h = p & 1, g = r0 + r;
    const size_t row = static_cast<size_t>(g < R ? g : 0);
    cp_async16(idx_s + r * 32 + h * 16, o.idx + row * (K / 2) + kb * 32 + h * 16, g < R);
  }
  for (int r = tid; r < rows; r += THREADS) {
    const int g = r0 + r;
    const size_t row = static_cast<size_t>(g < R ? g : 0);
    cp_async4(sel_s + r * 4, o.sel + row * (K / 16) + kb * 4, g < R);
    cp_async4(inv_s + r, o.inv + row * (K / LA) + kb, g < R);
  }
}

// decode_tile of a general format: a row's selector bytes at a stride of
// 16 (32 / L_b of them a step).
__device__ __forceinline__ void decode_tile_fmt(const uint8_t* idx_s, const uint8_t* sel_s,
                                                const uint4* tab, uint8_t* dec, int rows,
                                                int lb, int tid) {
  const int sb16 = 8 / lb;  // selector bytes of 16 scalars
  for (int p = tid; p < rows * 2; p += THREADS) {
    const int r = p >> 1, h = p & 1;
    const uint4 w = *reinterpret_cast<const uint4*>(idx_s + r * 32 + h * 16);
#pragma unroll
    for (int u = 0; u < 2; ++u) {  // 16 scalars: group c = 2h + u of the step
      const int off = (2 * h + u) * sb16;
      const uint32_t word = *reinterpret_cast<const uint32_t*>(sel_s + r * 16 + (off & ~3));
      const uint32_t sbits = word >> (8 * (off & 3));
      *reinterpret_cast<uint4*>(dec + swz(r, 2 * h + u)) =
          decode16_fmt(u ? w.z : w.x, u ? w.w : w.y, sbits, lb, tab);
    }
  }
}

// Stage step kb's selector bytes and scales of a general format: rows r0
// … r0 + rows − 1, 32 / L_b selector bytes and 64 / L_A scales a row (L_A
// 128: array kb / 2's scale at both of its steps).
__device__ __forceinline__ void stage_side_fmt(uint8_t* sel_s, float* inv_s, const Operand& o,
                                               int r0, int rows, int R, int K, int kb, int tid,
                                               const GemmFmt& f) {
  const int sw = 8 / f.lb;                        // selector words a row and step
  const int ni = f.la > 64 ? 1 : 64 / f.la;       // scales a row and step
  const int ia = f.la > 64 ? kb / 2 : kb * ni;    // the first one's array
  if (sel_s != nullptr)
    for (int p = tid; p < rows * sw; p += THREADS) {
      const int r = p / sw, c = p % sw, g = r0 + r;
      const size_t row = static_cast<size_t>(g < R ? g : 0);
      cp_async4(sel_s + r * 16 + c * 4, o.sel + row * (K / (2 * f.lb)) + kb * sw * 4 + c * 4,
                g < R);
    }
  for (int p = tid; p < rows * ni; p += THREADS) {
    const int r = p / ni, c = p % ni, g = r0 + r;
    const size_t row = static_cast<size_t>(g < R ? g : 0);
    cp_async4(inv_s + r * 4 + c, o.inv + row * (K / f.la) + ia + c, g < R);
  }
}

// Stage step kb's index bytes: rows r0 … r0 + rows − 1, 32 bytes a row.
__device__ __forceinline__ void stage_idx(uint8_t* idx_s, const Operand& o, int r0, int rows,
                                          int R, int K, int kb, int tid) {
  for (int p = tid; p < rows * 2; p += THREADS) {
    const int r = p >> 1, h = p & 1, g = r0 + r;
    const size_t row = static_cast<size_t>(g < R ? g : 0);
    cp_async16(idx_s + r * 32 + h * 16, o.idx + row * (K / 2) + kb * 32 + h * 16, g < R);
  }
}

template <bool A_CODES, int BM, bool GEN = false>
__global__ void __launch_bounds__(THREADS, (Large<A_CODES, BM, GEN>::MIN_BLOCKS))
    gemm_large(const Operand a0, const Operand w0, float* __restrict__ out, int M, int N, int K,
               const GemmFmt f) {
  using L = Large<A_CODES, BM, GEN>;
  const Operand a = GEN ? at_fmt(a0, blockIdx.z, M, K, f) : a0.at(blockIdx.z, M, K);
  const Operand w = GEN ? at_fmt(w0, blockIdx.z, N, K, f) : w0.at(blockIdx.z, N, K);
  out += static_cast<size_t>(blockIdx.z) * M * N;
  extern __shared__ __align__(128) uint8_t smem[];
  uint4* tab_w = reinterpret_cast<uint4*>(smem + L::TAB);
  uint4* tab_a = tab_w + L::NTAB;
  const int tid = threadIdx.x;
  if constexpr (GEN) {
    load_code_table_fmt(w.cb, tab_w, tid, THREADS, f);
    if (!A_CODES) load_code_table_fmt(a.cb, tab_a, tid, THREADS, f);
  } else {
    load_code_table(w.cb, tab_w, tid);
    if (!A_CODES) load_code_table(a.cb, tab_a, tid);
  }

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int KA = K / LA;
  auto slot = [&](int kb) { return smem + (kb % STAGES) * L::STAGE; };
  auto stage = [&](int kb) {
    uint8_t* st = slot(kb);
    if constexpr (GEN) {
      if constexpr (A_CODES) {
        for (int p = tid; p < BM * 4; p += THREADS) {
          const int r = p >> 2, c = p & 3, g = m0 + r;
          const size_t row = static_cast<size_t>(g < M ? g : 0);
          cp_async16(st + swz(r, c), a.codes + row * K + kb * 64 + c * 16, g < M);
        }
        stage_side_fmt(nullptr, reinterpret_cast<float*>(st + L::A_INV), a, m0, BM, M, K, kb,
                       tid, f);
      } else {
        stage_idx(st, a, m0, BM, M, K, kb, tid);
        stage_side_fmt(st + BM * 32, reinterpret_cast<float*>(st + L::A_INV), a, m0, BM, M, K,
                       kb, tid, f);
      }
      stage_idx(st + L::W_IDX, w, n0, BN, N, K, kb, tid);
      stage_side_fmt(st + L::W_SEL, reinterpret_cast<float*>(st + L::W_INV), w, n0, BN, N, K, kb,
                     tid, f);
      return;
    }
    if constexpr (A_CODES) {
      for (int p = tid; p < BM * 4; p += THREADS) {
        const int r = p >> 2, c = p & 3, g = m0 + r;
        const size_t row = static_cast<size_t>(g < M ? g : 0);
        cp_async16(st + swz(r, c), a.codes + row * K + kb * LA + c * 16, g < M);
      }
      for (int r = tid; r < BM; r += THREADS) {
        const int g = m0 + r;
        const size_t row = static_cast<size_t>(g < M ? g : 0);
        cp_async4(reinterpret_cast<float*>(st + L::A_INV) + r, a.inv + row * KA + kb, g < M);
      }
    } else {
      stage_packed(st, st + BM * 32, reinterpret_cast<float*>(st + L::A_INV), a, m0, BM, M, K,
                   kb, tid);
    }
    stage_packed(st + L::W_IDX, st + L::W_SEL, reinterpret_cast<float*>(st + L::W_INV), w, n0,
                 BN, N, K, kb, tid);
  };
  // decoded rows of array kb: W first, then A (packed A only)
  auto dec = [&](int kb) { return smem + L::DEC0 + (kb & 1) * L::DEC; };
  auto decode = [&](int kb) {
    const uint8_t* st = slot(kb);
    if constexpr (GEN) {
      decode_tile_fmt(st + L::W_IDX, st + L::W_SEL, tab_w, dec(kb), BN, f.lb, tid);
      if constexpr (!A_CODES)
        decode_tile_fmt(st, st + BM * 32, tab_a, dec(kb) + BN * 64, BM, f.lb, tid);
    } else {
      decode_tile(st + L::W_IDX, st + L::W_SEL, tab_w, dec(kb), BN, tid);
      if constexpr (!A_CODES) decode_tile(st, st + BM * 32, tab_a, dec(kb) + BN * 64, BM, tid);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int wm = (warp >> 1) * L::WM, wn = (warp & 1) * 32;
  const int g = lane >> 2, q = lane & 3;
  float acc[L::MT][L::NT][4];
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // The general format's step: its arrays' int32 sums (kept across two
  // steps at L_A 128) and their folds, in ascending array order.  (GMT,
  // GNT: the tile for GEN, a stub the default instantiation never runs.)
  constexpr int GMT = GEN ? L::MT : 1, GNT = GEN ? L::NT : 2;
  int gisum[GMT][GNT][4];
  auto greset = [&]() {
#pragma unroll
    for (int i = 0; i < GMT; ++i)
#pragma unroll
      for (int j = 0; j < GNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) gisum[i][j][e] = ISUM_BIAS;
  };
  auto gfold = [&](const uint8_t* st, int slot_i) {  // fold scale slot_i of the step
    const float* ainv = reinterpret_cast<const float*>(st + L::A_INV);
    const float* winv = reinterpret_cast<const float*>(st + L::W_INV);
#pragma unroll
    for (int i = 0; i < GMT; ++i) {
      const float a0 = ainv[(wm + i * 16 + g) * 4 + slot_i];
      const float a1 = ainv[(wm + i * 16 + g + 8) * 4 + slot_i];
#pragma unroll
      for (int j = 0; j < GNT; ++j) {
        const float w0 = winv[(wn + j * 8 + 2 * q) * 4 + slot_i];
        const float w1 = winv[(wn + j * 8 + 2 * q + 1) * 4 + slot_i];
        acc[i][j][0] = fold(acc[i][j][0], gisum[i][j][0], a0, w0);
        acc[i][j][1] = fold(acc[i][j][1], gisum[i][j][1], a0, w1);
        acc[i][j][2] = fold(acc[i][j][2], gisum[i][j][2], a1, w0);
        acc[i][j][3] = fold(acc[i][j][3], gisum[i][j][3], a1, w1);
      }
    }
    greset();
  };
  auto gen_step = [&](int kb, const uint8_t* st, const uint8_t* wt, const uint8_t* at) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // the two k-32 halves of the step
      uint32_t af[GMT][4], bf[GNT][2];
#pragma unroll
      for (int i = 0; i < GMT; ++i) {
        const int r = wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(af[i], at + swz(r, 2 * h + (lane >> 4)));
      }
#pragma unroll
      for (int j = 0; j < GNT; j += 2) {
        const int r = wn + j * 8 + (lane & 7) + ((lane >> 4) & 1) * 8;
        uint32_t t[4];
        ldmatrix_x4(t, wt + swz(r, 2 * h + ((lane >> 3) & 1)));
        bf[j][0] = t[0];
        bf[j][1] = t[1];
        bf[j + 1][0] = t[2];
        bf[j + 1][1] = t[3];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {  // the half's two k-16 quarters
        if (f.la == 16) {  // one array a quarter: a k-16 MMA
#pragma unroll
          for (int i = 0; i < GMT; ++i)
#pragma unroll
            for (int j = 0; j < GNT; ++j)
              mma_s8_k16(gisum[i][j], af[i][2 * u], af[i][2 * u + 1], bf[j][u]);
        } else if (u == 1) {  // a k-32 MMA over the half
#pragma unroll
          for (int i = 0; i < GMT; ++i)
#pragma unroll
            for (int j = 0; j < GNT; ++j)
              mma_s8(gisum[i][j], af[i], bf[j][0], bf[j][1]);
        }
        // an array ends after each quarter at L_A 16, each half at 32,
        // the step at 64 and every second step at 128
        const bool ends =
            f.la == 16 || (u == 1 && (f.la == 32 || (h == 1 && (f.la == 64 || (kb & 1)))));
        if (ends) gfold(st, f.la == 16 ? 2 * h + u : f.la == 32 ? h : 0);
      }
    }
  };
  if constexpr (GEN) greset();

  // Pipeline, one barrier per array: at step kb the block issues the
  // copies of array kb + STAGES − 1, decodes array kb + 1 into the free
  // buffer and multiplies array kb from the other.
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KA) stage(s);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();  // array 0 and the code tables landed
  decode(0);
  for (int kb = 0; kb < KA; ++kb) {
    cp_async_wait<STAGES - 3>();
    __syncthreads();  // array kb decoded, array kb + 1 landed, step kb − 1 done everywhere
    if (kb + STAGES - 1 < KA) stage(kb + STAGES - 1);  // into kb − 1's slot
    cp_async_commit();
    if (kb + 1 < KA) decode(kb + 1);

    const uint8_t* st = slot(kb);
    const uint8_t* wt = dec(kb);
    const uint8_t* at = A_CODES ? st : wt + BN * 64;
    if constexpr (GEN) {
      gen_step(kb, st, wt, at);
    } else {
      int isum[L::MT][L::NT][4];
#pragma unroll
      for (int i = 0; i < L::MT; ++i)
#pragma unroll
        for (int j = 0; j < L::NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) isum[i][j][e] = ISUM_BIAS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // the two k-32 halves of the array
        uint32_t af[L::MT][4], bf[L::NT][2];
#pragma unroll
        for (int i = 0; i < L::MT; ++i) {
          const int r = wm + i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldmatrix_x4(af[i], at + swz(r, 2 * h + (lane >> 4)));
        }
#pragma unroll
        for (int j = 0; j < L::NT; j += 2) {
          const int r = wn + j * 8 + (lane & 7) + ((lane >> 4) & 1) * 8;
          uint32_t t[4];
          ldmatrix_x4(t, wt + swz(r, 2 * h + ((lane >> 3) & 1)));
          bf[j][0] = t[0];
          bf[j][1] = t[1];
          bf[j + 1][0] = t[2];
          bf[j + 1][1] = t[3];
        }
#pragma unroll
        for (int i = 0; i < L::MT; ++i)
#pragma unroll
          for (int j = 0; j < L::NT; ++j) mma_s8(isum[i][j], af[i], bf[j][0], bf[j][1]);
      }
      const float* ainv = reinterpret_cast<const float*>(st + L::A_INV);
      const float* winv = reinterpret_cast<const float*>(st + L::W_INV);
#pragma unroll
      for (int i = 0; i < L::MT; ++i) {
        const float a0 = ainv[wm + i * 16 + g], a1 = ainv[wm + i * 16 + g + 8];
#pragma unroll
        for (int j = 0; j < L::NT; ++j) {
          const float w0 = winv[wn + j * 8 + 2 * q], w1 = winv[wn + j * 8 + 2 * q + 1];
          acc[i][j][0] = fold(acc[i][j][0], isum[i][j][0], a0, w0);
          acc[i][j][1] = fold(acc[i][j][1], isum[i][j][1], a0, w1);
          acc[i][j][2] = fold(acc[i][j][2], isum[i][j][2], a1, w0);
          acc[i][j][3] = fold(acc[i][j][3], isum[i][j][3], a1, w1);
        }
      }
    }
  }

  const bool pairs = (N & 1) == 0;
#pragma unroll
  for (int i = 0; i < L::MT; ++i)
#pragma unroll
    for (int j = 0; j < L::NT; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + wm + i * 16 + g + hr * 8, n = n0 + wn + j * 8 + 2 * q;
        if (m >= M) continue;
        float* o = out + static_cast<size_t>(m) * N + n;
        if (pairs && n + 1 < N) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[i][j][2 * hr], acc[i][j][2 * hr + 1]);
        } else {
          if (n < N) o[0] = acc[i][j][2 * hr];
          if (n + 1 < N) o[1] = acc[i][j][2 * hr + 1];
        }
      }
}

// ------------------------------------------------------------- M ≤ 16
constexpr int SMALL_ROWS = 16;   // output columns (W rows) per block
constexpr int SMALL_WARPS = 8;   // warps per block, splitting the arrays

// 16 codes of one row's array kb at k = 16q … 16q + 15 (lane q's share),
// zero past the last row.
__device__ __forceinline__ uint4 row_codes(const Operand& o, const uint4* tab, int row, int R,
                                           int K, int kb, int q) {
  if (row >= R) return make_uint4(0, 0, 0, 0);
  if (o.codes != nullptr)
    return __ldg(reinterpret_cast<const uint4*>(o.codes + static_cast<size_t>(row) * K +
                                                kb * LA + q * 16));
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(o.idx + static_cast<size_t>(row) * (K / 2) +
                                                       kb * 32 + q * 8));
  const uint32_t s = __ldg(o.sel + static_cast<size_t>(row) * (K / 16) + kb * 4 + q);
  return decode16(w.x, w.y, s, tab);
}

__device__ __forceinline__ float row_inv(const Operand& o, int row, int R, int KA, int kb) {
  return row < R ? __ldg(o.inv + static_cast<size_t>(row) * KA + kb) : 0.f;
}

__global__ void __launch_bounds__(SMALL_WARPS * 32)
    gemm_small(const Operand a0, const Operand w0, float* __restrict__ out, int M, int N, int K) {
  const Operand a = a0.at(blockIdx.z, M, K), w = w0.at(blockIdx.z, N, K);
  out += static_cast<size_t>(blockIdx.z) * M * N;
  __shared__ uint4 tab_w[NC], tab_a[NC];
  __shared__ float red[SMALL_WARPS][16][SMALL_ROWS + 1];
  const int tid = threadIdx.x;
  if (tid < NC * NE) load_code_table(w.cb, tab_w, tid);
  else if (a.codes == nullptr) load_code_table(a.cb, tab_a, tid - NC * NE);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * SMALL_ROWS;
  const int KA = K / LA;
  const int tiles = M > 8 ? 2 : 1;  // n8 tiles of activation rows (warp-uniform)
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int kb = warp; kb < KA; kb += SMALL_WARPS) {
    // W rows n0 + g and n0 + g + 8 fill the MMA's A fragment
    const uint4 wl = row_codes(w, tab_w, n0 + g, N, K, kb, q);
    const uint4 wh = row_codes(w, tab_w, n0 + g + 8, N, K, kb, q);
    const float wil = row_inv(w, n0 + g, N, KA, kb), wih = row_inv(w, n0 + g + 8, N, KA, kb);
    const uint32_t f0[4] = {wl.x, wh.x, wl.y, wh.y};  // k 16q + 0 … 7
    const uint32_t f1[4] = {wl.z, wh.z, wl.w, wh.w};  // k 16q + 8 … 15
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t == tiles) break;
      const uint4 b = row_codes(a, tab_a, 8 * t + g, M, K, kb, q);
      const float a0 = row_inv(a, 8 * t + 2 * q, M, KA, kb);
      const float a1 = row_inv(a, 8 * t + 2 * q + 1, M, KA, kb);
      int d[4] = {ISUM_BIAS, ISUM_BIAS, ISUM_BIAS, ISUM_BIAS};
      mma_s8(d, f0, b.x, b.y);
      mma_s8(d, f1, b.z, b.w);
      acc[t][0] = fold(acc[t][0], d[0], a0, wil);  // (n g,     m 2q)
      acc[t][1] = fold(acc[t][1], d[1], a1, wil);  // (n g,     m 2q + 1)
      acc[t][2] = fold(acc[t][2], d[2], a0, wih);  // (n g + 8, m 2q)
      acc[t][3] = fold(acc[t][3], d[3], a1, wih);  // (n g + 8, m 2q + 1)
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    red[warp][8 * t + 2 * q][g] = acc[t][0];
    red[warp][8 * t + 2 * q + 1][g] = acc[t][1];
    red[warp][8 * t + 2 * q][g + 8] = acc[t][2];
    red[warp][8 * t + 2 * q + 1][g + 8] = acc[t][3];
  }
  __syncthreads();
  const int m = tid >> 4, c = tid & 15, n = n0 + c;
  if (m < M && n < N) {
    float s = red[0][m][c];
#pragma unroll
    for (int v = 1; v < SMALL_WARPS; ++v) s = __fadd_rn(s, red[v][m][c]);
    out[static_cast<size_t>(m) * N + n] = s;
  }
}

// The selector nibbles of the blocks of n scalars (4 or 8) at k of a
// packed row: one block (L_b 8, and L_b 4 for 4 scalars), else whole
// bytes from k / (2 · L_b).
__device__ __forceinline__ uint32_t row_sel(const Operand& o, size_t row, int K, int k, int n,
                                            int lb) {
  const int bi = k / lb;  // the first block
  const uint8_t* sp = o.sel + row * (K / (2 * lb)) + bi / 2;
  uint32_t s = __ldg(sp);
  if (lb == 2 && n == 8) s |= static_cast<uint32_t>(__ldg(sp + 1)) << 8;
  return s >> (4 * (bi & 1));
}

// n ∈ {4, 8} codes of one row at k (lane q's share of an MMA), zero past
// the last row: the low word holds k … k + 3, the high word k + 4 … k + 7.
__device__ __forceinline__ uint2 row_codes_fmt(const Operand& o, const uint4* tab, int row, int R,
                                               int K, int k, int n, int lb) {
  if (row >= R) return make_uint2(0, 0);
  const size_t r = static_cast<size_t>(row);
  if (o.codes != nullptr) {
    const int8_t* c = o.codes + r * K + k;
    if (n == 4) return make_uint2(__ldg(reinterpret_cast<const uint32_t*>(c)), 0);
    return __ldg(reinterpret_cast<const uint2*>(c));
  }
  const uint32_t s = row_sel(o, r, K, k, n, lb);
  if (n == 4)
    return make_uint2(code4(__ldg(reinterpret_cast<const uint16_t*>(o.idx + r * (K / 2) + k / 2)),
                            s, lb, tab),
                      0);
  const uint32_t x = __ldg(reinterpret_cast<const uint32_t*>(o.idx + r * (K / 2) + k / 2));
  return make_uint2(code4(x, s, lb, tab), code4(x >> 16, s >> (4 * (4 / lb)), lb, tab));
}

// M ≤ 16 for a general format: warp w takes arrays w, w + 8, …, each in
// k-32 MMAs (one k-16 MMA at L_A 16) and one fold; the warps' partial
// sums add in warp order, as gemm_small's.
__global__ void __launch_bounds__(SMALL_WARPS * 32)
    gemm_small_fmt(const Operand a0, const Operand w0, float* __restrict__ out, int M, int N,
                   int K, const GemmFmt f) {
  const Operand a = at_fmt(a0, blockIdx.z, M, K, f), w = at_fmt(w0, blockIdx.z, N, K, f);
  out += static_cast<size_t>(blockIdx.z) * M * N;
  __shared__ uint4 tab_w[MAX_NC], tab_a[MAX_NC];
  __shared__ float red[SMALL_WARPS][16][SMALL_ROWS + 1];
  const int tid = threadIdx.x;
  load_code_table_fmt(w.cb, tab_w, tid, SMALL_WARPS * 32, f);
  if (a.codes == nullptr) load_code_table_fmt(a.cb, tab_a, tid, SMALL_WARPS * 32, f);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int n0 = blockIdx.x * SMALL_ROWS;
  const int KA = K / f.la;
  const int tiles = M > 8 ? 2 : 1;  // n8 tiles of activation rows (warp-uniform)
  float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
  for (int ka = warp; ka < KA; ka += SMALL_WARPS) {
    int d[2][4] = {{ISUM_BIAS, ISUM_BIAS, ISUM_BIAS, ISUM_BIAS},
                   {ISUM_BIAS, ISUM_BIAS, ISUM_BIAS, ISUM_BIAS}};
    if (f.la == 16) {  // one k-16 MMA: lane q's 4 codes at k0 + 4q
      const int k = ka * 16 + 4 * q;
      const uint32_t wl = row_codes_fmt(w, tab_w, n0 + g, N, K, k, 4, f.lb).x;
      const uint32_t wh = row_codes_fmt(w, tab_w, n0 + g + 8, N, K, k, 4, f.lb).x;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t == tiles) break;
        mma_s8_k16(d[t], wl, wh, row_codes_fmt(a, tab_a, 8 * t + g, M, K, k, 4, f.lb).x);
      }
    } else {
      for (int s = 0; s < f.la / 32; ++s) {  // k-32 MMAs: lane q's 8 codes at k0 + 8q
        const int k = ka * f.la + s * 32 + 8 * q;
        const uint2 wl = row_codes_fmt(w, tab_w, n0 + g, N, K, k, 8, f.lb);
        const uint2 wh = row_codes_fmt(w, tab_w, n0 + g + 8, N, K, k, 8, f.lb);
        const uint32_t fr[4] = {wl.x, wh.x, wl.y, wh.y};
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t == tiles) break;
          const uint2 b = row_codes_fmt(a, tab_a, 8 * t + g, M, K, k, 8, f.lb);
          mma_s8(d[t], fr, b.x, b.y);
        }
      }
    }
    const float wil = row_inv(w, n0 + g, N, KA, ka), wih = row_inv(w, n0 + g + 8, N, KA, ka);
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      if (t == tiles) break;
      const float a0 = row_inv(a, 8 * t + 2 * q, M, KA, ka);
      const float a1 = row_inv(a, 8 * t + 2 * q + 1, M, KA, ka);
      acc[t][0] = fold(acc[t][0], d[t][0], a0, wil);
      acc[t][1] = fold(acc[t][1], d[t][1], a1, wil);
      acc[t][2] = fold(acc[t][2], d[t][2], a0, wih);
      acc[t][3] = fold(acc[t][3], d[t][3], a1, wih);
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    red[warp][8 * t + 2 * q][g] = acc[t][0];
    red[warp][8 * t + 2 * q + 1][g] = acc[t][1];
    red[warp][8 * t + 2 * q][g + 8] = acc[t][2];
    red[warp][8 * t + 2 * q + 1][g + 8] = acc[t][3];
  }
  __syncthreads();
  const int m = tid >> 4, c = tid & 15, n = n0 + c;
  if (m < M && n < N) {
    float s = red[0][m][c];
#pragma unroll
    for (int v = 1; v < SMALL_WARPS; ++v) s = __fadd_rn(s, red[v][m][c]);
    out[static_cast<size_t>(m) * N + n] = s;
  }
}

// ------------------------------------------------------------- launch
template <bool A_CODES, int BM, bool GEN = false>
cudaError_t launch_large(const Operand& a, const Operand& w, float* out, int M, int N, int K,
                         int batch, cudaStream_t stream, const GemmFmt& f = GemmFmt{}) {
  using L = Large<A_CODES, BM, GEN>;
  // above 48 KB of shared memory only after opting in, which holds per
  // device: set it at every launch (a host-side attribute write)
  const cudaError_t e = cudaFuncSetAttribute(
      gemm_large<A_CODES, BM, GEN>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, batch);
  gemm_large<A_CODES, BM, GEN><<<grid, THREADS, L::SMEM, stream>>>(a, w, out, M, N, K, f);
  return cudaGetLastError();
}

// out (M, N) = A · Wᵀ on the int8 tensor cores; A as codes when
// A_CODES, else packed.  With ``batch`` > 1, a stack of equal GEMMs in one
// launch (blockIdx.z the GEMM): GEMM z reads A's rows z·M … and W's rows
// z·N … and writes out's (M, N) block z.  The tile shape is chosen by the
// one GEMM's M, never by batch · M, so each GEMM gives the bits it gives
// alone (a row's bits depend on whether M ≤ 16; see the top).  Requires
// K % 64 == 0, M, N ≥ 1, 1 ≤ batch ≤ 65535, 16-byte aligned codes and
// idx rows and 4-byte aligned sel (the wrappers check).
template <bool A_CODES>
cudaError_t gemm(const Operand& a, const Operand& w, float* out, int M, int N, int K,
                 cudaStream_t stream, int batch = 1) {
  if (M <= 16) {
    const dim3 grid((N + SMALL_ROWS - 1) / SMALL_ROWS, 1, batch);
    gemm_small<<<grid, SMALL_WARPS * 32, 0, stream>>>(a, w, out, M, N, K);
    return cudaGetLastError();
  }
  // 128-row tiles once they fill the card (two a SM) twice over, else
  // 64-row tiles
  const long long big =
      static_cast<long long>((M + 127) / 128) * ((N + BN - 1) / BN) * batch;
  return big >= 4 * 132 ? launch_large<A_CODES, 128>(a, w, out, M, N, K, batch, stream)
                        : launch_large<A_CODES, 64>(a, w, out, M, N, K, batch, stream);
}

// gemm for a general format f (the notes at the top): the same dispatch
// on M, and 64-row tiles for every M > 16 (one instantiation a form keeps
// the cold build short; a tile's bits do not depend on its shape).  Requires K % 64 == 0, K % f.la == 0, 8-byte
// aligned codes rows, 16-byte aligned idx rows and 4-byte aligned sel.
template <bool A_CODES>
cudaError_t gemm_fmt(const Operand& a, const Operand& w, float* out, int M, int N, int K,
                     const GemmFmt& f, cudaStream_t stream, int batch = 1) {
  if (M <= 16) {
    const dim3 grid((N + SMALL_ROWS - 1) / SMALL_ROWS, 1, batch);
    gemm_small_fmt<<<grid, SMALL_WARPS * 32, 0, stream>>>(a, w, out, M, N, K, f);
    return cudaGetLastError();
  }
  return launch_large<A_CODES, 64, true>(a, w, out, M, N, K, batch, stream, f);
}

}  // namespace
}  // namespace bcq
