// LO-BCQ encode of an operand, and of new K/V into bcq4 KV pages, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bcq_quantize.py:_quantize_kernel
// (launched by bcq_quantize_pallas, reached through ops.quantize and
// ops.w4a4_linear).  Two forms of one encode pass (bcq_encode.cuh, shared
// with the fused linear's first launch, so the W4A4 routes encode
// bit-identically by construction):
//
// * quantize (bcq_quantize_launch): x f32 (M, K) with the per-tensor scale
//   s_x the caller reduced →
//       idx   u8  (M, K/2)        codeword indices, two nibbles a byte, low first
//       sel   u8  (M, K/(2·L_b))  codebook selectors, two nibbles a byte
//       ratio f32 (M, K/L_A)      E4M3-snapped s_A / s_X per array
//   with the default format's integer codebooks (the table lookup), or,
//   through bcq_quantize_thr_launch, with any sorted f32 codebooks of any
//   format (the threshold search: trained codebooks, and every L_b, L_A,
//   N_c, 2^B and B_c the reference's kernel takes);
// * page store (bcq_page_write_launch): the bcq4 KV-page writer of the
//   serving path, where the reference encodes with jnp bcq.encode
//   (repro/models/layers.py: paged_token_write, paged_chunk_write).  One
//   launch encodes the new keys AND values of one layer, each (token,
//   head) vector on its own with L_A = min(64, d_head) and the pool-global
//   k_sx / v_sx, and stores idx nibbles, selector nibbles and the ratio's
//   E4M3 bits straight into their page slots (pool leaves (P, ps, H, ·)).
//   The format is the caller's (L_A already shrunk to d_head where the
//   cache does so), and so is the route: the default format's table, or
//   the threshold search for every other.
//   Decode (n_cp == 0): row b's one token goes to slot (ids[b], aux[b]);
//   of rows that share a slot only the last writes.  Chunked prefill
//   (n_cp > 0): row b's C tokens fill pages ids[b, 0..n_cp); slots past C
//   or past aux[b] (chunk_len, when given) get the all-zero cache_init
//   bytes; of the (b, j) in row-major order that name one page (the null
//   page) only the last writes.  Rows decide that themselves from the ids:
//   no host op, no atomics, no order between blocks of threads needed.
//
// What bounds it on this card: its bytes (4 read and ~0.6 written a
// scalar for f32 input) against 32 f32 operations a scalar (a table read,
// d, d², Σ per codebook).  What the redesign does about it: instruction
// slots and the shared-memory wavefronts per scalar are the tight
// resources once the bytes stream, so a scalar's 8 candidate codewords
// come from two conflict-free 128-bit reads of a banked table (not 8
// 32-bit reads that conflict on the row's bank) built without bank
// conflicts either, the argmin keeps only (error, codebook) and looks the
// winner's entries up once, each table address is one multiply-add on the
// row's float bits, E4M3 takes the exponent from the bits, and the next
// grid-stride step's loads are in flight during this step's encode.  Each thread loads 8 scalars as two
// float4 (one uint4 for bf16) and stores its 8 indices as one 32-bit word;
// the even lane of a block pair stores the pair's selector byte.  The
// threshold search is simpler: 4 shared-memory compares and a level read
// per scalar and codebook (not one table row for all 8), plus 4 for the
// winner's index, from 1 KB of tables, so it is bound by those reads; it
// runs only on trained codebooks.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bcq_encode.cuh"

namespace {

using bcq::LA;
using bcq::LB;

__device__ __forceinline__ uint32_t pack_idx(const uint32_t (&ent)[LB]) {
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < LB; ++i) word |= bcq::entry_idx(ent[i]) << (4 * i);
  return word;
}

// Quantize: block g of x as packed indices, a packed selector byte per
// block pair and the array's ratio.
struct QuantizeIo : bcq::RowMajorIn {
  uint32_t* idx;
  uint8_t* sel;
  float* ratio;
  __device__ void store(long long g, long long, const uint32_t (&ent)[LB], int s, int pair,
                        float r, float) const {
    idx[g] = pack_idx(ent);
    if ((g & 1) == 0) sel[g / 2] = static_cast<uint8_t>(s | (pair << 4));
    if ((g & 7) == 0) ratio[g / 8] = r;
  }
  __device__ void store_fmt(long long g, long long, const uint32_t (&ent)[LB], uint32_t sb,
                            float r, float, const bcq::Fmt& f) const {
    idx[g] = pack_idx(ent);
    bcq::store_sel(sel, g, sb, f.lb);
    if ((g & (f.lanes - 1)) == 0) ratio[g >> f.sh] = r;
  }
};

__device__ __forceinline__ int load_id(const void* p, int is64, int i) {
  return is64 ? static_cast<int>(static_cast<const long long*>(p)[i]) : static_cast<const int*>(p)[i];
}

// Page store: the blocks are numbered side (K, V) × row × head × block of
// the head vector (D / 8 of them); a row is a decode row (n_cp == 0) or a
// (row, page, slot) of the chunk.  A job is (vector index in the leaves ·
// 2 + side) · 2 + 1 for a slot that gets zeros.
template <bool BF16>
struct PageWriteIo {
  const void* k;  // (B, S, H, D) f32 or bf16
  const void* v;
  const float* k_sx;
  const float* v_sx;
  uint8_t* idx[2];    // (P, ps, H, D/2)
  uint8_t* sel[2];    // (P, ps, H, D/16)
  uint8_t* scale[2];  // (P, ps, H, D/L_A)
  const void* ids;    // decode: (B,) page per row; chunk: (B, n_cp) pages
  const void* aux;    // decode: (B,) slot per row; chunk: (B,) chunk_len or null
  int ids64, aux64;
  int ids_stride, aux_stride;  // elements from one row's ids (aux) to the next
  int B, S, H, D, P, ps, n_cp, la;

  __device__ long long load(long long g, long long n, float (&y)[LB], float& sx) const {
#pragma unroll
    for (int i = 0; i < LB; ++i) y[i] = 0.f;
    sx = 1.f;
    if (g >= n) return -1;
    const int nb = D / LB;
    int rest = static_cast<int>(g) / nb;
    const int h = rest % H;
    rest /= H;
    const int rows = n_cp ? B * n_cp * ps : B;
    const int r = rest % rows, side = rest / rows;
    sx = side ? *v_sx : *k_sx;
    int b, t, page, slot;
    if (n_cp == 0) {  // decode: one token a row
      b = r;
      t = 0;
      page = load_id(ids, ids64, b * ids_stride);
      slot = load_id(aux, aux64, b * aux_stride);
      for (int b2 = b + 1; b2 < B; ++b2)  // a later row on the same slot writes it
        if (load_id(ids, ids64, b2 * ids_stride) == page &&
            load_id(aux, aux64, b2 * aux_stride) == slot)
          return -1;
    } else {  // chunk: page j of row b, slot within it
      const int f = r / ps;  // b · n_cp + j
      b = f / n_cp;
      slot = r % ps;
      t = (f % n_cp) * ps + slot;
      page = load_id(ids, ids64, b * ids_stride + f % n_cp);
      for (int f2 = f + 1; f2 < B * n_cp; ++f2)  // a later (b, j) on the same page writes it
        if (load_id(ids, ids64, f2 / n_cp * ids_stride + f2 % n_cp) == page) return -1;
    }
    // a slot outside the pool is a caller's fault: stop, as the plain
    // writer's index_put_ faults, rather than drop the write
    if (page < 0 || page >= P || slot < 0 || slot >= ps) __trap();
    const long long vec = (static_cast<long long>(page) * ps + slot) * H + h;
    const bool valid =
        t < S && (n_cp == 0 || aux == nullptr || t < load_id(aux, aux64, b * aux_stride));
    if (!valid) return (vec * 2 + side) * 2 + 1;
    const long long at = ((static_cast<long long>(b) * S + t) * H + h) * D + (g % nb) * LB;
    if (BF16) {
      const uint4 w = *reinterpret_cast<const uint4*>(static_cast<const uint16_t*>(side ? v : k) + at);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {  // bf16 → f32 is exact: the bits move up
        y[2 * i] = __uint_as_float(ws[i] << 16);
        y[2 * i + 1] = __uint_as_float(ws[i] & 0xFFFF0000u);
      }
    } else {
      const float4* src = reinterpret_cast<const float4*>(static_cast<const float*>(side ? v : k) + at);
      const float4 lo = src[0], hi = src[1];
      y[0] = lo.x; y[1] = lo.y; y[2] = lo.z; y[3] = lo.w;
      y[4] = hi.x; y[5] = hi.y; y[6] = hi.z; y[7] = hi.w;
    }
    return (vec * 2 + side) * 2;
  }

  __device__ void store(long long g, long long job, const uint32_t (&ent)[LB], int s, int pair,
                        float r, float) const {
    const bool zero = job & 1;
    const int side = (job >> 1) & 1;
    const long long vec = job >> 2;
    const int nb = D / LB, q = static_cast<int>(g % nb), bpa = la / LB;
    reinterpret_cast<uint32_t*>(idx[side])[vec * nb + q] = zero ? 0u : pack_idx(ent);
    if ((q & 1) == 0) sel[side][vec * (nb / 2) + q / 2] = zero ? 0 : static_cast<uint8_t>(s | (pair << 4));
    if (q % bpa == 0) scale[side][vec * (D / la) + q / bpa] = zero ? 0 : static_cast<uint8_t>(bcq::e4m3_bits(r));
  }

  // The threshold search's store: a head vector's D / (2 · L_b) selector
  // bytes, 8 / L_b blocks of each thread.
  __device__ void store_fmt(long long g, long long job, const uint32_t (&ent)[LB], uint32_t sb,
                            float r, float, const bcq::Fmt& f) const {
    const bool zero = job & 1;
    const int side = (job >> 1) & 1;
    const long long vec = job >> 2;
    const int nb = D / LB, q = static_cast<int>(g % nb), bpa = la / LB;
    reinterpret_cast<uint32_t*>(idx[side])[vec * nb + q] = zero ? 0u : pack_idx(ent);
    // the vector's selector bytes start at vec · nb · 4 / L_b: block q of
    // the vector is block vec · nb + q of one run
    bcq::store_sel(sel[side], vec * nb + q, zero ? 0u : sb, f.lb);
    if (q % bpa == 0) scale[side][vec * (D / la) + q / bpa] = zero ? 0 : static_cast<uint8_t>(bcq::e4m3_bits(r));
  }
};

QuantizeIo quantize_io(const float* x, const float* s_x, uint8_t* idx, uint8_t* sel,
                       float* ratio) {
  QuantizeIo io;
  io.x = x;
  io.s_x = s_x;
  io.idx = reinterpret_cast<uint32_t*>(idx);
  io.sel = sel;
  io.ratio = ratio;
  return io;
}

}  // namespace

// Plain C entries: launch on ``stream``, allocate nothing, return the
// launch status (cudaGetLastError); the wrappers check shapes, types and
// alignment.
//
// Quantize: the default format (L_A 64, L_b 8, 16 entries, N_c 8), K % 64
// == 0, 16-byte aligned x, 4-byte aligned idx; integer codebooks within
// ±cw_max ≤ 31 (the tables).
extern "C" int bcq_quantize_launch(const float* x, const float* cb, const float* s_x,
                                   uint8_t* idx, uint8_t* sel, float* ratio, int M, int K,
                                   float cw_max, void* stream) {
  if (M <= 0 || K <= 0 || K % LA || cw_max > 31.f) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(bcq::encode_launch<bcq::TABLE>(
      quantize_io(x, s_x, idx, sel, ratio), cb, static_cast<long long>(M) * (K / LB), cw_max,
      bcq::make_fmt(LA, 8, 16), static_cast<cudaStream_t>(stream)));
}

// Quantize with any sorted, finite f32 codebooks (nc × ne) of the format
// (lb, la, nc, ne) through the threshold search of bcq_encode.cuh; K % la
// == 0, 16-byte aligned x, 4-byte aligned idx and sel.  special: the
// default format's compiled search (SEARCH8), which only that format takes.
extern "C" int bcq_quantize_thr_launch(const float* x, const float* cb, const float* s_x,
                                       uint8_t* idx, uint8_t* sel, float* ratio, int M, int K,
                                       float cw_max, int lb, int la, int nc, int ne, int special,
                                       void* stream) {
  if (M <= 0 || K <= 0 || !bcq::format_ok(lb, la, nc, ne) || K % la ||
      (special && !bcq::default_format(lb, la, nc, ne)))
    return static_cast<int>(cudaErrorInvalidValue);
  const QuantizeIo io = quantize_io(x, s_x, idx, sel, ratio);
  const long long n_blocks = static_cast<long long>(M) * (K / LB);
  const bcq::Fmt f = bcq::make_fmt(la, nc, ne, lb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = special ? bcq::encode_launch<bcq::SEARCH8>(io, cb, n_blocks, cw_max, f, st)
                                : bcq::encode_launch<bcq::SEARCH>(io, cb, n_blocks, cw_max, f, st);
  return static_cast<int>(e);
}

// Page store: k, v (B, S, H, D) contiguous and 16-byte aligned, f32
// (bf16 = 0) or bf16 (bf16 = 1); the format (lb, la, nc, ne) with D = la
// · m ≤ 256; leaves contiguous with 4-byte aligned idx and sel; ids / aux
// int32 or int64 (ids64, aux64), row b's at b · ids_stride (aux_stride), a
// chunk row's n_cp ids contiguous.  table: the table encode, which takes
// L_b 8, 16 entries, N_c 8 and |codeword| ≤ 31 (any la); else the
// threshold search.  The codebooks are integers either way (the int8 codes
// are not stored, but the wrapper holds both paths to one premise).  A
// page id outside [0, P) or a slot outside [0, ps) aborts the kernel (the
// stream's next synchronisation reports a launch failure).
extern "C" int bcq_page_write_launch(int bf16, const void* k, const void* v, const float* k_sx,
                                     const float* v_sx, const float* cb, uint8_t* k_idx,
                                     uint8_t* k_sel, uint8_t* k_scale, uint8_t* v_idx,
                                     uint8_t* v_sel, uint8_t* v_scale, const void* ids,
                                     int ids64, int ids_stride, const void* aux, int aux64,
                                     int aux_stride, int B, int S, int H, int D, int P, int ps,
                                     int n_cp, int lb, int la, int nc, int ne, int table,
                                     float cw_max, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || ps <= 0 || n_cp < 0 || !bcq::format_ok(lb, la, nc, ne) ||
      D % la || D / LB > 32 || (table && !bcq::default_format(lb, LA, nc, ne)) ||
      (table && cw_max > 31.f))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long rows = n_cp ? static_cast<long long>(B) * n_cp * ps : B;
  const long long n_blocks = 2 * rows * H * (D / LB);
  if (n_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bcq::Fmt f = bcq::make_fmt(la, nc, ne, lb);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto run = [&](auto& io) {
    io.k = k; io.v = v; io.k_sx = k_sx; io.v_sx = v_sx;
    io.idx[0] = k_idx; io.idx[1] = v_idx;
    io.sel[0] = k_sel; io.sel[1] = v_sel;
    io.scale[0] = k_scale; io.scale[1] = v_scale;
    io.ids = ids; io.aux = aux; io.ids64 = ids64; io.aux64 = aux64;
    io.ids_stride = ids_stride; io.aux_stride = aux_stride;
    io.B = B; io.S = S; io.H = H; io.D = D; io.P = P; io.ps = ps; io.n_cp = n_cp; io.la = la;
    return table ? bcq::encode_launch<bcq::TABLE>(io, cb, n_blocks, cw_max, f, st)
                 : bcq::encode_launch<bcq::SEARCH>(io, cb, n_blocks, cw_max, f, st);
  };
  if (bf16) {
    PageWriteIo<true> io;
    return static_cast<int>(run(io));
  }
  PageWriteIo<false> io;
  return static_cast<int>(run(io));
}
