// The codec scores' shared row product: one int8 codec row against one f32
// query, for kernels B1/B3 (codec_scores.cu) and B4 (codec_scores_gathered.cu).
//
// All three kernels are bound by bytes on the H100 (4 flops per int8 byte at
// most), so the row product's job is to stay out of the way of the loads:
//
// * The query lives in registers. A row of d int8 bytes (d % 16 == 0) is
//   d / 16 words of 16 bytes; it is handled by a group of `lpr` lanes, the
//   smallest power of two that leaves a lane at most NCH = 2 words (4 lanes
//   and 2 words at d = 128; one lane and one word at d = 16; 32 lanes at
//   d = 1024; B4 takes one word a lane, 8 lanes at d = 128: it measured
//   faster there), and lane `sl` of the group owns the same words of EVERY
//   row. So a lane loads its 16 query floats per owned word once per query (32
//   registers) and the inner loop reads no query value from shared memory.
//   (The kernels of the first port kept the query in shared memory and read it
//   as float4 per lane: the lanes of a row group are 64 bytes apart there, a
//   four-way bank conflict on every load.) Two words a lane instead of one
//   halves the shuffle steps, the epilogues and the loop overhead per row,
//   which is what bounds the product: see PERF.md.
// * A lane takes its two words in an order that depends on its row slot
//   (`word_index`): the slots of a quarter-warp then read different halves of
//   their 128-byte rows, so a 16-byte load from shared memory has no bank
//   conflict.
// * Four independent partial sums per lane and word keep the FMA pipe busy
//   (one chain of 16 dependent FMAs does not).
// * |c|^2 of the int8 row is an exact integer: __dp4a(w, w, acc) on each
//   packed word, int32 accumulation, one conversion per row. The sum of at
//   most 1040 squares of int8 is below 2^24, so the f32 value is exact and
//   equals a plain f32 sum of the squares.
// * int8 -> f32 without a conversion instruction: the byte (made unsigned by
//   xor 0x80) is permuted into the low mantissa byte of 0x4B000000 = 2^23,
//   which reads as the float 2^23 + u, and one exact subtract of 2^23 + 128
//   gives the signed value. -DCODEC_ROW_CAST_UNPACK takes the plain cast
//   instead (for measuring the two against each other).
// * The three score forms and their epilogue (scale, clamp, sqrt, the Cosine
//   divide) are `finish`, so the kernels cannot drift apart.
//
// Tensor cores are not the tool here. The work is 4 flops a byte against a
// bound set by bytes; each query meets its own rows (a batch of matrix-vector
// products, no operand shared between queries, so no tile to reuse); and an
// mma would need the query in bf16, which the f32-query contract of these
// scores does not allow.
//
// Measurement hooks (tools/codec_variants.py), results are wrong with each:
//   -DCODEC_ROW_NO_MATH      loads and copies only: a 16-byte word is folded
//                            into one integer add
//   -DCODEC_ROW_SMEM_QUERY   the query is read from shared memory in the inner
//                            loop, at the first port's layout
//   (-DCODEC_ROW_NO_LOAD is the kernels' own: they skip the loads)

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace codec_row {

constexpr int MAX_NCH = 2;  // 16-byte words of a row per lane: d <= 1024

// Lanes per row and words per lane for a row of d bytes, d % 16 == 0: the
// fewest lanes (a power of two, at most 32) that leave a lane `want` words
// (1 or 2; more only when 32 lanes do not cover the row).
inline void row_geometry(int d, int want, int* lpr, int* nch) {
  const int words = d / 16;
  int l = 1;
  while ((words + l - 1) / l > want && l < 32) l *= 2;
  *lpr = l;
  *nch = (words + l - 1) / l;
}

// Warps of a block, 4..8: the count whose passes over `rows` rows, `per_warp`
// rows a warp and pass, leave the fewest row slots idle (ties: more warps).
inline int pick_warps(int rows, int per_warp) {
  int best = 8, best_slots = 1 << 30;
  for (int w = 8; w >= 4; --w) {
    const int pass = w * per_warp;
    const int slots = (rows + pass - 1) / pass * pass;
    if (slots < best_slots) {
      best = w;
      best_slots = slots;
    }
  }
  return best;
}

// The i-th word that lane `sl` of row slot `sub` takes: sl and sl + lpr, the
// order swapped in odd slots.
template <int NCH>
__device__ __forceinline__ int word_index(int i, int sl, int sub, int lpr) {
  return NCH == 1 ? sl : sl + lpr * ((i + sub) & 1);
}

// A lane's part of the query: 16 floats per owned word. Statically indexed,
// so it stays in registers.
template <int NCH>
struct Query {
  float v[NCH][16];
};

// q: this query's d floats (16-byte aligned), in device or shared memory.
// Words past the row's end hold 0.
template <int NCH>
__device__ __forceinline__ void load_query(Query<NCH>& qr, const float* __restrict__ q,
                                           int words, int lpr, int sl, int sub) {
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int c = word_index<NCH>(i, sl, sub, lpr);
    const float4* p = reinterpret_cast<const float4*>(q + c * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 w = c < words ? p[j] : make_float4(0.f, 0.f, 0.f, 0.f);
      qr.v[i][4 * j] = w.x;
      qr.v[i][4 * j + 1] = w.y;
      qr.v[i][4 * j + 2] = w.z;
      qr.v[i][4 * j + 3] = w.w;
    }
  }
}

// The four int8 bytes of a packed word as floats.
__device__ __forceinline__ void unpack4(uint32_t w, float (&x)[4]) {
#ifdef CODEC_ROW_CAST_UNPACK
  x[0] = static_cast<float>(static_cast<int8_t>(w));
  x[1] = static_cast<float>(static_cast<int8_t>(w >> 8));
  x[2] = static_cast<float>(static_cast<int8_t>(w >> 16));
  x[3] = static_cast<float>(static_cast<int8_t>(w >> 24));
#else
  const uint32_t u = w ^ 0x80808080u;  // each byte + 128, unsigned
  x[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.0f;
  x[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.0f;
  x[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.0f;
  x[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.0f;
#endif
}

// One 16-byte word of a row against its 16 query floats: ip[j] += sum x * q
// over packed word j and, with SQ, sq += sum x * x.
template <bool SQ>
__device__ __forceinline__ void word_product(const int4& v, const float (&qv)[16],
                                             float (&ip)[4], int& sq) {
#ifdef CODEC_ROW_NO_MATH
  sq += v.x ^ v.y ^ v.z ^ v.w;
  (void)qv;
  (void)ip;
#else
  const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                         static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float x[4];
    unpack4(w[j], x);
    ip[j] = fmaf(x[0], qv[4 * j], ip[j]);
    ip[j] = fmaf(x[1], qv[4 * j + 1], ip[j]);
    ip[j] = fmaf(x[2], qv[4 * j + 2], ip[j]);
    ip[j] = fmaf(x[3], qv[4 * j + 3], ip[j]);
    if (SQ) sq = __dp4a(static_cast<int>(w[j]), static_cast<int>(w[j]), sq);
  }
#endif
}

// A lane's words of one row (v[i] is word word_index(i), zero where the row is
// not live or the word is past its end) against the lane's query registers:
// the lane's part of the inner product, and sq += its part of |c|^2.
// `qs` is the query in shared memory, read only under CODEC_ROW_SMEM_QUERY.
template <int NCH, bool SQ>
__device__ __forceinline__ float row_product(const int4 (&v)[NCH], const Query<NCH>& qr,
                                             const float* qs, int lpr, int sl, int sub,
                                             int& sq) {
  float ip[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
#ifdef CODEC_ROW_SMEM_QUERY
    float qv[16];
    const float4* p =
        reinterpret_cast<const float4*>(qs + word_index<NCH>(i, sl, sub, lpr) * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 w = p[j];
      qv[4 * j] = w.x;
      qv[4 * j + 1] = w.y;
      qv[4 * j + 2] = w.z;
      qv[4 * j + 3] = w.w;
    }
    word_product<SQ>(v[i], qv, ip, sq);
#else
    word_product<SQ>(v[i], qr.v[i], ip, sq);
#endif
  }
  return (ip[0] + ip[1]) + (ip[2] + ip[3]);
}

// Sum over the lpr lanes of a row group (lpr a power of two; all 32 lanes of
// the warp call this together). Every lane of the group ends with the sum.
// Unrolled with uniform predicates: a loop over `lpr` costs a branch a step.
__device__ __forceinline__ void group_sum(float& ip, int& sq, int lpr, bool with_sq) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < lpr) {
      ip += __shfl_xor_sync(0xffffffffu, ip, off);
      if (with_sq) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
  }
}

// The score of one row from its raw inner product `ip` (int8 units), its
// dequantized squared norm `csq`, and the query's norm term `sn`:
//   form 0 (L2):     sqrt(max(sn - 2 scale ip + csq, 0)),  sn = |q|^2
//   form 1 (Dot):    1 - scale ip
//   form 2 (Cosine): 1 - scale ip / max(sn, 1e-20),        sn = |q|
__device__ __forceinline__ float finish(int form, float ip, float csq, float sn, float scale) {
  const float ipf = ip * scale;
  if (form == 0) return sqrtf(fmaxf(sn - 2.0f * ipf + csq, 0.0f));
  if (form == 1) return 1.0f - ipf;
  return 1.0f - ipf / fmaxf(sn, 1e-20f);
}

}  // namespace codec_row
