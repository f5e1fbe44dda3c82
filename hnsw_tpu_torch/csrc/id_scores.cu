// Scores of a query against the rows its ids name, read straight from the
// vector table (ops/id_scores.py).
//
// Replaces no TPU kernel: the JAX package scores id-named rows with a plain
// jnp gather and einsum (hnsw_tpu/ops/beam_search.py::scores_gathered over
// vectors[ids]). The port did the same with a torch gather, which writes a
// [B, K, d] copy of the rows to device memory, and a library matrix-vector
// product that reads it back: each row crossed device memory three times. At 1M x 128 f32, M = 48,
// B = 10,000 and K = 384 that copy is 1.97 GB a beam iteration, and the gather
// and the gemv were 62% of the search's device time. This kernel reads each
// row once and writes one float per id.
//
// Bound on the H100: bytes. Per call: the rows of the valid ids (d * 4 bytes
// in f32, d * 2 in bf16) and their squared norms (L2), the ids, the queries
// and the scores. An id named twice may be served from L2 the second time, so
// the floor counts each distinct row once; every id valid and distinct, the
// shape above moves B * K * (row + 12) bytes, 0.51 ms at 3.35 TB/s. 2 flops a
// row element, so the arithmetic is never the limit.
//
// Contract (the plain version, ops/id_scores.py::id_scores_plain, is the
// reference):
//   q [B, d] f32 (row-major, 16-byte aligned), vectors [N, d] f32 or bf16
//   with rows `ld` elements apart (any d, any alignment), sqnorms [N] f32,
//   ids [B, K] int32 -> out [B, K] f32.
//   An id < 0 reads nothing and scores +INF; an id >= N is clamped to N - 1.
//   ip = sum q[k] * x[k] in f32: f32 rows take q as it is, bf16 rows take q
//   rounded to bf16 (the reference's bf16-in, f32-out einsum).
//   form 0 (L2):     sqrt(max(|q|^2 - 2 ip + sqnorms[id], 0)), |q|^2 of the f32 q
//   form 1 (Dot):    1 - ip
//   form 2 (Cosine): 1 - (den > 0 ? ip / max(den, 1e-10) : 0), den = |q| |x|,
//                    |x| the row's own norm
//
// Design. One warp scores 32 consecutive ids of one query (a chunk; ceil(K /
// 32) chunks a query, eight warps a block). The warp loads its 32 ids with
// one coalesced load, writes +INF for the negative ones at once, and lists
// the valid ones in order (a ballot, each valid lane's rank its place in a
// warp-private list in shared memory): the passes walk that list alone, so
// an invalid id costs no pass and every load in flight is a row that is
// scored (mid-search about half the beam's candidates are revisits). Each
// valid id goes to the lanes that read its row by a shuffle. A row is read
// in 16-byte words where its bytes, its stride and the table allow (a wide
// row), else one element a load, by a group of `lpr` lanes (a power of two,
// at most 32), lane `sl` of a group owning words sl, sl + lpr, ...
//
// Two kernels share that frame:
//   id_scores_kernel: wide rows of at most 8 words a lane (f32 d <= 1024,
//   bf16 d <= 2048), the searched widths. lpr is the smallest power of two
//   >= the row's words: 32 lanes x 16 bytes at d = 128 f32, 16 lanes at d =
//   128 bf16, two rows a pass. The lane's words of the query stay in
//   registers (bf16-rounded for bf16 rows; loaded while the ids are in
//   flight), so nothing but rows, ids, norms and scores moves through memory.
//   Random 256-512-byte rows come from device memory at its latency, so a
//   lane issues the loads of U = 4 / NCH passes before it computes any of
//   them. Resident warps hide that latency better than loads per warp: at d
//   = 128 (56 registers, four blocks a multiprocessor) 2 or 4 loads a lane
//   ran at 74% of the bound (f32, 45% of the ids valid), 8 at 61%, 16 at 44%
//   and 24 at 28%, and launch bounds that forced 32-40 registers cost 10-45%
//   (H100 80GB HBM3, 700 W).
//   id_scores_long_kernel: every other row (longer, or not in whole 16-byte
//   words: d % 4 f32, d % 8 bf16, an odd stride or an unaligned table). lpr
//   is the smallest power of two >= a quarter of the row's loads, so a lane
//   has up to 4 loads of a row in flight; longer rows loop in passes of 4
//   loads a lane. The query's words are read beside the row's (the warp's 32
//   ids share them, so they come from L1), not held in registers.
// The sums are plain f32 FMAs in four independent chains, reduced over the
// group by xor shuffles; no atomics, so the result is the same on every run
// and every card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;            // warps a block
constexpr int LOADS_IN_FLIGHT = 4;  // loads a lane issues at once
constexpr int MAX_NCH = 8;          // words a lane held by id_scores_kernel

// A 16-byte word of a row as floats: 4 f32 or 8 bf16 values.
template <typename T>
struct Word;

template <>
struct Word<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const int4& v, float (&x)[N]) {
    x[0] = __int_as_float(v.x);
    x[1] = __int_as_float(v.y);
    x[2] = __int_as_float(v.z);
    x[3] = __int_as_float(v.w);
  }
  __device__ __forceinline__ static float round_query(float x) { return x; }
};

template <>
struct Word<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 -> f32 is exact: the bf16 bits are the f32's upper half
  __device__ __forceinline__ static void unpack(const int4& v, float (&x)[N]) {
    const uint32_t w[4] = {static_cast<uint32_t>(v.x), static_cast<uint32_t>(v.y),
                           static_cast<uint32_t>(v.z), static_cast<uint32_t>(v.w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(w[j] << 16);
      x[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  // round to nearest even, as torch's f32 -> bf16 cast
  __device__ __forceinline__ static float round_query(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// One load of a row for id_scores_long_kernel: a 16-byte word (WIDE) or one
// element.
template <typename T, bool WIDE>
struct Unit;

template <typename T>
struct Unit<T, true> {
  using Raw = int4;
  static constexpr int N = Word<T>::N;
  __device__ __forceinline__ static Raw load(const T* p) {
    return __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ static Raw zero() { return make_int4(0, 0, 0, 0); }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&x)[N]) {
    Word<T>::unpack(r, x);
  }
};

template <>
struct Unit<float, false> {
  using Raw = float;
  static constexpr int N = 1;
  __device__ __forceinline__ static Raw load(const float* p) { return __ldg(p); }
  __device__ __forceinline__ static Raw zero() { return 0.f; }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&x)[N]) { x[0] = r; }
};

template <>
struct Unit<__nv_bfloat16, false> {
  using Raw = unsigned short;
  static constexpr int N = 1;
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ static Raw zero() { return 0; }
  __device__ __forceinline__ static void unpack(const Raw& r, float (&x)[N]) {
    x[0] = __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
};

// N f32 values of the query (N a multiple of 4 from a 16-byte aligned
// address, or 1).
template <int N>
__device__ __forceinline__ void load_query(const float* p, float (&x)[N]) {
  if constexpr (N == 1) {
    x[0] = __ldg(p);
  } else {
#pragma unroll
    for (int j = 0; j < N; j += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p + j));
      x[j] = v.x;
      x[j + 1] = v.y;
      x[j + 2] = v.z;
      x[j + 3] = v.w;
    }
  }
}

// Sum over the lpr lanes of a group (a power of two); every lane of the group
// ends with the sum. All 32 lanes call it together.
__device__ __forceinline__ float group_sum(float x, int lpr) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    if (off < lpr) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The lane's id of the chunk at `slot` (-1 past K), clamped to N - 1.
__device__ __forceinline__ int chunk_id(const int* ids, int b, int K, int N, int slot) {
  if (slot >= K) return -1;
  const int id = __ldg(ids + (size_t)b * K + slot);
  return id >= N ? N - 1 : id;
}

// +INF for a negative id inside K; the valid ids' lanes listed in order in
// the warp's `order`. Returns how many are valid. All 32 lanes call it.
__device__ __forceinline__ int list_valid(int my_id, bool in_k, int lane, float* ob,
                                          int* order) {
  if (in_k && my_id < 0) ob[lane] = INFINITY;
  const unsigned valid = __ballot_sync(0xffffffffu, my_id >= 0);
  if (my_id >= 0) order[__popc(valid & ((1u << lane) - 1u))] = lane;
  __syncwarp();
  return __popc(valid);
}

__device__ __forceinline__ float epilogue(int form, float qq, float qn, float ip, float cc,
                                          float csq) {
  if (form == 0) return sqrtf(fmaxf(qq - 2.0f * ip + csq, 0.0f));
  if (form == 1) return 1.0f - ip;
  const float den = qn * sqrtf(cc);
  return 1.0f - (den > 0.f ? ip / fmaxf(den, 1e-10f) : 0.0f);
}

template <typename T, int NCH>
__global__ void __launch_bounds__(WARPS * 32) id_scores_kernel(
    const float* __restrict__ q, const T* __restrict__ vectors,
    const float* __restrict__ sqnorms, const int* __restrict__ ids, int B, int K,
    int N, int d, long long ld, int form, int lpr, int chunks, float* __restrict__ out) {
  constexpr int EW = Word<T>::N;  // row elements a word
  constexpr int U = NCH >= LOADS_IN_FLIGHT ? 1 : LOADS_IN_FLIGHT / NCH;  // passes a batch
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= (long long)B * chunks) return;  // whole warps leave together
  const int b = (int)(gw / chunks);
  const int slot0 = (int)(gw - (long long)b * chunks) * 32;
  const int words = d / EW;
  const int per_pass = 32 / lpr;  // rows a pass
  const int sub = lane / lpr;     // the lane's row in a pass
  const int sl = lane - sub * lpr;
  float* ob = out + (size_t)b * K + slot0;

  const int my_id = chunk_id(ids, b, K, N, slot0 + lane);
  // the lane's words of the query (bf16-rounded for bf16 rows), loaded while
  // the ids are in flight, and its part of |q|^2 in f32
  float qv[NCH][EW];
  float qq = 0.f;
  const float* qb = q + (size_t)b * d;
#pragma unroll
  for (int i = 0; i < NCH; ++i) {
    const int w = sl + i * lpr;
#pragma unroll
    for (int j = 0; j < EW; j += 4) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (w < words) x = __ldg(reinterpret_cast<const float4*>(qb + w * EW + j));
      qq = fmaf(x.x, x.x, qq);
      qq = fmaf(x.y, x.y, qq);
      qq = fmaf(x.z, x.z, qq);
      qq = fmaf(x.w, x.w, qq);
      qv[i][j] = Word<T>::round_query(x.x);
      qv[i][j + 1] = Word<T>::round_query(x.y);
      qv[i][j + 2] = Word<T>::round_query(x.z);
      qv[i][j + 3] = Word<T>::round_query(x.w);
    }
  }
  __shared__ int order[WARPS][32];
  int* my_order = order[threadIdx.x >> 5];
  const int nv = list_valid(my_id, slot0 + lane < K, lane, ob, my_order);
  if (nv == 0) return;  // whole warps leave together
  qq = group_sum(qq, lpr);
  const float qn = sqrtf(qq);

  for (int p0 = 0; p0 * per_pass < nv; p0 += U) {
    int4 v[U][NCH];
    int id[U], at[U];
    float cq[U];
    // the loads of U passes, all issued before any product: pass p's row for
    // this lane is the (p * per_pass + sub)-th valid id, at slot at[u]
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = (p0 + u) * per_pass + sub;
      at[u] = k < nv ? my_order[k] : -1;
      id[u] = __shfl_sync(0xffffffffu, my_id, at[u] & 31);
      if (at[u] < 0) id[u] = -1;
      const int4* row = reinterpret_cast<const int4*>(vectors + (size_t)max(id[u], 0) * ld);
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int w = sl + i * lpr;
        v[u][i] = id[u] >= 0 && w < words ? __ldg(row + w) : make_int4(0, 0, 0, 0);
      }
      cq[u] = form == 0 && id[u] >= 0 && sl == 0 ? __ldg(sqnorms + id[u]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float ip[4] = {0.f, 0.f, 0.f, 0.f};
      float xx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        float x[EW];
        Word<T>::unpack(v[u][i], x);
#pragma unroll
        for (int j = 0; j < EW; ++j) {
          ip[j & 3] = fmaf(x[j], qv[i][j], ip[j & 3]);
          if (form == 2) xx[j & 3] = fmaf(x[j], x[j], xx[j & 3]);
        }
      }
      const float s = group_sum((ip[0] + ip[1]) + (ip[2] + ip[3]), lpr);
      const float cc = form == 2 ? group_sum((xx[0] + xx[1]) + (xx[2] + xx[3]), lpr) : 0.f;
      if (sl == 0 && at[u] >= 0) ob[at[u]] = epilogue(form, qq, qn, s, cc, cq[u]);
    }
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(WARPS * 32) id_scores_long_kernel(
    const float* __restrict__ q, const T* __restrict__ vectors,
    const float* __restrict__ sqnorms, const int* __restrict__ ids, int B, int K,
    int N, int d, long long ld, int form, int lpr, int chunks, float* __restrict__ out) {
  using L = Unit<T, WIDE>;
  constexpr int VE = L::N;  // row elements a load
  constexpr int U = LOADS_IN_FLIGHT;
  const int lane = threadIdx.x & 31;
  const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (gw >= (long long)B * chunks) return;  // whole warps leave together
  const int b = (int)(gw / chunks);
  const int slot0 = (int)(gw - (long long)b * chunks) * 32;
  const int words = d / VE;
  const int per_pass = 32 / lpr;
  const int sub = lane / lpr;
  const int sl = lane - sub * lpr;
  float* ob = out + (size_t)b * K + slot0;
  const float* qb = q + (size_t)b * d;

  const int my_id = chunk_id(ids, b, K, N, slot0 + lane);
  __shared__ int order[WARPS][32];
  int* my_order = order[threadIdx.x >> 5];
  const int nv = list_valid(my_id, slot0 + lane < K, lane, ob, my_order);
  if (nv == 0) return;  // whole warps leave together
  // |q|^2 of the f32 query: the lane's words, then the group's
  float qq = 0.f;
  for (int w = sl; w < words; w += lpr) {
    float x[VE];
    load_query<VE>(qb + (size_t)w * VE, x);
#pragma unroll
    for (int j = 0; j < VE; ++j) qq = fmaf(x[j], x[j], qq);
  }
  qq = group_sum(qq, lpr);
  const float qn = sqrtf(qq);

  for (int p = 0; p * per_pass < nv; ++p) {
    const int k = p * per_pass + sub;
    const int at = k < nv ? my_order[k] : -1;
    int id = __shfl_sync(0xffffffffu, my_id, at & 31);
    if (at < 0) id = -1;
    const T* row = vectors + (size_t)max(id, 0) * ld;
    const float cq = form == 0 && id >= 0 && sl == 0 ? __ldg(sqnorms + id) : 0.f;
    float ip[4] = {0.f, 0.f, 0.f, 0.f};
    float xx[4] = {0.f, 0.f, 0.f, 0.f};
    // U loads of the row a lane, then their products (a lane of a group
    // whose row is not valid reads nothing)
    for (int w0 = sl; id >= 0 && w0 < words; w0 += U * lpr) {
      typename L::Raw r[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w = w0 + u * lpr;
        r[u] = w < words ? L::load(row + (size_t)w * VE) : L::zero();
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int w = w0 + u * lpr;
        float x[VE], qx[VE];
        L::unpack(r[u], x);
        if (w < words) {
          load_query<VE>(qb + (size_t)w * VE, qx);
        } else {
#pragma unroll
          for (int j = 0; j < VE; ++j) qx[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < VE; ++j) {
          const int c = (u * VE + j) & 3;
          ip[c] = fmaf(x[j], Word<T>::round_query(qx[j]), ip[c]);
          if (form == 2) xx[c] = fmaf(x[j], x[j], xx[c]);
        }
      }
    }
    const float s = group_sum((ip[0] + ip[1]) + (ip[2] + ip[3]), lpr);
    const float cc = form == 2 ? group_sum((xx[0] + xx[1]) + (xx[2] + xx[3]), lpr) : 0.f;
    if (sl == 0 && at >= 0) ob[at] = epilogue(form, qq, qn, s, cc, cq);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <typename T>
int launch_typed(const float* q, const T* vectors, const float* sqnorms, const int* ids,
                 int B, int K, int N, int d, long long ld, int form, float* out,
                 cudaStream_t s) {
  constexpr int EW = Word<T>::N;
  // whole 16-byte words: the row's bytes, its stride and the table's start
  const bool wide = d % EW == 0 && ld % EW == 0 && aligned16(vectors);
  const int words = wide ? d / EW : d;  // loads a row
  const int chunks = (K + 31) / 32;
  const long long warps = (long long)B * chunks;
  const unsigned grid = (unsigned)((warps + WARPS - 1) / WARPS);
  const dim3 block(WARPS * 32);
  int lpr = 1;
  if (wide && words <= MAX_NCH * 32) {
    while (lpr < words && lpr < 32) lpr *= 2;
    const int nch = (words + lpr - 1) / lpr;
    if (nch == 1)
      id_scores_kernel<T, 1><<<grid, block, 0, s>>>(q, vectors, sqnorms, ids, B, K, N, d,
                                                    ld, form, lpr, chunks, out);
    else if (nch == 2)
      id_scores_kernel<T, 2><<<grid, block, 0, s>>>(q, vectors, sqnorms, ids, B, K, N, d,
                                                    ld, form, lpr, chunks, out);
    else if (nch <= 4)
      id_scores_kernel<T, 4><<<grid, block, 0, s>>>(q, vectors, sqnorms, ids, B, K, N, d,
                                                    ld, form, lpr, chunks, out);
    else
      id_scores_kernel<T, MAX_NCH><<<grid, block, 0, s>>>(q, vectors, sqnorms, ids, B, K,
                                                          N, d, ld, form, lpr, chunks, out);
  } else {
    while (lpr * LOADS_IN_FLIGHT < words && lpr < 32) lpr *= 2;
    if (wide)
      id_scores_long_kernel<T, true><<<grid, block, 0, s>>>(
          q, vectors, sqnorms, ids, B, K, N, d, ld, form, lpr, chunks, out);
    else
      id_scores_long_kernel<T, false><<<grid, block, 0, s>>>(
          q, vectors, sqnorms, ids, B, K, N, d, ld, form, lpr, chunks, out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: 0 = f32 rows, 1 = bf16 rows (ops/id_scores.py::id_scores_entry names
// them "f32" and "bf16"); ld: elements from one row to the next. Any d and
// any table; q must be 16-byte aligned. Anything else returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int id_scores_launch(const void* q, const void* vectors, const void* sqnorms,
                                const void* ids, int B, int K, int N, int d, long long ld,
                                int form, int bf16, void* out, void* stream) {
  if (B == 0 || K == 0) return 0;
  if (N <= 0 || d <= 0 || ld < 0 || form < 0 || form > 2 || !aligned16(q))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16>((const float*)q, (const __nv_bfloat16*)vectors,
                                       (const float*)sqnorms, (const int*)ids, B, K, N, d,
                                       ld, form, (float*)out, s);
  return launch_typed<float>((const float*)q, (const float*)vectors, (const float*)sqnorms,
                             (const int*)ids, B, K, N, d, ld, form, (float*)out, s);
}
