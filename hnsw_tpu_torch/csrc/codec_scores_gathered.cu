// Codec scores over pre-gathered blocks (kernel B4).
//
// Replaces hnsw_tpu/ops/pallas_scores.py::_kernel (pallas_codec_scores). The
// caller has already gathered, for each query b, the K int8 neighbour rows of
// its expanded nodes into blk[b] = [K, d] (contiguous) and their quantized
// squared norms into csq[b] = [K]. Each row is dequantized by `scale` and
// scored against the f32 query (codec_row.cuh: `finish` has the three forms)
// with ip = scale * sum_k blk[b, r, k] * q[b, k]. Unlike the fused kernel
// (codec_scores.cu) |c|^2 is read from csq as given, not recomputed from the
// row, so the two kernels agree to rounding, not bit for bit.
//
// Bound on the H100: bytes. The gathered blocks are streamed once (B*K*d int8,
// 0.47 GB at B=16384, K=224, d=128), csq and the output are B*K f32 each:
// ~0.15 ms at 3.35 TB/s, against 2 flops per byte.
//
// Two entries, named by the caller (ops/codec_scores.py::gathered_entry):
//
// "stream" (d % 16 == 0, d <= 1024, 16-byte aligned inputs). blk[b] is one
// contiguous stream, so there is nothing to stage: one block per query, the
// query in registers (codec_row.cuh), a row handled by a group of lpr lanes
// with 16-byte streaming loads (8 lanes per 128-byte row at d=128, so a warp
// reads four consecutive rows = 512 contiguous bytes). The row loop is
// software-pipelined: a step is UNROLL = 2 rows per lane, and the loads of
// step n + 1 (and the csq values of its rows) are started before the products
// of step n, so a warp computes with its next rows in flight. The number of
// warps is picked so that the steps over K rows leave the fewest lanes idle
// (7 warps x 8 rows = four whole steps at K = 224).
//
// "rows" (any d, any alignment). The first port's kernel: the query in shared
// memory, one load in flight per lane, bytes when d % 16 != 0.
//
// Measurement hooks (tools/codec_variants.py; results are wrong with each):
// -DCODEC_ROW_NO_MATH, -DCODEC_ROW_SMEM_QUERY (codec_row.cuh);
// -DCODEC_ROW_NO_LOAD: the rows are made up in registers, nothing is loaded;
// -DCODEC_STREAM_UNROLL=n: n rows per lane and step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "codec_row.cuh"

namespace {

// ------------------------------------------------------------ entry "rows"

template <bool VEC16>
__global__ void codec_scores_gathered_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ blk,
    const float* __restrict__ csq, const float* __restrict__ qsn,
    const float* __restrict__ scale_ptr, int K, int d, int form, int lpr,
    float* __restrict__ out) {
  extern __shared__ float qs[];  // [d] f32 query
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = q[(size_t)b * d + k];
  __syncthreads();
  const float sn = qsn[b];
  const float scale = *scale_ptr;
  const int8_t* my_blk = blk + (size_t)b * K * d;
  const float* my_csq = csq + (size_t)b * K;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = lane / lpr;        // row slot inside the warp
  const int sl = lane - sub * lpr;   // lane inside the row group
  const int per_warp = 32 / lpr;
  const int chunks = d / 16;
  for (int base = warp * per_warp; base < K; base += nwarps * per_warp) {
    const int r = base + sub;
    const bool live = r < K;
    float ip = 0.f;
    if (live) {
      const int8_t* row = my_blk + (size_t)r * d;
      if (VEC16) {
        for (int c = sl; c < chunks; c += lpr) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(row) + c);
          const int8_t* by = reinterpret_cast<const int8_t*>(&v);
          const float4* qv = reinterpret_cast<const float4*>(qs + c * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 w = qv[j];
            ip += (float)by[4 * j] * w.x + (float)by[4 * j + 1] * w.y +
                  (float)by[4 * j + 2] * w.z + (float)by[4 * j + 3] * w.w;
          }
        }
      } else {
        for (int k = sl; k < d; k += lpr) ip += (float)row[k] * qs[k];
      }
    }
    for (int off = lpr >> 1; off > 0; off >>= 1)
      ip += __shfl_xor_sync(0xffffffffu, ip, off);
    if (live && sl == 0)
      out[(size_t)b * K + r] =
          codec_row::finish(form, ip, form == 0 ? my_csq[r] : 0.f, sn, scale);
  }
}

// ---------------------------------------------------------- entry "stream"

constexpr int STREAM_MAX_THREADS = 256;
#ifndef CODEC_STREAM_UNROLL
#define CODEC_STREAM_UNROLL 2
#endif
constexpr int UNROLL = CODEC_STREAM_UNROLL;  // rows per lane and step, NCH loads each

template <int NCH>
__global__ void __launch_bounds__(STREAM_MAX_THREADS) codec_scores_stream_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ blk,
    const float* __restrict__ csq, const float* __restrict__ qsn,
    const float* __restrict__ scale_ptr, int K, int d, int form, int lpr,
    float* __restrict__ out) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int words = d / 16;
  const int per_warp = 32 / lpr;
  const int sub = lane / lpr;       // row slot inside the warp
  const int sl = lane - sub * lpr;  // lane inside the row group
  const int rows_per_pass = (blockDim.x >> 5) * per_warp;
  const int8_t* my_blk = blk + (size_t)b * K * d;
  const float* my_csq = csq + (size_t)b * K;
  float* my_out = out + (size_t)b * K;
#ifdef CODEC_ROW_SMEM_QUERY
  __shared__ float qs[1024];
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = q[(size_t)b * d + k];
  __syncthreads();
#else
  const float* qs = nullptr;
#endif
  codec_row::Query<NCH> qr;
  codec_row::load_query<NCH>(qr, q + (size_t)b * d, words, lpr, sl, sub);
  const float sn = qsn[b];
  const float scale = *scale_ptr;
  const bool want_csq = form == 0 && sl == 0;

  // The loads of step n + 1 are started before the products of step n: a warp
  // always has UNROLL rows in flight while it computes.
  const int step = UNROLL * rows_per_pass;
  int4 v[UNROLL][NCH];
  float cq[UNROLL];
  auto start_loads = [&](int base0) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base0 + u * rows_per_pass + sub;
      const bool live = r < K;
      const int4* row = reinterpret_cast<const int4*>(my_blk + (size_t)r * d);
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = codec_row::word_index<NCH>(i, sl, sub, lpr);
#ifdef CODEC_ROW_NO_LOAD
        v[u][i] = make_int4(r, r ^ lane, r + c, lane);
#else
        v[u][i] = live && c < words ? __ldcs(row + c) : make_int4(0, 0, 0, 0);
#endif
      }
      cq[u] = live && want_csq ? __ldg(my_csq + r) : 0.f;
    }
  };
  start_loads(warp * per_warp);
  for (int base0 = warp * per_warp; base0 < K; base0 += step) {
    int4 w[UNROLL][NCH];
    float cw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      cw[u] = cq[u];
#pragma unroll
      for (int i = 0; i < NCH; ++i) w[u][i] = v[u][i];
    }
    if (base0 + step < K) start_loads(base0 + step);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int r = base0 + u * rows_per_pass + sub;
      int sq = 0;
      float ip = codec_row::row_product<NCH, false>(w[u], qr, qs, lpr, sl, sub, sq);
#ifdef CODEC_ROW_NO_MATH
      ip = (float)sq;
#endif
      codec_row::group_sum(ip, sq, lpr, false);
      if (r < K && sl == 0) my_out[r] = codec_row::finish(form, ip, cw[u], sn, scale);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// entry: 0 = "rows", 1 = "stream" (ops/codec_scores.py::GATHERED_ENTRIES). An
// entry that does not take the shape returns cudaErrorInvalidValue.
extern "C" int codec_scores_gathered_launch(const void* q, const void* blk,
                                            const void* csq, const void* qsn,
                                            const void* scale, int B, int K,
                                            int d, int form, int entry,
                                            void* out, void* stream) {
  if (B == 0 || K == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec16 = (d % 16) == 0 && aligned16(blk);
  if (entry == 1) {
    if (!vec16 || !aligned16(q)) return (int)cudaErrorInvalidValue;
    int lpr = 0, nch = 0;
    // one word a lane where 32 lanes cover the row: measured faster here than two
    // (fewer registers, more blocks per SM)
    codec_row::row_geometry(d, 1, &lpr, &nch);
    if (nch > codec_row::MAX_NCH) return (int)cudaErrorInvalidValue;
    // warps: the count whose steps over K rows leave the fewest lanes idle
    const int threads = codec_row::pick_warps(K, 32 / lpr * UNROLL) * 32;
    if (nch == 1) {
      codec_scores_stream_kernel<1><<<B, threads, 0, s>>>(
          (const float*)q, (const int8_t*)blk, (const float*)csq, (const float*)qsn,
          (const float*)scale, K, d, form, lpr, (float*)out);
    } else {
      codec_scores_stream_kernel<2><<<B, threads, 0, s>>>(
          (const float*)q, (const int8_t*)blk, (const float*)csq, (const float*)qsn,
          (const float*)scale, K, d, form, lpr, (float*)out);
    }
    return (int)cudaGetLastError();
  }
  if (entry != 0) return (int)cudaErrorInvalidValue;
  int lpr = 32;
  if (vec16) {
    const int chunks = d / 16;
    lpr = 1;
    while (lpr * 2 <= chunks && lpr < 32) lpr *= 2;
  }
  const dim3 grid(B), block(256);
  const size_t smem = (size_t)d * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        vec16 ? codec_scores_gathered_kernel<true>
              : codec_scores_gathered_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (vec16) {
    codec_scores_gathered_kernel<true><<<grid, block, smem, s>>>(
        (const float*)q, (const int8_t*)blk, (const float*)csq,
        (const float*)qsn, (const float*)scale, K, d, form, lpr, (float*)out);
  } else {
    codec_scores_gathered_kernel<false><<<grid, block, smem, s>>>(
        (const float*)q, (const int8_t*)blk, (const float*)csq,
        (const float*)qsn, (const float*)scale, K, d, form, lpr, (float*)out);
  }
  return (int)cudaGetLastError();
}
