// Fused codec gather + score for the beam loop (kernels B1 and B3).
//
// Replaces hnsw_tpu/ops/pallas_scores.py::_fused_kernel_ids (B1) and, with
// RID == 0, ::_fused_kernel (B3). For each query b and each of its E expanded
// nodes src[b, e], the node's int8 block [M0 + RID, d] is read straight from
// the [cap1, M0 + RID, d] codec table. Rows [0, M0) are the quantized
// neighbour vectors; each is dequantized by `scale` and scored against the f32
// query (codec_row.cuh: `finish` has the three forms), |c|^2 recomputed from
// the row. qsn[b] carries |q|^2 (L2) or |q| (Cosine). Rows [M0, M0 + RID) hold
// the node's neighbour ids as int32 bytes; the first M0 of them are copied to
// out_ids, so the caller gets decoded int32 ids and needs no byte pass.
//
// Bound on the H100: bytes. Each call gathers the M0 int8 vector rows and the
// M0 int32 ids of B*E blocks at random addresses, B*E*M0*(d+4) bytes (0.48 GB
// at B=16384, E=4, M0=56, d=128; with the query and the outputs ~0.16 ms at
// 3.35 TB/s), against ~4 flops per byte.
//
// Two entries, named by the caller (ops/codec_scores.py::codec_entry), never
// chosen after a failure:
//
// "bulk" (d % 16 == 0, d <= 1024). A node's vector rows and the id words
// behind them are ONE contiguous run of M0*d + 4*M0 bytes, 16-byte aligned:
// exactly what Hopper's bulk asynchronous copy moves with one instruction from
// one thread. A persistent grid (as many blocks as the card holds at once, by
// the occupancy of this kernel) gives every block a contiguous range of
// queries, so the block's nodes are a contiguous run of `src`. A producer
// warp reads 32 node ids at a time and lane 0 starts one bulk copy per node
// into a ring of stages in shared memory (up to 8 stages, 7.4 KB each at
// M0=56, d=128: about 170 KB in flight per SM with three blocks), each copy
// completing on its stage's "full" barrier; it reuses a stage when the
// consumer warps have handed it back through its "empty" barrier (one arrival
// per warp). The consumer warps take the stages in order: a row goes to a
// group of lpr lanes that read their 16-byte words from shared memory (no
// bank conflict: codec_row::word_index), the product runs against the
// query in registers (codec_row.cuh), the group sums by warp shuffles, and each
// row's id is copied from the tail of the stage beside its score. The number of
// consumer warps is picked so that the passes over M0 rows leave the fewest
// lanes idle (7 warps x 8 rows = one whole pass at M0 = 56, d = 128).
//
// "rows" (any d). The first port's kernel: one block per query, the query in
// shared memory, rows read from device memory by the lanes themselves
// (16-byte loads when d % 16 == 0, else bytes), a strided pass for the ids.
//
// Measurement hooks (tools/codec_variants.py; results are wrong with the
// first two): -DCODEC_ROW_NO_MATH, -DCODEC_ROW_SMEM_QUERY, -DCODEC_ROW_CAST_UNPACK
// (codec_row.cuh); -DCODEC_ROW_NO_LOAD: no copy is started and no barrier
// waited for, the product runs on whatever the stages hold;
// -DCODEC_SCORES_PREFETCH: the "bulk" entry launches the no-staging
// comparison instead (one block per query, register query, every lane starts
// all of its 16-byte loads, up to 16, before the first product);
// -DCODEC_RING_SMEM=bytes and -DCODEC_RING_MAX_STAGES=n resize the ring;
// -DCODEC_BULK_STAGED_QUERY: the query's 4*d bytes ride into the ring with
// the query's first node instead of being loaded by the consumers.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

#include "codec_row.cuh"
#include "mbarrier.cuh"

#ifndef CODEC_RING_SMEM
#define CODEC_RING_SMEM (72 * 1024)  // ring bytes a block aims for: 3 blocks per SM
#endif
#ifndef CODEC_RING_MAX_STAGES
#define CODEC_RING_MAX_STAGES 8
#endif

namespace {

using namespace hopper;

constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90
constexpr int STAGE_ALIGN = 128;

// ------------------------------------------------------------ entry "rows"

template <bool VEC16>
__global__ void codec_scores_kernel(const int32_t* __restrict__ src,
                                    const float* __restrict__ q,
                                    const float* __restrict__ qsn,
                                    const float* __restrict__ scale_ptr,
                                    const int8_t* __restrict__ blocks,
                                    int E, int M0, int RID, int d, int form,
                                    int lpr, float* __restrict__ out,
                                    int32_t* __restrict__ out_ids) {
  extern __shared__ float qs[];  // [d] f32 query
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < d; k += blockDim.x) qs[k] = q[(size_t)b * d + k];
  __syncthreads();
  const float sn = qsn[b];
  const float scale = *scale_ptr;
  const int rows = E * M0;
  const size_t blk_rows = (size_t)(M0 + RID);
  const int32_t* my_src = src + (size_t)b * E;

  if (out_ids != nullptr) {
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      const int e = t / M0, m = t - (t / M0) * M0;
      const int32_t* idrow = reinterpret_cast<const int32_t*>(
          blocks + ((size_t)my_src[e] * blk_rows + M0) * d);
      out_ids[(size_t)b * rows + t] = idrow[m];
    }
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int sub = lane / lpr;        // row slot inside the warp
  const int sl = lane - sub * lpr;   // lane inside the row group
  const int per_warp = 32 / lpr;
  const int chunks = d / 16;
  for (int base = warp * per_warp; base < rows; base += nwarps * per_warp) {
    const int r = base + sub;
    const bool live = r < rows;
    float ip = 0.f, sq = 0.f;
    if (live) {
      const int e = r / M0, m = r - (r / M0) * M0;
      const int8_t* row = blocks + ((size_t)my_src[e] * blk_rows + m) * d;
      if (VEC16) {
        for (int c = sl; c < chunks; c += lpr) {
          const int4 v = __ldg(reinterpret_cast<const int4*>(row) + c);
          const int8_t* by = reinterpret_cast<const int8_t*>(&v);
          const float4* qv = reinterpret_cast<const float4*>(qs + c * 16);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 w = qv[j];
            const float x0 = by[4 * j], x1 = by[4 * j + 1];
            const float x2 = by[4 * j + 2], x3 = by[4 * j + 3];
            ip += x0 * w.x + x1 * w.y + x2 * w.z + x3 * w.w;
            sq += x0 * x0 + x1 * x1 + x2 * x2 + x3 * x3;
          }
        }
      } else {
        for (int k = sl; k < d; k += lpr) {
          const float x = row[k];
          ip += x * qs[k];
          sq += x * x;
        }
      }
    }
    for (int off = lpr >> 1; off > 0; off >>= 1) {
      ip += __shfl_xor_sync(0xffffffffu, ip, off);
      sq += __shfl_xor_sync(0xffffffffu, sq, off);
    }
    if (live && sl == 0)
      out[(size_t)b * rows + r] = codec_row::finish(form, ip, sq * (scale * scale), sn, scale);
  }
}

// ------------------------------------------------------------ entry "bulk"

struct RingLayout {
  int stages;
  int stage_stride;  // bytes between stages (a multiple of STAGE_ALIGN)
  int smem;          // stages, then a full and an empty barrier per stage
};

// Blocks [consumer warps | producer warp]. Block k owns queries
// [k * B / grid, (k + 1) * B / grid); its work items are the nodes
// src[b0 * E .. b1 * E) in order, item t in stage t % stages.
// 72 registers at most (three blocks per SM): the kernel's time follows its
// resident warps, see PERF.md.
template <int NCH, bool IDS>
__global__ void __launch_bounds__(288, 3) codec_scores_bulk_kernel(
    const int32_t* __restrict__ src, const float* __restrict__ q,
    const float* __restrict__ qsn, const float* __restrict__ scale_ptr,
    const int8_t* __restrict__ blocks, int B, int E, int M0, int d, int form, int lpr,
    int stages, int stage_stride, uint32_t copy_bytes, size_t block_bytes,
    float* __restrict__ out, int32_t* __restrict__ out_ids) {
  extern __shared__ __align__(128) uint8_t ring[];
  const int nwarps = (blockDim.x >> 5) - 1;  // consumer warps
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const uint32_t ring_addr = smem_u32(ring);
  const uint32_t full_bar = ring_addr + stages * stage_stride;
  const uint32_t empty_bar = full_bar + 8 * stages;
  const int b0 = (int)((long long)blockIdx.x * B / gridDim.x);
  const int b1 = (int)((long long)(blockIdx.x + 1) * B / gridDim.x);

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);        // the producer's expect_tx
      mbar_init(empty_bar + 8 * s, nwarps);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == nwarps) {
    // ---- producer: one bulk copy per node, as far ahead as the ring allows
#ifndef CODEC_ROW_NO_LOAD
    const int items = (b1 - b0) * E;
    const int32_t* my_src = src + (size_t)b0 * E;
    int st = 0;
    uint32_t ph = 0;
#ifdef CODEC_BULK_STAGED_QUERY
    const uint32_t q_bytes = 4u * d;
    int e = 0, b = b0;
#endif
    for (int t0 = 0; t0 < items; t0 += 32) {
      const int mine = t0 + lane < items ? __ldg(my_src + t0 + lane) : 0;
      const int n = min(32, items - t0);
      for (int i = 0; i < n; ++i) {
        const int node = __shfl_sync(0xffffffffu, mine, i);
        if (lane == 0) {
          const uint32_t dst = ring_addr + st * stage_stride;
          const uint32_t bar = full_bar + 8 * st;
          mbar_wait(empty_bar + 8 * st, ph ^ 1u);
#ifdef CODEC_BULK_STAGED_QUERY
          mbar_expect_tx(bar, e == 0 ? copy_bytes + q_bytes : copy_bytes);
          if (e == 0) bulk_load(dst + copy_bytes, q + (size_t)b * d, q_bytes, bar);
#else
          mbar_expect_tx(bar, copy_bytes);
#endif
          bulk_load(dst, blocks + (size_t)node * block_bytes, copy_bytes, bar);
        }
        if (++st == stages) { st = 0; ph ^= 1u; }
#ifdef CODEC_BULK_STAGED_QUERY
        if (++e == E) { e = 0; ++b; }
#endif
      }
    }
#endif
    return;
  }

  // ---- consumers
  const float scale = *scale_ptr;
  const float scale2 = scale * scale;
  const int words = d / 16;
  const int per_warp = 32 / lpr;
  const int sub = lane / lpr;       // row slot inside the warp
  const int sl = lane - sub * lpr;  // lane inside the row group
  const int rows_per_pass = nwarps * per_warp;
  const int rows = E * M0;
  const bool with_sq = form == 0;
  const int id_lane = lpr > 1 ? 1 : 0;
#ifdef CODEC_ROW_SMEM_QUERY
  __shared__ float qs[1024];
#else
  const float* qs = nullptr;
#endif
  int st = 0;
  uint32_t ph = 0;
  codec_row::Query<NCH> qr;
  float next_sn = qsn[b0];
  for (int b = b0; b < b1; ++b) {
    const float sn = next_sn;
    if (b + 1 < b1) next_sn = qsn[b + 1];
#ifndef CODEC_BULK_STAGED_QUERY
    // started before the wait for the query's first stage, which hides it
    codec_row::load_query<NCH>(qr, q + (size_t)b * d, words, lpr, sl, sub);
#endif
#ifdef CODEC_ROW_SMEM_QUERY
    asm volatile("bar.sync 1, %0;\n" ::"r"(nwarps * 32) : "memory");
    for (int k = threadIdx.x; k < d; k += nwarps * 32) qs[k] = q[(size_t)b * d + k];
    asm volatile("bar.sync 1, %0;\n" ::"r"(nwarps * 32) : "memory");
#endif
    float* orow = out + (size_t)b * rows;
    int32_t* oid = out_ids + (size_t)b * rows;
    for (int e = 0; e < E; ++e) {
#ifndef CODEC_ROW_NO_LOAD
      mbar_wait(full_bar + 8 * st, ph);
#endif
      const uint8_t* stage = ring + st * stage_stride;
      const int32_t* idw = reinterpret_cast<const int32_t*>(stage + (size_t)M0 * d);
#ifdef CODEC_BULK_STAGED_QUERY
      if (e == 0)  // the query came with the query's first node
        codec_row::load_query<NCH>(qr, reinterpret_cast<const float*>(stage + copy_bytes),
                                   words, lpr, sl, sub);
#endif
      for (int base = warp * per_warp; base < M0; base += rows_per_pass) {
        const int m = base + sub;
        const bool live = m < M0;
        int4 v[NCH];
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int c = codec_row::word_index<NCH>(i, sl, sub, lpr);
          v[i] = live && c < words
                     ? *reinterpret_cast<const int4*>(stage + (size_t)m * d + c * 16)
                     : make_int4(0, 0, 0, 0);
        }
        int sq = 0;
        float ip = codec_row::row_product<NCH, true>(v, qr, qs, lpr, sl, sub, sq);
        codec_row::group_sum(ip, sq, lpr, with_sq);
        if (live && sl == 0)
          orow[e * M0 + m] = codec_row::finish(form, ip, (float)sq * scale2, sn, scale);
        // the row's id: copied by the lane beside the one that stores the
        // score, so every warp writes its rows' ids as it writes their scores
        if (IDS && live && sl == id_lane) oid[e * M0 + m] = idw[m];
      }
#ifndef CODEC_ROW_NO_LOAD
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * st);
#endif
      if (++st == stages) { st = 0; ph ^= 1u; }
    }
  }
}

#ifdef CODEC_SCORES_PREFETCH
// The no-staging comparison: one block per query, the query in registers,
// every lane starts all of its 16-byte row loads (PF passes at a time)
// before the first product; ids by the strided pass of the "rows" entry.
constexpr int PF = 8;

template <int NCH, bool IDS>
__global__ void codec_scores_prefetch_kernel(
    const int32_t* __restrict__ src, const float* __restrict__ q,
    const float* __restrict__ qsn, const float* __restrict__ scale_ptr,
    const int8_t* __restrict__ blocks, int E, int M0, int d, int form, int lpr,
    size_t block_bytes, float* __restrict__ out, int32_t* __restrict__ out_ids) {
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int words = d / 16, per_warp = 32 / lpr;
  const int sub = lane / lpr, sl = lane - sub * lpr;
  const int rows = E * M0, rows_per_pass = nwarps * per_warp;
  const int32_t* my_src = src + (size_t)b * E;
  const float scale = *scale_ptr, scale2 = scale * scale, sn = qsn[b];
  const bool with_sq = form == 0;
  codec_row::Query<NCH> qr;
  codec_row::load_query<NCH>(qr, q + (size_t)b * d, words, lpr, sl, sub);
  if (IDS) {
    for (int t = threadIdx.x; t < rows; t += blockDim.x) {
      const int e = t / M0, m = t - e * M0;
      out_ids[(size_t)b * rows + t] = reinterpret_cast<const int32_t*>(
          blocks + (size_t)my_src[e] * block_bytes + (size_t)M0 * d)[m];
    }
  }
  for (int base0 = warp * per_warp; base0 < rows; base0 += PF * rows_per_pass) {
    int4 v[PF][NCH];
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int r = base0 + p * rows_per_pass + sub;
      const bool live = r < rows;
      const int e = live ? r / M0 : 0, m = r - e * M0;
      const int8_t* row = blocks + (size_t)my_src[e] * block_bytes + (size_t)m * d;
#pragma unroll
      for (int i = 0; i < NCH; ++i) {
        const int c = codec_row::word_index<NCH>(i, sl, sub, lpr);
        v[p][i] = live && c < words ? __ldg(reinterpret_cast<const int4*>(row) + c)
                                    : make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int p = 0; p < PF; ++p) {
      const int r = base0 + p * rows_per_pass + sub;
      int sq = 0;
      float ip = codec_row::row_product<NCH, true>(v[p], qr, nullptr, lpr, sl, sub, sq);
      codec_row::group_sum(ip, sq, lpr, with_sq);
      if (r < rows && sl == 0)
        out[(size_t)b * rows + r] = codec_row::finish(form, ip, (float)sq * scale2, sn, scale);
    }
  }
}
#endif  // CODEC_SCORES_PREFETCH

RingLayout ring_layout(int stage_bytes) {
  RingLayout r;
  r.stage_stride = (stage_bytes + STAGE_ALIGN - 1) / STAGE_ALIGN * STAGE_ALIGN;
  r.stages = CODEC_RING_SMEM / r.stage_stride;
  if (r.stages > CODEC_RING_MAX_STAGES) r.stages = CODEC_RING_MAX_STAGES;
  if (r.stages < 2) r.stages = 2;
  r.smem = r.stages * (r.stage_stride + 16);
  return r;
}

// What a "bulk" kernel instance was last configured for: the shared-memory
// attribute and the occupancy query are made once per (threads, smem).
struct BulkPlan {
  int threads = 0, smem = -1, device = -1, grid_cap = 0;
};
std::mutex plan_mutex;

template <typename Kernel>
cudaError_t plan_grid(Kernel kernel, BulkPlan& plan, int threads, int smem, int* grid_cap) {
  std::lock_guard<std::mutex> guard(plan_mutex);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return e;
  if (plan.threads != threads || plan.smem != smem || plan.device != device) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorLaunchOutOfResources;
    plan = BulkPlan{threads, smem, device, per_sm * sms};
  }
  *grid_cap = plan.grid_cap;
  return cudaSuccess;
}

template <int NCH, bool IDS>
int launch_bulk(const int32_t* src, const float* q, const float* qsn, const float* scale,
                const int8_t* blocks, int B, int E, int M0, int RID, int d, int form, int lpr,
                float* out, int32_t* out_ids, cudaStream_t s) {
  const size_t block_bytes = (size_t)(M0 + RID) * d;
#ifdef CODEC_SCORES_PREFETCH
  codec_scores_prefetch_kernel<NCH, IDS><<<B, 256, 0, s>>>(
      src, q, qsn, scale, blocks, E, M0, d, form, lpr, block_bytes, out, out_ids);
  return (int)cudaGetLastError();
#else
  // the ids' 4*M0 bytes rounded up to the copy's 16-byte unit: still inside
  // the block, whose id rows hold RID*d >= 4*M0 bytes, a multiple of 16
  const int copy_bytes = M0 * d + (IDS ? (4 * M0 + 15) / 16 * 16 : 0);
  if ((size_t)copy_bytes > block_bytes) return (int)cudaErrorInvalidValue;
#ifdef CODEC_BULK_STAGED_QUERY
  const RingLayout ring = ring_layout(copy_bytes + 4 * d);
#else
  const RingLayout ring = ring_layout(copy_bytes);
#endif
  if (ring.smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
  // consumer warps: the count whose passes over M0 rows leave the fewest idle
  const int threads = (codec_row::pick_warps(M0, 32 / lpr) + 1) * 32;
  static BulkPlan plan;  // one per template instance
  int grid_cap = 0;
  const cudaError_t e = plan_grid(codec_scores_bulk_kernel<NCH, IDS>, plan, threads,
                                  ring.smem, &grid_cap);
  if (e != cudaSuccess) return (int)e;
  const int grid = B < grid_cap ? B : grid_cap;
  codec_scores_bulk_kernel<NCH, IDS><<<grid, threads, ring.smem, s>>>(
      src, q, qsn, scale, blocks, B, E, M0, d, form, lpr, ring.stages, ring.stage_stride,
      (uint32_t)copy_bytes, block_bytes, out, out_ids);
  return (int)cudaGetLastError();
#endif
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// entry: 0 = "rows", 1 = "bulk" (ops/codec_scores.py::CODEC_ENTRIES). An
// entry that does not take the shape returns cudaErrorInvalidValue.
extern "C" int codec_scores_launch(const void* src, const void* q,
                                   const void* qsn, const void* scale,
                                   const void* blocks, int B, int E, int M0,
                                   int RID, int d, int form, int entry,
                                   void* out, void* out_ids, void* stream) {
  if (B == 0 || E == 0 || M0 == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const bool vec16 = (d % 16) == 0;
  if (entry == 1) {
    if (!vec16 || !aligned16(q) || !aligned16(blocks)) return (int)cudaErrorInvalidValue;
    int lpr = 0, nch = 0;
    codec_row::row_geometry(d, 2, &lpr, &nch);
    if (nch > codec_row::MAX_NCH) return (int)cudaErrorInvalidValue;
    const bool ids = RID > 0;
#define BULK(N, I)                                                                     \
  launch_bulk<N, I>((const int32_t*)src, (const float*)q, (const float*)qsn,          \
                    (const float*)scale, (const int8_t*)blocks, B, E, M0, RID, d, form, \
                    lpr, (float*)out, (int32_t*)out_ids, s)
    if (nch == 1) return ids ? BULK(1, true) : BULK(1, false);
    return ids ? BULK(2, true) : BULK(2, false);
#undef BULK
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
    const cudaError_t e = cudaFuncSetAttribute(
        vec16 ? codec_scores_kernel<true> : codec_scores_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (vec16) {
    codec_scores_kernel<true><<<grid, block, smem, s>>>(
        (const int32_t*)src, (const float*)q, (const float*)qsn,
        (const float*)scale, (const int8_t*)blocks, E, M0, RID, d, form, lpr,
        (float*)out, (int32_t*)out_ids);
  } else {
    codec_scores_kernel<false><<<grid, block, smem, s>>>(
        (const int32_t*)src, (const float*)q, (const float*)qsn,
        (const float*)scale, (const int8_t*)blocks, E, M0, RID, d, form, lpr,
        (float*)out, (int32_t*)out_ids);
  }
  return (int)cudaGetLastError();
}
