// The exact scan's shared tile product for Hopper tensor cores (sm_90a).
//
// scan_topk.cu (packed keep-2, kernel B2) and scan_topk_unpacked.cu (unpacked
// keep-2, kernel B5) include this header and differ only in the epilogue
// functor they hand to the kernels below and in their final store.
//
// What a block does. It owns QT = 128 queries x one span of the corpus, with
// two warpgroups of 64 query rows each. A warpgroup multiplies its 64 query
// rows with 128 corpus rows at a time (a sub-tile) by wgmma.mma_async
// m64n128k16 (bf16 in, f32 accumulate, both operands K-major: queries and
// corpus are row-major with d contiguous, so nothing is transposed), d/16
// steps per sub-tile. The instruction's N = 128 is exactly the 128 lane groups
// of the scan: accumulator column c is lane c, so each accumulator element
// belongs to one keep-2 cell of the thread that holds it, and a thread's 64
// cells (2 query rows x 32 lanes) live in its registers for the whole span.
// No candidate leaves the SM until the span is done. Every copy is
// asynchronous (TMA tensor-map loads of [128 rows x 64 columns] bf16 boxes
// with the 128-byte swizzle, one bulk copy for a sub-tile's 128 |x|^2
// floats), is started by one thread, and completes on its stage's "full"
// mbarrier; the warps hand a stage back through its "empty" mbarrier (one
// arrival each).
//
// Two layouts of the same product, chosen by the host from d alone
// (ops/scan_topk.py::scan_layout):
//
//  * resident (scan_tile_kernel; d up to 256 packed, 192 unpacked). The query
//    tile [128 x d] is loaded once and stays in shared memory for the whole
//    span; the corpus streams through a ring of 2-4 stages of [128 rows x d]
//    plus the rows' |x|^2. At d = 128 the epilogue (about 7 CUDA-core
//    instructions per element) is as large as the product, so the two
//    warpgroups take turns on the tensor cores (two named barriers order
//    their wgmma launches): while one reduces sub-tile s into its cells the
//    other multiplies. Past d = 256 two stages no longer fit beside the tile.
//  * K-looped (scan_kloop_kernel; any d). A ring stage holds one 64-column
//    box of the query tile and the same box of the sub-tile's corpus rows,
//    32 KB whatever d is; the warpgroup walks the depth box by box and the
//    epilogue runs once per sub-tile, after the last box. The query boxes are
//    read again for every sub-tile: a block's tile, 128 d 2 bytes (245 KB at
//    d = 960), stays in L2.
//    Each box's product goes into fresh accumulators, and the CUDA cores add
//    it to the sub-tile's sum in f32. The tensor cores' f32 accumulation
//    truncates at every step, so its error grows with the steps chained into
//    one accumulator: chaining a whole sub-tile put B5's values 1.77e-6 (d =
//    784) and 2.13e-6 (d = 960) of their terms from a chain of FMAs, against
//    5.0e-7 at d = 128 (NVIDIA H100 80GB HBM3, 700 W; chip_smoke.py); summed
//    per box, 2.1e-7 and 2.3e-7 of an fp64 evaluation (tools/scan_accuracy.py).
//    The sum takes 64 more registers, so the epilogues keep their second
//    places in shared memory here ([64 cells][256 threads], 64 KB; B5's
//    beside its id words), and read the sub-tile's |x|^2 from L2: the ring
//    then holds 5 stages (B2) or 3 (B5). Each stage goes back as soon as its
//    box's product has completed.
//    The two warpgroups multiply together, not in turns: a turn per sub-tile
//    would need all its boxes in the ring at once (13 stages at d = 784), and
//    past d = 512 the product is 4-8x the epilogue.
//    Measured on the same card (tools/scan_variants.py, B = 2048): the copies
//    alone (no product) take 60-75% of the whole kernel at d = 960 and the time
//    per box follows the boxes in flight, not the bytes: CTAs in pairs
//    sharing each corpus box by TMA multicast (25% fewer bytes from L2), an
//    L2 prefetch of the corpus boxes 8-32 boxes ahead, and one f32 sum per
//    two boxes each measured no faster than this layout.
//
// No producer warp, no setmaxnreg. 64 accumulators and 128 words of cell
// state need about 245 registers a thread with everything else. A block of
// two consumer warpgroups and a producer warpgroup (384 threads, consumers
// raised to 232 or 240 registers by setmaxnreg) compiled with 78 words
// spilled per thread, re-read and re-written every sub-tile through L1, and
// ran 20-30% slower than this layout: 256 threads under __launch_bounds__(256,
// 1) may use 255 registers each and spill nothing. The copies are started by
// thread 0 right after it has started its warpgroup's product, so their cost
// hides in the wait for that product. In the resident layout they run stages
// - 2 sub-tiles ahead, so the stage they refill was left by both warpgroups
// an iteration ago and thread 0 does not wait for it; in the K-looped layout
// stages - 1 boxes ahead.
//
// Depth. d must be a multiple of 16 (one wgmma step): the host gives the bf16
// copies zero columns up to it. A d that is not a multiple of 64 reads its
// last box past the row's end, which the tensor map fills with zeros, and
// skips the wgmma steps of the zero part. A query tile past B is zero-filled
// the same way and never stored.
//
// Accumulator layout of m64n128 (thread t of the warpgroup, warp w = t / 32,
// lane l = t % 32): element 4 j + 2 h + e is query row 16 w + l / 4 + 8 h,
// corpus lane 8 j + 2 (l % 4) + e, for j < 16, h < 2, e < 2.
//
// An Epilogue (a named type: it instantiates a __global__ template) provides
//   static constexpr int kExtraSmem      bytes of shared memory of its own
//   struct Params                        plain data, passed by value
//   init(params, extra_smem, ctid)       ctid: thread 0..255
//   row_setup(q, d, B, row0)             the thread's query rows row0, row0 + 8
//   update(acc[64], xs, loc)             one sub-tile: xs points at the thread's
//                                        first |x|^2 (lane 2 (l % 4)), loc is
//                                        the sub-tile's offset in the span
//   store(params, span, B, row0, l4, row_base)   after the span

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mbarrier.cuh"

namespace scan_tile {

using namespace hopper;  // barriers and the bulk copy

constexpr int QT = 128;       // queries per block (two warpgroups of 64)
constexpr int LANES = 128;    // G: lane groups = corpus rows per sub-tile
constexpr int KBOX = 64;      // columns per TMA box: 128 bytes of bf16
constexpr int CHUNK = LANES * KBOX * 2;  // bytes of one [128 x 64] bf16 box
constexpr int XSQ_BYTES = LANES * 4;
constexpr int THREADS = 256;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;  // bytes a block may use on sm_90

// The K-looped layout's ring (measurement hook for tools/scan_variants.py:
// -DSCAN_KLOOP_MAX_STAGES=n caps it).
#ifndef SCAN_KLOOP_MAX_STAGES
#define SCAN_KLOOP_MAX_STAGES 8
#endif

constexpr int KSTAGE = 2 * CHUNK;  // one K-looped stage: query box, then corpus box
constexpr int KLOOP_MAX_STAGES = SCAN_KLOOP_MAX_STAGES;

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product.
__device__ __forceinline__ void fence_acc(float (&a)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(a[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 128 bytes, 8-row atoms 1024 bytes apart (stride offset),
// leading offset unused by swizzled K-major layouts (1), layout type 1.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// D[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, bf16 in, f32 out.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] = A[64 x 16] * B[128 x 16]^T: the first step of a fresh sum.
// Its accumulators are outputs only, so the compiler may reuse their
// registers until this step (the K-looped layout's sums live elsewhere).
__device__ __forceinline__ void wgmma_m64n128k16_first(float (&d)[64], uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, 0, 1, 1, 0, 0;\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]),
        "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]),
        "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]),
        "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]),
        "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]),
        "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db));
}

// A thread's place in the m64n128 accumulator: its first query row
// (the second is row0 + 8) and lane % 4. Read from the thread index anew at
// every call (volatile), so that a caller after the main loop does not keep
// registers alive through it.
struct Rows {
  int row0, l4;
};
__device__ __forceinline__ Rows my_rows(int q0) {
  unsigned tid;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(tid));
  const int lane = tid % 32;
  return {q0 + (int)(tid / 128) * 64 + 16 * (int)((tid % 128) / 32) + lane / 4, lane % 4};
}

// One sub-tile's product: KS steps of 16 columns; step ks reads box ks / 4,
// 32 bytes further per step inside the swizzled 128-byte row.
template <int KS>
__device__ __forceinline__ void product_steps(float (&a)[64], uint64_t desc_a, uint64_t desc_b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t off = (uint64_t)(((ks >> 2) * CHUNK + (ks & 3) * 32) >> 4);
    wgmma_m64n128k16(a, desc_a + off, desc_b + off, ks != 0);
  }
}

// -------------------------------------------------------------------- kernel

template <class Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
scan_tile_kernel(const __grid_constant__ CUtensorMap map_q,
                 const __grid_constant__ CUtensorMap map_x,
                 const __nv_bfloat16* __restrict__ q, const float* __restrict__ xsq, int B, int d,
                 int tn, int group, int acc, int n_tiles, int stages,
                 typename Epilogue::Params params) {
  extern __shared__ uint8_t smem_raw[];
  // stage bases must sit on 1024 bytes for the 128-byte swizzle
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const int kch = (d + KBOX - 1) / KBOX;  // 64-column boxes per row
  const uint32_t tile_bytes = (uint32_t)kch * CHUNK;
  const uint32_t q_smem = base;
  const uint32_t x_smem = q_smem + tile_bytes;
  const uint32_t xs_off = tile_bytes * (1 + stages);
  const uint32_t extra_off = xs_off + (uint32_t)stages * XSQ_BYTES;
  const uint32_t bar_off = extra_off + Epilogue::kExtraSmem;
  const uint32_t full_bar = base + bar_off;            // [stages]
  const uint32_t empty_bar = full_bar + 8 * MAX_STAGES;  // [stages]
  const uint32_t q_bar = empty_bar + 8 * MAX_STAGES;

  const int q0 = blockIdx.x * QT;
  const int span = blockIdx.y;
  const int tiles_here = min(acc, n_tiles - span * acc);
  const int n_sub = tiles_here * group;  // 128-row sub-tiles of this span
  const size_t row_base = (size_t)span * acc * tn;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);  // one arrival per warp
    }
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform by construction; the shuffle lets the compiler know it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;
  const bool producer = threadIdx.x == 0;

  // Sub-tile j goes to stage j % stages, `ahead` sub-tiles before it is read.
  // ahead = stages - 2 (at least 1): the stage refilled during iteration `it`
  // was read two iterations ago, so the other warpgroup, half an iteration
  // behind, has left it too and the wait in load_next does not stall.
  const int ahead = max(1, stages - 2);
  int pst = 0;       // producer: stage of the next load
  uint32_t pph = 1;  // a fresh stage is empty: the first waits pass
  auto load_next = [&](int j) {
    mbar_wait(empty_bar + 8 * pst, pph);
    const uint32_t fb = full_bar + 8 * pst;
    mbar_expect_tx(fb, tile_bytes + XSQ_BYTES);
    const size_t row = row_base + (size_t)j * LANES;
    for (int c = 0; c < kch; ++c)
      tma_load_2d(x_smem + pst * tile_bytes + c * CHUNK, &map_x, fb, c * KBOX, (int)row);
    bulk_load(base + xs_off + pst * XSQ_BYTES, xsq + row, XSQ_BYTES, fb);
    if (++pst == stages) { pst = 0; pph ^= 1; }
  };
  if (producer) {
    mbar_expect_tx(q_bar, tile_bytes);
    for (int c = 0; c < kch; ++c) tma_load_2d(q_smem + c * CHUNK, &map_q, q_bar, c * KBOX, q0);
    for (int j = 0; j < min(ahead, n_sub); ++j) load_next(j);
  }

  Epilogue epi;
  epi.init(params, base_ptr + extra_off, (int)threadIdx.x);
  epi.row_setup(q, d, B, my_rows(q0).row0);
  // this thread's first |x|^2 of stage 0: lanes 8 j + 2 (lane % 4) + {0, 1}
  const float* xs0 = reinterpret_cast<const float*>(base_ptr + xs_off) + 2 * (lane % 4);

  const int ksteps = d / 16;
  const uint64_t desc_a = make_desc(q_smem + wg * (64 * 128));
  float a[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) a[i] = 0.f;
  // the other warpgroup starts: this one hands it the first turn
  if (wg == 1) named_arrive(1, 256);
  mbar_wait(q_bar, 0);
  int st = 0;
  uint32_t ph = 0;
  // Measurement hooks (tools/scan_variants.py builds with them, the package
  // never): SCAN_TILE_TIMING sums the cycles of each phase of the loop in one
  // thread per warpgroup of block (0, 0) and writes them over the head of the
  // first output; SCAN_TILE_NO_PRODUCT / SCAN_TILE_NO_EPILOGUE leave out one
  // half of the work (wrong results) to time the other.
#ifdef SCAN_TILE_TIMING
  long long tf = 0, ts = 0, tm = 0, te = 0, tp = 0, c0, c1;
  const long long tstart = clock64();
#define TICK(acc_) c1 = clock64(); acc_ += c1 - c0; c0 = c1;
#else
#define TICK(acc_)
#endif
  for (int it = 0; it < n_sub; ++it) {
#ifdef SCAN_TILE_TIMING
    c0 = clock64();
#endif
    mbar_wait(full_bar + 8 * st, ph);
    TICK(tf)
    const uint64_t desc_b = make_desc(x_smem + st * tile_bytes);
    named_sync(1 + wg, 256);  // my turn on the tensor cores
    TICK(ts)
    fence_acc(a);
    wgmma_fence();
#ifndef SCAN_TILE_NO_PRODUCT
    if (ksteps == 8) {  // d = 128, unrolled: one uninterrupted chain
      product_steps<8>(a, desc_a, desc_b);
    } else if (ksteps == 4) {
      product_steps<4>(a, desc_a, desc_b);
    } else {
      for (int ks = 0; ks < ksteps; ++ks) {
        const uint64_t off = (uint64_t)(((ks >> 2) * CHUNK + (ks & 3) * 32) >> 4);
        wgmma_m64n128k16(a, desc_a + off, desc_b + off, ks != 0);
      }
    }
#endif
    wgmma_commit();
    // the copies are started while the product runs: their cost (waiting for
    // the stage, three copy instructions) hides under the wait below
    if (producer && it + ahead < n_sub) load_next(it + ahead);
    __syncwarp();
    TICK(tp)
    named_arrive(2 - wg, 256);  // the other warpgroup may start its product
    wgmma_wait0();
    fence_acc(a);
    TICK(tm)
#ifdef SCAN_TILE_NO_EPILOGUE
    if (it == n_sub - 1)
#endif
    epi.update(a, xs0 + st * LANES, it);
    __syncwarp();
    TICK(te)
    if (lane == 0) mbar_arrive(empty_bar + 8 * st);
    if (++st == stages) { st = 0; ph ^= 1; }
  }
  // take the turn the other warpgroup handed over last, so that no arrival
  // is left pending when the block ends
  if (wg == 0) named_sync(1, 256);
  const Rows r = my_rows(blockIdx.x * QT);
  epi.store(params, (int)blockIdx.y, B, r.row0, r.l4, (size_t)blockIdx.y * acc * tn);
#ifdef SCAN_TILE_TIMING
  if (blockIdx.x == 0 && blockIdx.y == 0 && (threadIdx.x % 128) == 0) {
    int* o = *(int**)&params + (threadIdx.x / 128) * 8;
    o[0] = (int)tp; o[1] = (int)tf; o[2] = (int)ts; o[3] = (int)tm; o[4] = (int)te;
    o[5] = (int)(clock64() - tstart); o[6] = n_sub;
  }
#endif
}

// ------------------------------------------------------- the K-looped kernel

// One 64-column box's product into fresh accumulators: `steps` steps of 16
// columns, 32 bytes further per step inside the swizzled 128-byte row.
__device__ __forceinline__ void box_product(float (&a)[64], uint64_t desc_a, uint64_t desc_b,
                                            int steps) {
  wgmma_m64n128k16_first(a, desc_a, desc_b);
  if (steps == 4) {
#pragma unroll
    for (int ks = 1; ks < 4; ++ks) wgmma_m64n128k16(a, desc_a + 2 * ks, desc_b + 2 * ks, 1);
  } else {
    for (int ks = 1; ks < steps; ++ks) wgmma_m64n128k16(a, desc_a + 2 * ks, desc_b + 2 * ks, 1);
  }
}

template <class Epilogue>
__global__ void __launch_bounds__(THREADS, 1)
scan_kloop_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_x,
                  const __nv_bfloat16* __restrict__ q, const float* __restrict__ xsq, int B,
                  int d, int tn, int group, int acc, int n_tiles, int stages,
                  typename Epilogue::Params params) {
  extern __shared__ uint8_t smem_raw[];
  // stage bases must sit on 1024 bytes for the 128-byte swizzle
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const int kch = (d + KBOX - 1) / KBOX;                // boxes per sub-tile
  const int last_steps = (d - (kch - 1) * KBOX) / 16;  // wgmma steps of the last box
  const uint32_t extra_off = (uint32_t)stages * KSTAGE;
  const uint32_t full_bar = base + extra_off + Epilogue::kExtraSmem;  // [stages]
  const uint32_t empty_bar = full_bar + 8 * KLOOP_MAX_STAGES;        // [stages]

  const int q0 = blockIdx.x * QT;
  const int span = blockIdx.y;
  const int tiles_here = min(acc, n_tiles - span * acc);
  const int n_sub = tiles_here * group;  // 128-row sub-tiles of this span
  const int n_box = n_sub * kch;
  const size_t row_base = (size_t)span * acc * tn;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  // warp-uniform by construction; the shuffle lets the compiler know it
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;
  const bool producer = threadIdx.x == 0;

  // Box j (column box j % kch of sub-tile j / kch) goes to stage j % stages,
  // stages - 1 boxes before it is read. Thread 0 refills a stage once it has
  // started the product of box j: the stage of box j + stages - 1 held box
  // j - 1, which its own warp has handed back; the other warpgroup may be up
  // to a box behind.
  int pj = 0;  // producer: boxes started (its other state follows from pj, to spare registers)
  auto load_next = [&]() {
    const int sub = pj / kch, c = pj - sub * kch, lap = pj / stages, pst = pj - lap * stages;
    // a fresh stage is empty: the first lap's waits (parity 1) pass
    mbar_wait(empty_bar + 8 * pst, (lap & 1) ^ 1);
    const uint32_t fb = full_bar + 8 * pst;
    mbar_expect_tx(fb, KSTAGE);
    const uint32_t sb = base + pst * KSTAGE;
    tma_load_2d(sb, &map_q, fb, c * KBOX, q0);
    tma_load_2d(sb + CHUNK, &map_x, fb, c * KBOX, (int)(row_base + (size_t)sub * LANES));
    ++pj;
  };
  if (producer)
    for (int j = 0; j < min(stages - 1, n_box); ++j) load_next();

  Epilogue epi;
  epi.init(params, base_ptr + extra_off, (int)threadIdx.x);
  epi.row_setup(q, d, B, my_rows(q0).row0);
  // this thread's first |x|^2 of the span, read from device memory (L2) by the
  // epilogue: lanes 8 j + 2 (lane % 4) + {0, 1} of each sub-tile
  const float* xs0 = xsq + row_base + 2 * (lane % 4);

  // a: one box's product, fresh for each box; t: the sub-tile's f32 sum of them
  float a[64], t[64];
  int st = 0;
  uint32_t ph = 0;
  for (int it = 0; it < n_sub; ++it) {
    for (int c = 0; c < kch; ++c) {
      mbar_wait(full_bar + 8 * st, ph);
      const uint32_t sb = base + st * KSTAGE;
      wgmma_fence();
#ifndef SCAN_TILE_NO_PRODUCT
      box_product(a, make_desc(sb + wg * (64 * 128)), make_desc(sb + CHUNK),
                  c < kch - 1 ? 4 : last_steps);
#endif
      wgmma_commit();
      // the copies start while the product runs
      if (producer && pj < n_box) load_next();
      __syncwarp();
      wgmma_wait0();
      fence_acc(a);
      // the stage is read: hand it back
      if (lane == 0) mbar_arrive(empty_bar + 8 * st);
      if (++st == stages) { st = 0; ph ^= 1; }
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) t[i] = a[i];
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) t[i] += a[i];
      }
    }
#ifdef SCAN_TILE_NO_EPILOGUE
    if (it == n_sub - 1)
#endif
    epi.update(t, xs0 + (size_t)it * LANES, it);
  }
  const Rows r = my_rows(blockIdx.x * QT);
  epi.store(params, (int)blockIdx.y, B, r.row0, r.l4, (size_t)blockIdx.y * acc * tn);
}

// ---------------------------------------------------------------- host side

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime (no -lcuda at link time).
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &res) == cudaSuccess &&
        res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A [rows x d] row-major bf16 matrix cut into boxes of 128 rows x 64 columns
// with the 128-byte swizzle; reads past either edge give zeros.
inline int make_map(CUtensorMap* m, const void* ptr, int rows, int d) {
  EncodeTiledFn enc = encode_tiled_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * 2};
  const cuuint32_t box[2] = {KBOX, LANES};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Stages that fit beside the query tile and the epilogue's own bytes.
template <class Epilogue>
inline int pick_stages(int d, size_t* smem_bytes) {
  const int kch = (d + KBOX - 1) / KBOX;
  const size_t tile = (size_t)kch * CHUNK;
  const size_t fixed = 1024 + tile + Epilogue::kExtraSmem + 8 * (2 * MAX_STAGES + 1);
  int stages = MAX_STAGES;
  while (stages >= 2 && fixed + stages * (tile + XSQ_BYTES) > (size_t)SMEM_LIMIT) --stages;
  *smem_bytes = fixed + stages * (tile + XSQ_BYTES);
  return stages;
}

// Stages of the K-looped ring that fit beside the epilogue's own bytes.
template <class Epilogue>
inline int pick_kloop_stages(size_t* smem_bytes) {
  const size_t fixed = 1024 + Epilogue::kExtraSmem + 8 * 2 * KLOOP_MAX_STAGES;
  int stages = KLOOP_MAX_STAGES;
  while (stages >= 2 && fixed + stages * (size_t)KSTAGE > (size_t)SMEM_LIMIT) --stages;
  *smem_bytes = fixed + stages * (size_t)KSTAGE;
  return stages;
}

// Launch the tensor-core scan in `layout` 0 (resident, with Epilogue) or 1
// (K-looped, with KloopEpilogue, which takes the same Params). q [B, d] and X
// [Np, d] bf16 row-major.
template <class Epilogue, class KloopEpilogue>
inline int launch(const void* q, const void* X, const void* xsq, int B, int Np, int d, int tn,
                  int group, int acc, int layout, typename Epilogue::Params params,
                  cudaStream_t s) {
  if (d % 16 != 0 || d <= 0 || (layout != 0 && layout != 1)) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int stages =
      layout ? pick_kloop_stages<KloopEpilogue>(&smem) : pick_stages<Epilogue>(d, &smem);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mx;
  int rc = make_map(&mq, q, B, d);
  if (rc) return rc;
  rc = make_map(&mx, X, Np, d);
  if (rc) return rc;
  auto kernel = scan_tile_kernel<Epilogue>;
  if (layout) kernel = scan_kloop_kernel<KloopEpilogue>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = Np / tn;
  const int spans = (n_tiles + acc - 1) / acc;
  const dim3 grid((B + QT - 1) / QT, spans), block(THREADS);
  kernel<<<grid, block, smem, s>>>(mq, mx, (const __nv_bfloat16*)q, (const float*)xsq, B, d, tn,
                                   group, acc, n_tiles, stages, params);
  return (int)cudaGetLastError();
}

}  // namespace scan_tile
