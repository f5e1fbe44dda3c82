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
//  * K-looped over f32 rows (scan_kloop_kernel<.., float>, entry "tf32x3",
//    any d up to the host's WGMMA_MAX_D): the full-precision scan. A box is
//    32 f32 columns (128 bytes, the same 16 KB and swizzle); it is split in
//    shared memory into tf32 parts, x = hi + lo, and q.x is summed from three
//    tf32 products a box, wgmma m64n128k8 (see the kernel). TF32 keeps 10
//    mantissa bits; the three products keep about 22, within a few f32
//    roundings of an f32 product, at three passes of the tensor cores' TF32
//    rate (495 TFLOP/s) against one of the CUDA cores' f32 FMA rate (67).
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
// Depth. bf16: d must be a multiple of 16 (one wgmma step): the host gives
// the bf16 copies zero columns up to it. f32: a multiple of 4, the tensor
// map's 16-byte row stride (the f32 rows themselves, no copy, at every d the
// paths run); a last step past d reads the map's zero fill. A d that is not a
// multiple of the box reads its last box past the row's end, which the tensor
// map fills with zeros; bf16 skips the wgmma steps of the zero part, f32 runs
// them (box_product_3x). A query tile past B is zero-filled the same way and
// never stored.
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
//                                        (q bf16 or f32: a template)
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

// The 64 accumulators of an m64n128 product as inline-asm operands %0-%63:
// SCAN_ACC64(SCAN_RW) reads and writes them, SCAN_ACC64(SCAN_WO) only writes.
#define SCAN_RW(x) "+f"(x)
#define SCAN_WO(x) "=f"(x)
#define SCAN_ACC64(C)                                                                        \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]), C(d[8]), C(d[9]),   \
      C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]), C(d[15]), C(d[16]), C(d[17]),         \
      C(d[18]), C(d[19]), C(d[20]), C(d[21]), C(d[22]), C(d[23]), C(d[24]), C(d[25]),         \
      C(d[26]), C(d[27]), C(d[28]), C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]),         \
      C(d[34]), C(d[35]), C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]),         \
      C(d[42]), C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]),         \
      C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]), C(d[57]),         \
      C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])
#define SCAN_ACC_LIST                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "

// D[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, bf16 in, f32 out.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SCAN_ACC_LIST
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : SCAN_ACC64(SCAN_RW)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] = A[64 x 16] * B[128 x 16]^T: the first step of a fresh sum.
// Its accumulators are outputs only, so the compiler may reuse their
// registers until this step (the K-looped layout's sums live elsewhere).
__device__ __forceinline__ void wgmma_m64n128k16_first(float (&d)[64], uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " SCAN_ACC_LIST
      "%64, %65, 0, 1, 1, 0, 0;\n"
      : SCAN_ACC64(SCAN_WO)
      : "l"(da), "l"(db));
}

// D[64 x 128] += A[64 x 8] * B[128 x 8]^T, tf32 in (the 32-bit words' top
// 19 bits), f32 out. tf32 takes K-major operands only: no transpose flags.
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SCAN_ACC_LIST
      "%64, %65, p, 1, 1;\n}\n"
      : SCAN_ACC64(SCAN_RW)
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] = A[64 x 8] * B[128 x 8]^T: the first step of a fresh tf32 sum.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_first(float (&d)[64], uint64_t da,
                                                           uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " SCAN_ACC_LIST
      "%64, %65, 0, 1, 1;\n"
      : SCAN_ACC64(SCAN_WO)
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

// One bf16 box's product into fresh accumulators: `steps` steps of 16
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

// One f32 box's q.x into fresh accumulators from its tf32 parts, q = qh + ql
// and x = xh + xl: the two small products first (ql xh, then qh xl), the
// large one qh xh last, so that the corrections are summed at their own
// scale before the large terms join; ql xl (below 2^-20 of q x) is left out.
// Always the box's four steps of 8 columns: past d the tensor map's zero fill
// adds nothing, and a branch on the step count made ptxas serialize every
// wgmma of the kernel (warning C7520, "compiler-inserted WG.AR in divergent
// path": the products took 41 ms alone at 1M x 960, tools/scan_variants.py).
__device__ __forceinline__ void box_product_3x(float (&a)[64], uint64_t qh, uint64_t ql,
                                               uint64_t xh, uint64_t xl) {
  wgmma_m64n128k8_tf32_first(a, ql, xh);
#pragma unroll
  for (int ks = 1; ks < 4; ++ks) wgmma_m64n128k8_tf32(a, ql + 2 * ks, xh + 2 * ks, 1);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_m64n128k8_tf32(a, qh + 2 * ks, xl + 2 * ks, 1);
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) wgmma_m64n128k8_tf32(a, qh + 2 * ks, xh + 2 * ks, 1);
}

// The split of an f32 box into tf32 parts, x = hi + lo. The tensor cores read
// an f32 word's top 19 bits and ignore its low 13 (checked on the card: the
// kernel built so agrees with its plain version within the f32 tolerances of
// chip_smoke.py), so the box as loaded is hi = x truncated to tf32, and only
// lo is written: x - hi, exact in f32, rounded to tf32 (cvt.rna: read
// truncated it would lean toward zero, which the tests' model of the sum puts
// at 1.5x the error). lo goes to the same offset of the lo area, which has
// the box's 1024-byte-aligned swizzled layout: an element's place is the same
// in both. Writing a rounded hi over the box as well measured 13% slower.
__device__ __forceinline__ void split_one(const uint8_t* box, uint8_t* lo, int i) {
  const float4 v = reinterpret_cast<const float4*>(box)[i];
  float r[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float rest = r[e] - __uint_as_float(__float_as_uint(r[e]) & 0xFFFFE000u);
    uint32_t t;
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(t) : "f"(rest));
    r[e] = __uint_as_float(t);
  }
  reinterpret_cast<float4*>(lo)[i] = make_float4(r[0], r[1], r[2], r[3]);
}

// Four float4 of a box a thread, from `first`, `stride` apart.
__device__ __forceinline__ void split_f4(const uint8_t* box, uint8_t* lo, int first,
                                         int stride) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_one(box, lo, first + i * stride);
}

// Makes this thread's shared-memory writes visible to the tensor cores'
// (asynchronous-proxy) reads; a barrier then orders them for all threads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The K-looped layout over bf16 (T = __nv_bfloat16, entry "wgmma") or f32
// (T = float, entry "tf32x3") rows. A box is 128 bytes of a row: 64 bf16 or
// 32 f32 columns; one wgmma step reads 32 bytes of it (k16 bf16, k8 tf32).
//
// f32: each box is split in shared memory after its TMA load, x = hi + lo
// (split_f4): the box itself is hi, lo goes to a 32 KB area beside the ring
// ([query lo][corpus lo]). A warpgroup splits its own 64 query rows; the 128
// corpus rows are split by all 256 threads. Then q.x = qh xh + qh xl + ql xh
// (box_product_3x), within a few f32 roundings of the f32 product. The
// corpus is read once from device memory as f32 (no stored lo copy: that
// would double the bytes every query tile reads through L2), and the queries
// are split per box like the corpus, since their tile is read again for
// every sub-tile anyway. Two 256-thread barriers a box: after the split
// (every part written before either warpgroup's product reads it), and after
// both products (the lo area is free for the next box). A stage holds one
// query box and one corpus box (32 KB) in both types; beside the lo area the
// ring holds 4 stages (B2) or 2 (B5) in f32, against 5 and 3 in bf16. (A
// second lo area, so that box j + 1 is split while box j's products run,
// left B2 three stages and measured no faster: tools/scan_variants.py shows
// the split, the products and the copies adding up either way.)
template <class Epilogue, typename T>
__global__ void __launch_bounds__(THREADS, 1)
scan_kloop_kernel(const __grid_constant__ CUtensorMap map_q,
                  const __grid_constant__ CUtensorMap map_x,
                  const T* __restrict__ q, const float* __restrict__ xsq, int B,
                  int d, int tn, int group, int acc, int n_tiles, int stages,
                  typename Epilogue::Params params) {
  constexpr int kBox = 128 / (int)sizeof(T);  // columns of a box
  constexpr bool kSplit = sizeof(T) == 4;     // f32: three tf32 products a box
  extern __shared__ uint8_t smem_raw[];
  // stage bases must sit on 1024 bytes for the 128-byte swizzle
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* base_ptr = smem_raw + (base - smem_u32(smem_raw));
  const int kch = (d + kBox - 1) / kBox;                // boxes per sub-tile
  const int last_steps = (d - (kch - 1) * KBOX) / 16;  // bf16: wgmma steps of the last box
  const uint32_t lo_off = (uint32_t)stages * KSTAGE;  // f32: the split's lo area
  const uint32_t extra_off = lo_off + (kSplit ? KSTAGE : 0);
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
#ifdef SCAN_TILE_NO_COPY  // measurement hook: the stage completes empty, nothing copied
    mbar_arrive(fb);
#else
    mbar_expect_tx(fb, KSTAGE);
    const uint32_t sb = base + pst * KSTAGE;
    tma_load_2d(sb, &map_q, fb, c * kBox, q0);
    tma_load_2d(sb + CHUNK, &map_x, fb, c * kBox, (int)(row_base + (size_t)sub * LANES));
#endif
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
      if constexpr (kSplit) {
#ifndef SCAN_TILE_NO_SPLIT
        const uint8_t* stage = base_ptr + st * KSTAGE;
        uint8_t* lo = base_ptr + lo_off;
        split_f4(stage + wg * (64 * 128), lo + wg * (64 * 128), (int)threadIdx.x % 128, 128);
        split_f4(stage + CHUNK, lo + CHUNK, (int)threadIdx.x, 256);
        fence_proxy_async();
#endif
        named_sync(1, 256);  // the box is split: either warpgroup may read it
      }
      wgmma_fence();
#ifndef SCAN_TILE_NO_PRODUCT
      if constexpr (kSplit) {
        const uint32_t lo = base + lo_off;
        const uint64_t qh = make_desc(sb + wg * (64 * 128)),
                       ql = make_desc(lo + wg * (64 * 128)), xh = make_desc(sb + CHUNK),
                       xl = make_desc(lo + CHUNK);
        box_product_3x(a, qh, ql, xh, xl);
      } else {
        box_product(a, make_desc(sb + wg * (64 * 128)), make_desc(sb + CHUNK),
                    c < kch - 1 ? 4 : last_steps);
      }
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
      // both warpgroups' products have read the lo area: the next split may write it
      if constexpr (kSplit) named_sync(2, 256);
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

// A [rows x d] row-major bf16 (or, with f32, f32) matrix cut into boxes of
// 128 rows x 128 bytes (64 bf16 or 32 f32 columns) with the 128-byte swizzle;
// reads past either edge give zeros. The row stride must be a multiple of 16
// bytes.
inline int make_map(CUtensorMap* m, const void* ptr, int rows, int d, bool f32) {
  EncodeTiledFn enc = encode_tiled_fn();
  if (!enc) return (int)cudaErrorNotSupported;
  const cuuint64_t esize = f32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)d, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)d * esize};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / esize), LANES};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = enc(m, f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                         2, const_cast<void*>(ptr), dims, strides, box, estr,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// Stages that fit beside the query tile and the epilogue's own bytes.
// (ops/scan_topk.py::scan_smem mirrors this and pick_kloop_stages.)
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

// Stages of the K-looped ring that fit beside the epilogue's own bytes and,
// for f32 (`split`), the split's lo area.
template <class Epilogue>
inline int pick_kloop_stages(bool split, size_t* smem_bytes) {
  const size_t fixed =
      1024 + (split ? KSTAGE : 0) + Epilogue::kExtraSmem + 8 * 2 * KLOOP_MAX_STAGES;
  int stages = KLOOP_MAX_STAGES;
  while (stages >= 2 && fixed + stages * (size_t)KSTAGE > (size_t)SMEM_LIMIT) --stages;
  *smem_bytes = fixed + stages * (size_t)KSTAGE;
  return stages;
}

template <class Kernel, typename T, class Params>
inline int start(Kernel kernel, size_t smem, dim3 grid, cudaStream_t s, const CUtensorMap& mq,
                 const CUtensorMap& mx, const T* q, const float* xsq, int B, int d, int tn,
                 int group, int acc, int n_tiles, int stages, Params params) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, THREADS, smem, s>>>(mq, mx, q, xsq, B, d, tn, group, acc, n_tiles, stages,
                                     params);
  return (int)cudaGetLastError();
}

// Launch the tensor-core scan: bf16 rows in `layout` 0 (resident, with
// Epilogue) or 1 (K-looped, with KloopEpilogue, which takes the same Params);
// f32 rows (`f32`, entry "tf32x3") in the K-looped layout only. q [B, d] and
// X [Np, d] row-major; d a multiple of 16 for bf16 (one wgmma step), of 4 for
// f32 (the tensor map's 16-byte row stride: a last step past d reads the
// map's zero fill).
template <class Epilogue, class KloopEpilogue>
inline int launch(const void* q, const void* X, const void* xsq, int B, int Np, int d, int tn,
                  int group, int acc, int layout, bool f32, typename Epilogue::Params params,
                  cudaStream_t s) {
  if (d <= 0 || d % (f32 ? 4 : 16) != 0 || (layout != 0 && layout != 1) || (f32 && layout != 1))
    return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  const int stages =
      layout ? pick_kloop_stages<KloopEpilogue>(f32, &smem) : pick_stages<Epilogue>(d, &smem);
  if (stages < 2) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mx;
  int rc = make_map(&mq, q, B, d, f32);
  if (rc) return rc;
  rc = make_map(&mx, X, Np, d, f32);
  if (rc) return rc;
  const int n_tiles = Np / tn;
  const int spans = (n_tiles + acc - 1) / acc;
  const dim3 grid((B + QT - 1) / QT, spans);
  const float* xs = (const float*)xsq;
  if (f32)
    return start(scan_kloop_kernel<KloopEpilogue, float>, smem, grid, s, mq, mx, (const float*)q,
                 xs, B, d, tn, group, acc, n_tiles, stages, params);
  const __nv_bfloat16* qb = (const __nv_bfloat16*)q;
  if (layout)
    return start(scan_kloop_kernel<KloopEpilogue, __nv_bfloat16>, smem, grid, s, mq, mx, qb, xs, B,
                 d, tn, group, acc, n_tiles, stages, params);
  return start(scan_tile_kernel<Epilogue>, smem, grid, s, mq, mx, qb, xs, B, d, tn, group, acc,
               n_tiles, stages, params);
}

}  // namespace scan_tile
