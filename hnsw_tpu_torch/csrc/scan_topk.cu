// Exact L2 scan with packed keep-2 per lane group (kernel B2).
//
// Replaces hnsw_tpu/ops/pallas_topk.py::_tile_kernel_packed. The corpus X
// [Np, d] (Np a multiple of tn, padding rows carry a huge |x|^2) is cut into
// tiles of tn = 128 * group rows; tile row s * 128 + lane belongs to lane
// group `lane` (G = 128 lanes). `acc` consecutive tiles form one span, and for
// each (span, query, lane) the kernel keeps the two smallest of
//   d2 = max(|x|^2 + |q|^2 - 2 q.x, 0)
// with the candidate's local offset loc = tile_in_span * group + s OR-ed into
// the low LB mantissa bits (index-in-mantissa packing: int32 order equals
// float order for d2 >= 0, so a plain int min carries the identity along).
// Output: packed int32 [spans, B, 2G] (min1 lanes, then min2 lanes), decoded by
// the caller exactly as the JAX package decodes its kernel's output. Two
// candidates of a cell never pack to the same int (their loc differ), so no
// tie rule is needed.
//
// Bound on the H100: operations. 2*B*N*d flops (105 GFLOP at B=2048,
// N=200704, d=128) against 51 MB of bf16 corpus: ~0.11 ms at the bf16
// tensor-core peak; the keep-2 update (7 CUDA-core instructions per element:
// add, fma, max, and-or, max, min, min) is bounded by the instruction rate at
// about the same time. The epilogue's cost does not grow with d, the
// product's does: at d = 784 (B=2048, N=71680: 230 GFLOP, 0.233 ms) and d =
// 960 (N=1001472, 1M rows padded: 3.94 TFLOP, 3.98 ms) the product alone sets
// the bound.
//
// Three entries; the wrapper chooses from dtype and d (never as a fallback)
// between the first two:
//
//  * entry 1, "wgmma": bf16 inputs (the host pads d to a multiple of 16).
//    The tile product of scan_tile.cuh (TMA ring, wgmma m64n128k16) in the
//    layout the wrapper names: `layout` 0 keeps the query tile resident and
//    the two warpgroups take turns (d <= 256), 1 walks the depth in 64-column
//    boxes (any d). Its epilogue below: a thread keeps the packed pair
//    (m1, m2) of its 64 cells in 128 registers (the K-looped layout: m2 in
//    shared memory) and updates them without a branch, m2 = min(m2, max(m1,
//    p)); m1 = min(m1, p). Sums are f32 sums of exact bf16 products in the
//    tensor core's order (the K-looped layout: per 64-column box, the boxes
//    added in f32), not a chain of FMAs.
//  * entry 2, "tf32x3": f32 inputs (the scan's full-precision contract) at
//    any d up to the host's WGMMA_MAX_D (d a multiple of 4). The K-looped
//    layout of scan_tile.cuh over f32 rows: each 32-column box split into
//    tf32 parts in shared memory, q.x from three tf32 products a box summed
//    in f32, the same epilogue. Bound on the H100: the three products, 3 *
//    2 B N d flops at the TF32 rate (495 TFLOP/s), 2.5x under one pass of f32
//    FMAs (67 TFLOP/s): 23.87 ms at (B=2048, 1M x 960).
//  * entry 0, "simt": the first f32-FMA kernel, which the wrapper no longer
//    names: chip_smoke.py times it as the tensor-core entries' "was" where
//    its shared memory fits (d <= 842 here). A classic register-tiled layout:
//    a block owns 64 queries x one span; each of its 256 threads holds a
//    4-query x 8-lane accumulator tile and the keep-2 state of those 32
//    cells in registers; the queries sit transposed in shared memory
//    ([d][64] f32: past d = 842 they do not fit), corpus rows stream through
//    a [32 x 129] f32 staging tile. It takes f32 or bf16 inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

constexpr int QT = 64;   // queries per block
constexpr int LANES = 128;  // G: lane groups per tile row block
constexpr int KC = 32;   // depth of one staging chunk
constexpr int XS_LD = LANES + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(256)
scan_topk_kernel(const T* __restrict__ q, const T* __restrict__ X,
                 const float* __restrict__ xsq, int B, int d, int tn,
                 int group, int acc, int n_tiles, int LB,
                 int32_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [d][QT]
  float* Xs = Qs + (size_t)d * QT;     // [KC][XS_LD]
  float* qsq = Xs + KC * XS_LD;        // [QT]

  const int tid = threadIdx.x;
  const int tx = tid & 15;   // lane slot: lanes tx + 16 j
  const int ty = tid >> 4;   // query slot: queries ty + 16 i
  const int q0 = blockIdx.x * QT;
  const int span = blockIdx.y;

  for (int idx = tid; idx < QT * d; idx += blockDim.x) {
    const int qi = idx / d, k = idx - qi * d;
    const int qg = q0 + qi;
    Qs[(size_t)k * QT + qi] = qg < B ? to_f(q[(size_t)qg * d + k]) : 0.f;
  }
  __syncthreads();
  if (tid < QT) {
    float s = 0.f;
    for (int k = 0; k < d; ++k) {
      const float v = Qs[(size_t)k * QT + tid];
      s += v * v;
    }
    qsq[tid] = s;
  }

  int32_t m1[4][8], m2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) { m1[i][j] = 0x7FFFFFFF; m2[i][j] = 0x7FFFFFFF; }
  const int32_t hi_mask = ~((1 << LB) - 1);

  for (int t = 0; t < acc; ++t) {
    const int tile = span * acc + t;
    if (tile >= n_tiles) break;
    for (int s = 0; s < group; ++s) {
      const size_t row0 = (size_t)tile * tn + (size_t)s * LANES;
      float a[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) a[i][j] = 0.f;
      for (int k0 = 0; k0 < d; k0 += KC) {
        const int kc = min(KC, d - k0);
        __syncthreads();
        for (int idx = tid; idx < LANES * KC; idx += blockDim.x) {
          const int r = idx / KC, kk = idx - r * KC;
          Xs[kk * XS_LD + r] = kk < kc ? to_f(X[(row0 + r) * d + k0 + kk]) : 0.f;
        }
        __syncthreads();
        for (int kk = 0; kk < kc; ++kk) {
          float qa[4], xb[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) qa[i] = Qs[(size_t)(k0 + kk) * QT + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < 8; ++j) xb[j] = Xs[kk * XS_LD + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) a[i][j] += qa[i] * xb[j];
        }
      }
      const int32_t loc = t * group + s;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xs = xsq[row0 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = fmaxf(xs + qsq[ty + 16 * i] - 2.0f * a[i][j], 0.0f);
          const int32_t p = (__float_as_int(v) & hi_mask) | loc;
          if (p < m1[i][j]) { m2[i][j] = m1[i][j]; m1[i][j] = p; }
          else if (p < m2[i][j]) { m2[i][j] = p; }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty + 16 * i;
    if (qg >= B) continue;
    int32_t* o = out + ((size_t)span * B + qg) * (2 * LANES);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[tx + 16 * j] = m1[i][j];
      o[LANES + tx + 16 * j] = m2[i][j];
    }
  }
}

template <typename T>
int launch(const void* q, const void* X, const void* xsq, int B, int Np, int d,
           int tn, int group, int acc, int LB, void* out, cudaStream_t s) {
  const int n_tiles = Np / tn;
  const int spans = (n_tiles + acc - 1) / acc;
  const dim3 grid((B + QT - 1) / QT, spans), block(256);
  const size_t smem = ((size_t)d * QT + KC * XS_LD + QT) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_topk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scan_topk_kernel<T><<<grid, block, smem, s>>>(
      (const T*)q, (const T*)X, (const float*)xsq, B, d, tn, group, acc,
      n_tiles, LB, (int32_t*)out);
  return (int)cudaGetLastError();
}
}  // namespace

struct PackedParams {
  int32_t* out;
  int32_t hi_mask;
};

// Epilogue of the tensor-core entry: packed keep-2, a thread's 64 first
// places in registers. With kSharedM2 (the K-looped layout, whose per-box
// products take 64 more registers) the second places live in shared memory,
// [64 cells][256 threads] so that no two threads of a warp share a bank,
// read for every candidate and written only where it enters second place.
// (A named type: it instantiates a __global__ template.)
template <bool kSharedM2>
struct PackedEpilogueT {
  static constexpr int kExtraSmem = kSharedM2 ? 64 * 256 * 4 : 0;
  using Params = PackedParams;
  int32_t m1[64];
  int32_t m2r[kSharedM2 ? 1 : 64];
  int32_t* m2s;  // this thread's column of second places (kSharedM2)
  float qs0, qs1;
  int32_t hi_mask;

  __device__ __forceinline__ void init(const Params& p, uint8_t* extra, int ctid) {
    if constexpr (kSharedM2) m2s = reinterpret_cast<int32_t*>(extra) + ctid;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      m1[i] = 0x7FFFFFFF;
      if constexpr (kSharedM2) m2s[i * 256] = 0x7FFFFFFF;
      else m2r[i] = 0x7FFFFFFF;
    }
    hi_mask = p.hi_mask;
  }

  // |q|^2 of this thread's two query rows, from the values the product reads
  // (bf16, or the f32 rows of the tf32x3 entry)
  template <typename T>
  __device__ __forceinline__ void row_setup(const T* __restrict__ q, int d, int B, int row0) {
    const int row1 = row0 + 8;
    qs0 = 0.f;
    qs1 = 0.f;
    for (int k = 0; k < d; ++k) {
      const float u = row0 < B ? to_f(q[(size_t)row0 * d + k]) : 0.f;
      const float v = row1 < B ? to_f(q[(size_t)row1 * d + k]) : 0.f;
      qs0 += u * u;
      qs1 += v * v;
    }
  }

  __device__ __forceinline__ void update(const float (&a)[64], const float* xs,
                                         int32_t loc) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(xs + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float s = (e ? x.y : x.x) + (h ? qs1 : qs0);
          const float v = fmaxf(fmaf(-2.0f, a[i], s), 0.0f);
          const int32_t p = (__float_as_int(v) & hi_mask) | loc;
          if constexpr (kSharedM2) {
            // p < m2 is where the second place changes: to max(m1, p)
            if (p < m2s[i * 256]) m2s[i * 256] = max(m1[i], p);
          } else {
            m2r[i] = min(m2r[i], max(m1[i], p));
          }
          m1[i] = min(m1[i], p);
        }
    }
  }

  __device__ __forceinline__ void store(const Params& p, int span, int B, int row0, int l4,
                                        size_t) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qg = row0 + 8 * h;
      if (qg >= B) continue;
      int32_t* o = p.out + ((size_t)span * B + qg) * (2 * LANES);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 4 * j + 2 * h, c = 8 * j + 2 * l4;
        *reinterpret_cast<int2*>(o + c) = make_int2(m1[i], m1[i + 1]);
        int2* o2 = reinterpret_cast<int2*>(o + LANES + c);
        if constexpr (kSharedM2) *o2 = make_int2(m2s[i * 256], m2s[(i + 1) * 256]);
        else *o2 = make_int2(m2r[i], m2r[i + 1]);
      }
    }
  }
};
using PackedEpilogue = PackedEpilogueT<false>;       // resident layout
using PackedKloopEpilogue = PackedEpilogueT<true>;   // K-looped layouts

extern "C" int scan_topk_launch(const void* q, const void* X, const void* xsq,
                                int B, int Np, int d, int tn, int group,
                                int acc, int LB, int bf16, int entry, int layout,
                                void* out, void* stream) {
  if (B == 0) return 0;
  if (tn != group * LANES || Np % tn != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (entry == 1 || entry == 2) {  // wgmma on bf16, tf32x3 on f32
    if (bf16 != (entry == 1)) return (int)cudaErrorInvalidValue;
    PackedParams p{(int32_t*)out, ~((1 << LB) - 1)};
    return scan_tile::launch<PackedEpilogue, PackedKloopEpilogue>(
        q, X, xsq, B, Np, d, tn, group, acc, layout, entry == 2, p, s);
  }
  if (bf16) return launch<__nv_bfloat16>(q, X, xsq, B, Np, d, tn, group, acc, LB, out, s);
  return launch<float>(q, X, xsq, B, Np, d, tn, group, acc, LB, out, s);
}
