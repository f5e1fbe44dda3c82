// Exact L2 scan with unpacked keep-2 per lane group (kernel B5).
//
// Replaces hnsw_tpu/ops/pallas_topk.py::_tile_kernel, the scan for callers
// that cannot give up mantissa bits to the index-in-mantissa packing of
// scan_topk.cu. Same geometry: the corpus X [Np, d] (Np a multiple of tn,
// padding rows carry a huge |x|^2) is cut into tiles of tn = 128 * group rows;
// tile row s * 128 + lane belongs to lane group `lane` (strided groups, G =
// 128 lanes); `acc` consecutive tiles form one span. For each (span, query,
// lane) the kernel keeps the two smallest of
//   v = |x|^2 - 2 q.x
// (no |q|^2 — the caller adds it after its top-k — and no clamp: v may be
// negative) with full f32 values and the candidates' global row ids as a
// second output: outd f32 [spans, B, 2G], outi int32 [spans, B, 2G] (min1
// lanes, then min2 lanes).
//
// Ties: candidates stream through a cell in row order with strict
// comparisons, so the lower row wins a tie for either place. That is the
// Pallas kernel's rule inside a tile and for first place across tiles; for
// second place across tiles the Pallas merge prefers a later tile's minimum
// over an equal earlier second. Both keep the same values; only the id of
// an exactly tied second place can differ.
//
// Bound on the H100: operations. 2*B*N*d flops (105 GFLOP at B=2048,
// N=200704, d=128) against 51 MB of bf16 corpus plus two [spans, B, 256]
// outputs: ~0.11 ms at the bf16 tensor-core peak; the keep-2 update (10
// instructions per element in the tensor-core entry: fma, two compares,
// select, byte permute, max, min, min, a shared-memory load and a predicated
// store) is bounded by the instruction rate at about the same time.
//
// Registers are the scarce resource in both entries: a value and an id for
// two places would take four words a cell. Only the two values stay in
// registers (every candidate is compared with them); a cell's two candidates
// are remembered as their local offsets loc = tile_in_span * group + s, 16
// bits each in one word (the wrapper checks acc * group <= 65536), and those
// words live in shared memory, [cell][thread] so that no two threads of a
// warp share a bank. Global row ids are formed when the span is done.
//
// Three entries; the wrapper chooses from dtype and d (never as a fallback)
// between the first two:
//
//  * entry 1, "wgmma": bf16 inputs (the host pads d to a multiple of 16).
//    The tile product of scan_tile.cuh, in the layout the wrapper names
//    (`layout` 0, the resident query tile, up to d = 192; 1, K-looped, any d),
//    with the epilogue below: the values of a thread's 64 cells in 128
//    registers (the K-looped layout: the second values in shared memory),
//    updated without a branch (m2 = min(m2, max(m1, v)); m1 = min(m1, v));
//    the id word is read for every candidate, the new word formed by one
//    byte permute, and written back under the predicate `v < m2`: with read
//    and write inside `if (v < m2)` some lane of a warp takes the branch at
//    almost every candidate (112 rows a cell), and each divergent branch then
//    waits for its own load. The 64 KB of id words leave room for three
//    stages of the resident ring at d=128 (the packed scan has four) and,
//    beside the 64 KB of second values, three of the K-looped one (packed:
//    five). Sums are f32 sums of exact bf16 products in the tensor core's
//    order (K-looped: per 64-column box, the boxes added in f32), so values
//    agree with a chain of FMAs to f32 rounding of the terms |x|^2 and 2 q.x,
//    not bit for bit.
//  * entry 2, "tf32x3": f32 inputs (the full-precision contract) at any d up
//    to the host's WGMMA_MAX_D (d a multiple of 4): the K-looped layout over
//    f32 rows, each box split into tf32 parts in shared memory and q.x summed
//    from three tf32 products (scan_tile.cuh), with the epilogue below. The
//    split's 32 KB lo area beside the epilogue's 128 KB leaves two ring
//    stages (bf16: three).
//  * entry 0, "simt": the first f32-FMA kernel, which the wrapper no longer
//    names (chip_smoke.py times it as the other entries' "was" where its
//    shared memory fits: d <= 715 here). f32 FMAs in a register-tiled layout: a block owns 64 queries x one span,
//    each of its 256 threads a 4-query x 8-lane accumulator tile and the
//    keep-2 state of those 32 cells. A first version that kept 96 words of
//    state in registers compiled to 180 registers, one block per SM, and ran
//    at half the packed scan's rate; with the id words in shared memory
//    __launch_bounds__(256, 2) holds it to the 128 registers that let two
//    blocks share an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_tile.cuh"

namespace {

constexpr int QT = 64;      // queries per block
constexpr int LANES = 128;  // G: lane groups per tile row block
constexpr int KC = 32;      // depth of one staging chunk
constexpr int XS_LD = LANES + 1;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(256, 2)
scan_topk_unpacked_kernel(const T* __restrict__ q, const T* __restrict__ X,
                          const float* __restrict__ xsq, int B, int d, int tn,
                          int group, int acc, int n_tiles,
                          float* __restrict__ outd, int32_t* __restrict__ outi) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [d][QT]
  float* Xs = Qs + (size_t)d * QT;  // [KC][XS_LD]
  // [32 cells][256 threads]: loc of m1 in the low 16 bits, of m2 in the high
  uint32_t* Ls = reinterpret_cast<uint32_t*>(Xs + KC * XS_LD) + threadIdx.x;

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

  float m1[4][8], m2[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      m1[i][j] = CUDART_INF_F;
      m2[i][j] = CUDART_INF_F;
      Ls[(i * 8 + j) * 256] = 0u;
    }

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
      const uint32_t loc = (uint32_t)(t * group + s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float xs = xsq[row0 + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = xs - 2.0f * a[i][j];
          if (v < m1[i][j]) {
            m2[i][j] = m1[i][j];
            m1[i][j] = v;
            uint32_t& L = Ls[(i * 8 + j) * 256];
            L = (L << 16) | loc;
          } else if (v < m2[i][j]) {
            m2[i][j] = v;
            uint32_t& L = Ls[(i * 8 + j) * 256];
            L = (L & 0xFFFFu) | (loc << 16);
          }
        }
      }
    }
  }
  const size_t row_base = (size_t)span * acc * tn;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qg = q0 + ty + 16 * i;
    if (qg >= B) continue;
    const size_t o = ((size_t)span * B + qg) * (2 * LANES);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lane = tx + 16 * j;
      const uint32_t L = Ls[(i * 8 + j) * 256];
      const uint32_t l1 = L & 0xFFFFu, l2 = L >> 16;
      outd[o + lane] = m1[i][j];
      outd[o + LANES + lane] = m2[i][j];
      outi[o + lane] = (int32_t)(row_base + (size_t)(l1 / group) * tn +
                                 (size_t)(l1 % group) * LANES + lane);
      outi[o + LANES + lane] = (int32_t)(row_base + (size_t)(l2 / group) * tn +
                                         (size_t)(l2 % group) * LANES + lane);
    }
  }
}

template <typename T>
int launch(const void* q, const void* X, const void* xsq, int B, int Np, int d,
           int tn, int group, int acc, void* outd, void* outi, cudaStream_t s) {
  const int n_tiles = Np / tn;
  const int spans = (n_tiles + acc - 1) / acc;
  const dim3 grid((B + QT - 1) / QT, spans), block(256);
  const size_t smem = ((size_t)d * QT + KC * XS_LD + 32 * 256) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        scan_topk_unpacked_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  scan_topk_unpacked_kernel<T><<<grid, block, smem, s>>>(
      (const T*)q, (const T*)X, (const float*)xsq, B, d, tn, group, acc,
      n_tiles, (float*)outd, (int32_t*)outi);
  return (int)cudaGetLastError();
}

}  // namespace

struct UnpackedParams {
  float* outd;
  int32_t* outi;
};

// Epilogue of the tensor-core entry: keep-2 values in registers, the two
// candidates' local offsets in one shared-memory word per cell. With
// kSharedM2 (the K-looped layout, whose per-box products take 64 more
// registers) the second values live in shared memory too, beside the id
// words. (A named type: it instantiates a __global__ template.)
template <bool kSharedM2>
struct UnpackedEpilogueT {
  // [64 cells][256 threads] id words, then (kSharedM2) as many second values
  static constexpr int kExtraSmem = (kSharedM2 ? 2 : 1) * 64 * 256 * 4;
  using Params = UnpackedParams;
  float m1[64];
  float m2r[kSharedM2 ? 1 : 64];
  uint32_t* Ls;  // this thread's column of id words
  float* m2s;    // this thread's column of second values (kSharedM2)

  __device__ __forceinline__ void init(const Params&, uint8_t* extra, int ctid) {
    Ls = reinterpret_cast<uint32_t*>(extra) + ctid;
    if constexpr (kSharedM2) m2s = reinterpret_cast<float*>(extra) + 64 * 256 + ctid;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      m1[i] = CUDART_INF_F;
      if constexpr (kSharedM2) m2s[i * 256] = CUDART_INF_F;
      else m2r[i] = CUDART_INF_F;
      Ls[i * 256] = 0u;
    }
  }

  template <typename T>
  __device__ __forceinline__ void row_setup(const T*, int, int, int) {}

  __device__ __forceinline__ float second(int i) const {
    if constexpr (kSharedM2) return m2s[i * 256];
    else return m2r[i];
  }

  __device__ __forceinline__ void update(const float (&a)[64], const float* xs,
                                         uint32_t loc) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 x = *reinterpret_cast<const float2*>(xs + 8 * j);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const float v = fmaf(-2.0f, a[i], e ? x.y : x.x);
          // strict comparisons: the lower row keeps a tied place. No branch:
          // the word is read for every candidate and written back under a
          // predicate, so the 64 cells' reads overlap instead of each waiting
          // inside its own divergent branch.
          const bool in2 = v < second(i);
          const uint32_t L = Ls[i * 256];
          // first place: (old first -> second, loc -> first); second: loc -> second
          const uint32_t Ln = __byte_perm(L, loc, v < m1[i] ? 0x1054u : 0x5410u);
          if (in2) Ls[i * 256] = Ln;
          if constexpr (kSharedM2) {
            // v < m2 is where the second value changes: to max(m1, v)
            if (in2) m2s[i * 256] = fmaxf(m1[i], v);
          } else {
            m2r[i] = fminf(m2r[i], fmaxf(m1[i], v));
          }
          m1[i] = fminf(m1[i], v);
        }
    }
  }

  __device__ __forceinline__ void store(const Params& p, int span, int B, int row0, int l4,
                                        size_t row_base) const {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qg = row0 + 8 * h;
      if (qg >= B) continue;
      const size_t o = ((size_t)span * B + qg) * (2 * LANES);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int i = 4 * j + 2 * h, c = 8 * j + 2 * l4;
        const uint32_t La = Ls[i * 256], Lb = Ls[(i + 1) * 256];
        // tn = group * 128, so a local offset l is row l * 128 + lane of the span
        const int32_t r = (int32_t)row_base + c;
        *reinterpret_cast<float2*>(p.outd + o + c) = make_float2(m1[i], m1[i + 1]);
        *reinterpret_cast<float2*>(p.outd + o + LANES + c) =
            make_float2(second(i), second(i + 1));
        *reinterpret_cast<int2*>(p.outi + o + c) =
            make_int2(r + (int32_t)(La & 0xFFFFu) * LANES, r + 1 + (int32_t)(Lb & 0xFFFFu) * LANES);
        *reinterpret_cast<int2*>(p.outi + o + LANES + c) =
            make_int2(r + (int32_t)(La >> 16) * LANES, r + 1 + (int32_t)(Lb >> 16) * LANES);
      }
    }
  }
};
using UnpackedEpilogue = UnpackedEpilogueT<false>;      // resident layout
using UnpackedKloopEpilogue = UnpackedEpilogueT<true>;  // K-looped layouts

extern "C" int scan_topk_unpacked_launch(const void* q, const void* X,
                                         const void* xsq, int B, int Np, int d,
                                         int tn, int group, int acc, int bf16,
                                         int entry, int layout, void* outd, void* outi,
                                         void* stream) {
  if (B == 0) return 0;
  if (tn != group * LANES || Np % tn != 0 || (long long)acc * group > 65536)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (entry == 1 || entry == 2) {  // wgmma on bf16, tf32x3 on f32
    if (bf16 != (entry == 1)) return (int)cudaErrorInvalidValue;
    UnpackedParams p{(float*)outd, (int32_t*)outi};
    return scan_tile::launch<UnpackedEpilogue, UnpackedKloopEpilogue>(
        q, X, xsq, B, Np, d, tn, group, acc, layout, entry == 2, p, s);
  }
  if (bf16)
    return launch<__nv_bfloat16>(q, X, xsq, B, Np, d, tn, group, acc, outd, outi, s);
  return launch<float>(q, X, xsq, B, Np, d, tn, group, acc, outd, outi, s);
}
