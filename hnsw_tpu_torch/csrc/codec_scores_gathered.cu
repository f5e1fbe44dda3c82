// Codec scores over pre-gathered blocks (kernel B4).
//
// Replaces hnsw_tpu/ops/pallas_scores.py::_kernel (pallas_codec_scores). The
// caller has already gathered, for each query b, the K int8 neighbour rows of
// its expanded nodes into blk[b] = [K, d] (contiguous) and their quantized
// squared norms into csq[b] = [K]. Each row is dequantized by `scale` and
// scored against the f32 query:
//   form 0 (L2):     sqrt(max(qsn - 2 ip + csq, 0)),   qsn = |q|^2
//   form 1 (Dot):    1 - ip
//   form 2 (Cosine): 1 - ip / max(qsn, 1e-20),         qsn = |q|
// with ip = scale * sum_k blk[b, r, k] * q[b, k]. Unlike the fused kernel
// (codec_scores.cu) |c|^2 is read from csq as given, not recomputed from the
// row, so the two kernels agree to rounding, not bit for bit.
//
// Bound on the H100: bytes. The gathered blocks are streamed once (B*K*d int8,
// 0.47 GB at B=16384, K=224, d=128), csq and the output are B*K f32 each:
// ~0.15 ms at 3.35 TB/s, against 2 flops per byte. Design: one thread block
// per query (the query sits in shared memory and is read by every row), a row
// handled by a group of lpr lanes with 16-byte loads (8 lanes per 128-byte
// row at d=128, so a warp reads four consecutive rows = 512 contiguous bytes),
// products summed in f32 and reduced with warp shuffles. Rows whose length is
// not a multiple of 16 bytes (or a base that is not 16-byte aligned) take the
// scalar path, a whole warp per row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
    if (live && sl == 0) {
      const float ipf = ip * scale;
      float res;
      if (form == 0) {
        res = sqrtf(fmaxf(sn - 2.0f * ipf + my_csq[r], 0.0f));
      } else if (form == 1) {
        res = 1.0f - ipf;
      } else {
        res = 1.0f - ipf / fmaxf(sn, 1e-20f);
      }
      out[(size_t)b * K + r] = res;
    }
  }
}

}  // namespace

extern "C" int codec_scores_gathered_launch(const void* q, const void* blk,
                                            const void* csq, const void* qsn,
                                            const void* scale, int B, int K,
                                            int d, int form, void* out,
                                            void* stream) {
  if (B == 0 || K == 0) return 0;
  const bool vec16 = (d % 16) == 0 && (reinterpret_cast<uintptr_t>(blk) % 16) == 0;
  int lpr = 32;
  if (vec16) {
    const int chunks = d / 16;
    lpr = 1;
    while (lpr * 2 <= chunks && lpr < 32) lpr *= 2;
  }
  const dim3 grid(B), block(256);
  const size_t smem = (size_t)d * sizeof(float);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
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
