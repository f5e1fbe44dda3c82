// Hopper's shared-memory barriers and the 1-D bulk asynchronous copy, as inline
// PTX. Shared by the exact scan's tile product (scan_tile.cuh) and the codec
// scores' gather ring (codec_scores.cu). Works on sm_90 and sm_90a.
//
// Protocol. A barrier is 8 bytes of shared memory, initialised once with the
// number of arrivals that complete a phase. A copy is announced to the
// barrier with its byte count (mbar_expect_tx, which is also one arrival) and
// completes the phase when the bytes have landed. A waiter names the parity
// of the phase it waits for: phases alternate 0, 1, 0, ..., and on a fresh
// barrier a wait for parity 1 returns at once (the phase "before the first"
// counts as complete), which is how a producer finds every stage empty at the
// start.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Makes freshly initialised barriers visible to the asynchronous copies.
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spin until the phase of parity `parity` has completed. A pipeline fault must
// not hang the card: after about two seconds of waiting the kernel traps and
// the launch reports an error instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok = 0, spins = 0;
  long long t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok)
        : "r"(bar), "r"(parity)
        : "memory");
    if (ok) return;
    if ((++spins & 0xFFFu) == 0) {
      const long long now = clock64();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ll) __trap();
    }
  }
}

// One contiguous run of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) from device memory into shared memory, started by one thread; the
// bytes count toward the phase of `bar`. No tensor map is involved.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

}  // namespace hopper
