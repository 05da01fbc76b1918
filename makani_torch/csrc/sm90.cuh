// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (K1 in sht_legendre.cu, K3 in dhconv.cu, K9 in dhconv_grad.cu, K18 and
// K19 in afno.cuh and afno_mixer_grad.cu) and the cp.async staging of K5: asynchronous and bulk copies into shared memory,
// mbarriers, the TF32 split of 3xTF32, and the wgmma fences and
// shared-memory matrix descriptors.
#pragma once

#include <stdint.h>

namespace sm90 {

constexpr int CORE = 128;  // a wgmma core matrix: 8 rows x 16 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) { return static_cast<uint32_t>(__cvta_generic_to_shared(p)); }

// copies BYTES (4, 8 or 16) from src, or writes BYTES zeros when !pred (src is not read)
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool pred) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(pred ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)), "l"(src), "n"(BYTES), "r"(pred ? BYTES : 0));
  }
}
// copies the first src_bytes (0 to 16) of a 16-byte chunk and zero-fills the
// rest; src is 16-byte aligned and is not read where src_bytes is 0
__device__ __forceinline__ void cp_async_zfill16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// waits until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Bulk copies (the TMA without a tensor map): BYTES (a multiple of 16)
// from a 16-byte aligned global address to a 16-byte aligned shared one,
// completed on an mbarrier that expects the bytes
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
// makes the barriers' initialization visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// waits until the barrier's phase of the given parity has completed; traps
// (a launch error, not a hung card) if it has not after ~2^30 polls
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 30)) __trap();
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done)
                 : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
               "r"(smem_addr(bar))
               : "memory");
}

// fp32 -> TF32 (round to nearest, ties away), as the 32-bit pattern wgmma reads
__device__ __forceinline__ uint32_t tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// shared-memory matrix descriptor: K-major, no swizzle; lbo is the byte
// distance between core matrices along k, sbo between 8-row groups. Or'ed
// with SWIZZLE_128B: rows of 128 bytes whose 16-byte pieces are permuted by
// the row's index within its 8-row (1024-byte aligned) atom; sbo = 1024
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, int lbo, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

constexpr uint64_t SWIZZLE_128B = 1ull << 62;

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// waits until at most N of the warpgroup's committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() { asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory"); }
// generic-proxy shared stores (st.shared, cp.async) made visible to the wgmmas (async proxy)
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// pins a register's reads and writes after an asynchronous wgmma's wait
__device__ __forceinline__ void pin(float& v) { asm volatile("" : "+f"(v)::"memory"); }
__device__ __forceinline__ void pin(uint32_t& v) { asm volatile("" : "+r"(v)::"memory"); }

}  // namespace sm90
