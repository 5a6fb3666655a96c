// Hopper (sm_90a) primitives of the warpgroup kernels (gmm_score_wg.cu,
// pfft_conv_wg.cu): mbarriers, the bulk copy from device memory into
// shared memory that completes on one, the proxy fence, named barriers,
// setmaxnreg, shared-memory matrix descriptors and the wgmma product
// with A from registers (its fence, commit and wait; the instruction
// itself is wg_mma_n200.cuh's). Each is one PTX instruction or a loop
// around one; the PTX ISA names them.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible (to the async proxy too) before
// anyone arrives on them or copies into them
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of transactions (the copies that
// complete on this barrier)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// waits until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------------ bulk copies

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from device
// memory into this CTA's shared memory, completing on `bar` (the
// instruction's destination space is the cluster's, of which a CTA
// launched alone is the only member)
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// makes this thread's writes to shared memory visible to the async proxy
// (a later wgmma reading them through a descriptor)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------- named barriers

// waits at barrier `id` until `count` threads (this one included) have
// reached it by bar_sync or bar_arrive
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// counts this thread at barrier `id` without waiting
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------- registers

// the registers of each thread of the warpgroup (all four warps)
template <int kRegs>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// ------------------------------------------------------------------ wgmma

// The descriptor of a K-major bf16 operand in shared memory without
// swizzling: 8 x 8 core matrices (eight rows of 16 bytes, 128 contiguous
// bytes), `lbo` bytes between the two core matrices of a k16 step (along
// K), `sbo` bytes between groups of eight rows (along M or N).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = 0;
  d |= static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3fff);
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32;
  return d;  // base offset 0, layout type 0 (no swizzle)
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving reads or writes of v across an
// asynchronous product that owns it
__device__ __forceinline__ void fence_operand(float& v) {
  asm volatile("" : "+f"(v)::"memory");
}

}  // namespace wg

#include "wg_mma_n200.cuh"
