// Tensor-core operand helpers for Hopper (sm_90a), shared by
// gmm_score_wg.cu (the bf16 type and an operand pair put into the bf16
// planes of the precision dial's "split" or "bf16" mode: its hi/lo split
// for three products, or its bf16 rounding for one) and pfft_conv_wg.cu
// (K3: the bf16 type, copies into shared memory with cp.async and
// fragments from shared memory with ldmatrix).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// The pair v into operand columns (idx, idx + 1) of the hi and lo
// planes: hi = bf16(v), lo = bf16(v - hi), round to nearest even; v.x
// first (the real part, where v is a complex value).
__device__ __forceinline__ void put_split(bf16* hi, bf16* lo, int idx,
                                          float2 v) {
  const __nv_bfloat162 h = __float22bfloat162_rn(v);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi + idx) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + idx) =
      __float22bfloat162_rn(make_float2(v.x - hf.x, v.y - hf.y));
}

// The pair v into operand columns (idx, idx + 1) of the planes of a
// mode of kProducts bf16 products a k16 step: split into hi and lo for
// 3 ("split"), rounded to bf16 into hi alone for 1 ("bf16", the TPU's
// Precision.DEFAULT: the same hi).
template <int kProducts>
__device__ __forceinline__ void put_operand(bf16* hi, bf16* lo, int idx,
                                            float2 v) {
  static_assert(kProducts == 1 || kProducts == 3, "one or three products");
  if constexpr (kProducts == 3)
    put_split(hi, lo, idx, v);
  else
    *reinterpret_cast<__nv_bfloat162*>(hi + idx) = __float22bfloat162_rn(v);
}

}  // namespace tc
