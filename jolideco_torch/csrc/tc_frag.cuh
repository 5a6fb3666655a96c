// Warp-level tensor-core helpers for Hopper (sm_90a), shared by
// gmm_fused_tc.cu (the GMM logits of the precision dial's "split" and
// "bf16" modes) and pfft_conv_wg.cu (K3: the bf16 type, cp.async and
// ldmatrix). Copies into shared memory with cp.async, fragments from
// shared memory with ldmatrix, the mma.sync m16n8k16 product (bf16
// operands, float32 accumulators) and an operand pair put into the bf16
// planes of either mode: its hi/lo split (three products) or its bf16
// rounding (one product).

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

// Two 8x8 matrices: lanes 0-7 give the rows of the first, 8-15 those of
// the second (the addresses of lanes 16-31 are not read).
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(p)));
}

// c += a b for one m16n8k16 tile, bf16 operands, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
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
