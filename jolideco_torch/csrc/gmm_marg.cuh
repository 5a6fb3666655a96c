// Per-row steps of the marginalised GMM score's derivatives: the
// patch-level unit gradient and Hessian action in float32 (gmm_patch.cu,
// K8 and K9; the fused marginalise backward, K4, left them for
// gmm_score_wg.cu's six-product core).
//
// With logit_k = -1/2 x^T A_k x + b_k . x + c_k and the forward's
// logsumexp lse, a component's softmax weight is w_k = exp(logit_k - lse).
// The logit comes from the triangle record in shared memory, by the same
// loop as the forward (gmm_logits.cuh), so that on the card the weights
// are those of the very logits the forward's lse summed. The
// derivative terms need A_k x, 4,096 multiply-adds per row and component,
// against 2,144 for the logit. For the shipped GMMs the logits are of
// order 1e5 to 1e8 and their gaps exceed the ~104 at which exp underflows
// in float32, so nearly every w_k is exactly 0: the A_k x pass runs only
// for components where some lane of the warp has w_k > 0, reading A_k
// (row-major, 16 KB) through the read-only path, where all K matrices
// (3.3 MB at K = 200) stay in L2. Skipping a w_k = 0 term is exact.
//
// Every lane of a warp must reach these functions (they vote with
// __any_sync); a lane with no row of its own passes lse = +inf, which
// makes its weights 0.

#pragma once

#include <cuda_runtime.h>

#include "gmm_logits.cuh"

namespace gmm {

constexpr unsigned kFullMask = 0xffffffffu;

// w = exp(logit - lse) of the record at cur (shared memory) for row x.
__device__ __forceinline__ float component_weight(const float* cur,
                                                  const float (&x)[1][kD],
                                                  float lse) {
  float logit[1];
  component_logits<1>(cur, x, logit);
  return expf(logit[0] - lse);
}

// Calls f(r, (A x)_r) for r = 0 .. 63, A row-major in global memory.
template <class F>
__device__ __forceinline__ void for_each_ax(const float* __restrict__ a,
                                            const float (&x)[kD], F&& f) {
  const float4* A = reinterpret_cast<const float4*>(a);
#pragma unroll
  for (int r = 0; r < kD; ++r) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
    for (int c = 0; c < kD; c += 4) {
      const float4 v = __ldg(A + r * (kD / 4) + c / 4);
      t0 = fmaf(v.x, x[c], t0);
      t1 = fmaf(v.y, x[c + 1], t1);
      t2 = fmaf(v.z, x[c + 2], t2);
      t3 = fmaf(v.w, x[c + 3], t3);
    }
    f(r, (t0 + t1) + (t2 + t3));
  }
}

// One component's step of the marginalise unit gradient of row x:
//     w = exp(logit - lse),  wsum += w,  acc += w (b - A x)
// (the unit gradient is acc / wsum once every component has been seen).
__device__ __forceinline__ void marg_unit_step(const float* cur,
                                               const float* __restrict__ a,
                                               const float (&x)[1][kD],
                                               float lse, float& wsum,
                                               float (&acc)[kD]) {
  const float w = component_weight(cur, x, lse);
  wsum += w;
  if (__any_sync(kFullMask, w > 0.f)) {
    const float* b = cur + kSym;
    for_each_ax(a, x[0], [&](int r, float ax) {
      acc[r] = fmaf(w, b[r] - ax, acc[r]);
    });
  }
}

}  // namespace gmm
