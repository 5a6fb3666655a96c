// Patch-level GMM scoring on Hopper (sm_90a): the scorer, its MAP unit
// gradient and its MAP Hessian action, in full float32. Built by nvcc
// into a shared library with a plain C interface and loaded with ctypes
// (jolideco_torch/utils/cuda_build.py); the Python wrappers and the plain
// PyTorch versions are in jolideco_torch/ops/gmm_pallas.py. Rows are
// contiguous (N, 64) float32 arrays of already masked, mean-subtracted
// 8x8 patches; the ragged tail of N is masked in each kernel.
//
// ---------------------------------------------------------------------
// gmm_score_rows_kernel replaces the JAX package's
// ops/gmm_pallas.py::_score_kernel. Per row x:
//     logit_k = -1/2 x^T A_k x + b_k . x + c_k
// over all K components; values = max_k logit_k (MAP) or
// logsumexp_k logit_k (marginalise, an online max-and-rescale sum), and
// argmax = the LOWEST index among equal maxima in both modes.
//
// What bounds it on the H100: operations. The quadratic form over the
// symmetric triangle is 2,080 + 64 multiply-adds per row and component,
// 5.6e10 flop for 65,025 rows and K = 200, about 0.83 ms at the 67
// TFLOP/s fp32 (non-tensor) peak; the bytes (17 MB) take 5 µs. Design:
// K1's (gmm_fused.cu::gmm_fwd_kernel) without the patch extraction —
// two rows per thread in registers, the row-padded triangle of A_k read
// as float4 shared-memory broadcasts (gmm_logits.cuh), component records
// double-buffered through shared memory, one __syncthreads per
// component. The TPU kernel's one-hot MXU tricks, bf16 hi/lo splits and
// K padding to 128 are not carried over. At 65,025 rows, K = 200 on an
// NVIDIA H100 80GB HBM3 (700 W limit): 1.67-1.70 ms, K1's loop 2-4%
// slower than K1 itself.
//
// ---------------------------------------------------------------------
// gmm_row_map_kernel<true> (C entry gmm_unit_map) replaces
// ops/gmm_pallas.py::_unit_map_kernel:
//     unit = b_{k*} - A_{k*} x          (d values / d x, argmax fixed)
// gmm_row_map_kernel<false> (C entry gmm_hvp_map) replaces
// ops/gmm_pallas.py::_hvp_map_kernel:
//     out = -A_{k*} t                   (the Hessian action on a tangent)
// A_k is symmetric, so x A_k = A_k x and the Hessian action is both the
// JVP and the VJP of the unit gradient.
//
// What bounds them: bytes. The rows in and out (16.6 MB each at 65,025
// rows) and the K matrices (3.3 MB at K = 200) are about 37 MB, 11 µs at
// 3.35 TB/s; the 0.53 GFLOP take 8 µs. Design (K2's per-patch step,
// gmm_fused.cu::gmm_bwd_kernel, without its epilogue): one thread per
// row, the row in registers, A_{k*} read as float4 through the read-only
// path (all K matrices fit in L2, and neighbouring rows often share k*),
// four output values stored as one float4. Plain stores, no atomics. On
// the same card: 0.064-0.077 ms, 13-16% of the bound; each thread's row
// is 256 contiguous bytes, so a warp's loads and stores are not
// coalesced (staging rows through shared memory is the next step).

#include <cuda_runtime.h>
#include <math_constants.h>

#include "gmm_logits.cuh"

namespace {

using gmm::kD;
using gmm::kRec;
using gmm::load_record;

constexpr int kScoreThreads = 128;
constexpr int kRPT = 2;              // rows per scoring thread
constexpr int kRowThreads = 128;

__device__ __forceinline__ void load_row(const float* __restrict__ src, int n,
                                         int n_total, float (&x)[kD]) {
  if (n >= n_total) {
#pragma unroll
    for (int c = 0; c < kD; ++c) x[c] = 0.f;
    return;
  }
  const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)n * kD);
#pragma unroll
  for (int c = 0; c < kD; c += 4) {
    const float4 v = __ldg(s4 + c / 4);
    x[c] = v.x;
    x[c + 1] = v.y;
    x[c + 2] = v.z;
    x[c + 3] = v.w;
  }
}

// Each thread scores kRPT rows, n = (blockIdx.x * kRPT + p) * blockDim.x +
// threadIdx.x.
template <bool kMarginalize>
__global__ void __launch_bounds__(kScoreThreads)
gmm_score_rows_kernel(const float* __restrict__ rows, int n_total,
                      const float* __restrict__ rec, int K,
                      float* __restrict__ values, int* __restrict__ argmax) {
  __shared__ __align__(16) float smem[2][kRec];

  int n[kRPT];
  float x[kRPT][kD];
#pragma unroll
  for (int p = 0; p < kRPT; ++p) {
    n[p] = (blockIdx.x * kRPT + p) * blockDim.x + threadIdx.x;
    load_row(rows, n[p], n_total, x[p]);
  }

  load_record(smem[0], rec, 0);
  __syncthreads();

  float best[kRPT], sum[kRPT];
  int best_k[kRPT];
#pragma unroll
  for (int p = 0; p < kRPT; ++p) {
    best[p] = -CUDART_INF_F;
    sum[p] = 0.f;
    best_k[p] = 0;
  }
  for (int k = 0; k < K; ++k) {
    const float* cur = smem[k & 1];
    if (k + 1 < K) load_record(smem[(k + 1) & 1], rec, k + 1);

    float logit[kRPT];
    gmm::component_logits<kRPT>(cur, x, logit);
#pragma unroll
    for (int p = 0; p < kRPT; ++p) {
      if (logit[p] > best[p]) {
        // sum of exp(logit - best) so far, rescaled to the new maximum
        if (kMarginalize) sum[p] = fmaf(sum[p], expf(best[p] - logit[p]), 1.f);
        best[p] = logit[p];
        best_k[p] = k;
      } else if (kMarginalize) {
        sum[p] += expf(logit[p] - best[p]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kRPT; ++p) {
    if (n[p] < n_total) {
      values[n[p]] = kMarginalize ? best[p] + logf(sum[p]) : best[p];
      argmax[n[p]] = best_k[p];
    }
  }
}

// out = b_{k*} - A_{k*} x (kUnit) or -A_{k*} x (the Hessian action, x = t).
template <bool kUnit>
__global__ void __launch_bounds__(kRowThreads)
gmm_row_map_kernel(const float* __restrict__ rows, const int* __restrict__ argmax,
                   const float* __restrict__ a_full,
                   const float* __restrict__ b_rows, int n_total,
                   float* __restrict__ out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_total) return;

  const int k = argmax[n];
  float x[kD];
  load_row(rows, n, n_total, x);

  const float4* A = reinterpret_cast<const float4*>(a_full + (size_t)k * kD * kD);
  const float* bk = kUnit ? b_rows + (size_t)k * kD : nullptr;
  float4* dst = reinterpret_cast<float4*>(out + (size_t)n * kD);
#pragma unroll
  for (int r0 = 0; r0 < kD; r0 += 4) {
    float o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
      for (int c = 0; c < kD; c += 4) {
        const float4 a = __ldg(A + r * (kD / 4) + c / 4);
        t0 = fmaf(a.x, x[c], t0);
        t1 = fmaf(a.y, x[c + 1], t1);
        t2 = fmaf(a.z, x[c + 2], t2);
        t3 = fmaf(a.w, x[c + 3], t3);
      }
      const float ax = (t0 + t1) + (t2 + t3);
      o[i] = kUnit ? __ldg(bk + r) - ax : -ax;
    }
    dst[r0 / 4] = make_float4(o[0], o[1], o[2], o[3]);
  }
}

int blocks_for(int n, int per_block) { return (n + per_block - 1) / per_block; }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = cudaSuccess); the
// wrappers never call them with n = 0.
int gmm_score_rows(const void* rows, int n, const void* rec, int K,
                   int marginalize, void* values, void* argmax, void* stream) {
  const int blocks = blocks_for(n, kScoreThreads * kRPT);
  auto s = static_cast<cudaStream_t>(stream);
  auto x = static_cast<const float*>(rows);
  auto r = static_cast<const float*>(rec);
  auto v = static_cast<float*>(values);
  auto a = static_cast<int*>(argmax);
  if (marginalize)
    gmm_score_rows_kernel<true><<<blocks, kScoreThreads, 0, s>>>(x, n, r, K, v, a);
  else
    gmm_score_rows_kernel<false><<<blocks, kScoreThreads, 0, s>>>(x, n, r, K, v, a);
  return static_cast<int>(cudaGetLastError());
}

int gmm_unit_map(const void* rows, const void* argmax, const void* a_full,
                 const void* b_rows, int n, void* out, void* stream) {
  gmm_row_map_kernel<true><<<blocks_for(n, kRowThreads), kRowThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(argmax),
      static_cast<const float*>(a_full), static_cast<const float*>(b_rows), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int gmm_hvp_map(const void* tangents, const void* argmax, const void* a_full,
                int n, void* out, void* stream) {
  gmm_row_map_kernel<false><<<blocks_for(n, kRowThreads), kRowThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tangents), static_cast<const int*>(argmax),
      static_cast<const float*>(a_full), nullptr, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* gmm_patch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
