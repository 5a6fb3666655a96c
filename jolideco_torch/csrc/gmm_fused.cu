// Fused patch extraction + GMM scoring on Hopper (sm_90a), forward (MAP
// and marginalise) and both backwards, in full float32: the precision
// dial's "f32" mode ("highest"), and the MAP backward, which reads no
// logit, under every dial (the "split" mode's forwards and marginalise
// backward are gmm_fused_tc.cu's). Built by nvcc into a shared library
// with a plain C interface and loaded with ctypes
// (jolideco_torch/utils/cuda_build.py); the Python wrappers and the plain
// PyTorch versions of the kernels are in jolideco_torch/ops/gmm_fused.py.
//
// Patch enumeration (both kernels). For stride s the patches fall into
// G = (8/s)^2 offset groups (a, b), a, b in {0, s, 2s, ...} < 8, group
// index g = (a/s)·(8/s) + b/s. Each group is a non-overlapping tiling of
// 8x8 patches on a common ny x nx grid, ny = H/8, nx = W/8: patch (i, j)
// of group g covers rows a+8i .. a+8i+7 and columns b+8j .. b+8j+7 of
// the (already cycle-spun) image. Patch n = (g·ny + i)·nx + j. A patch is
// valid when it lies inside the image (i < (H-a)/8 and j < (W-b)/8) and
// every one of its pixels is above the zero-flux sentinel; an invalid
// patch is zeroed before the mean subtraction.
//
// ---------------------------------------------------------------------
// gmm_fwd_kernel replaces the JAX package's ops/gmm_fused.py::_fwd_kernel.
// Per patch: load, mask, subtract the mean, then
//     logit_k = -1/2 x^T A_k x + b_k . x + c_k
// over all K components, keeping the running maximum and the LOWEST
// index among equal maxima (the TPU kernel's min-index argmax); values is
// that maximum (MAP, gmm_fwd_kernel<false>) or the logsumexp
// (marginalise, <true>: an online max-and-rescale sum, as the patch-level
// scorer gmm_patch.cu::gmm_score_rows_kernel<true> takes it).
//
// What bounds it on the H100: the quadratic form, 64·64 multiply-adds per
// patch and component (1.1e11 flop for 65,536 patches and K = 200, half
// of it with the symmetric triangle below) on the fp32 CUDA cores, and
// the shared-memory reads that feed them. Bytes are small: the image
// is read once per group and the (N, 64) normalised patches are written
// once (16 MB at 1024²).
//
// Design: each thread scores two patches, their 2 x 64 values held in
// registers (all indices are compile-time after unrolling). A_k is
// symmetric, so only its upper triangle is read, with the off-diagonal
// entries doubled on the host: 2,176 multiply-adds instead of 4,096.
// Each row of that triangle starts at a multiple of four columns
// (entries left of the diagonal are stored as zeros) so that it is read
// as float4s, and every thread of a warp reads the same address: a
// shared-memory broadcast, no bank conflicts; each float4 feeds eight
// multiply-adds (two patches). Component records (A_sym, b, c) are
// staged through shared memory one at a time, double-buffered so that
// one __syncthreads per component suffices. Four partial sums per row
// and patch give the FMA pipe independent chains. The record layout and
// the per-component logit loop live in gmm_logits.cuh, shared with the
// patch-level scorer (gmm_patch.cu). At 1024², K = 200 on
// an NVIDIA H100 80GB HBM3 (700 W limit) one patch per thread took 2.41
// ms, two 1.62-1.65 ms, three (254 registers) 2.39 ms. No tensor cores
// (wgmma) yet: this is the plain fp32 kernel that later PRs make fast.
//
// ---------------------------------------------------------------------
// gmm_bwd_kernel replaces the JAX package's ops/gmm_fused.py::_bwd_kernel.
// Per valid patch with argmax k* and cotangent dv:
//     u = dv · (b_{k*} - A_{k*} x),  u -= mean(u)
// (the transpose of the mean subtraction; invalid patches have zero
// gradient), stored into its offset group's own (H, W) image plane.
//
// What bounds it: reading the selected row block A_{k*} (16 KB per patch,
// about 1 GB per call at 1024²), served from the caches: all K matrices
// (3.3 MB at K = 200) fit in L2, and neighbouring patches often share
// k*. Design: one thread per patch, x and u in
// registers, A_{k*} read as float4 through the read-only path. Patches of
// one group do not overlap, so every store is a plain store: no atomics,
// deterministic. The wrapper zero-fills the G planes and sums them.
//
// ---------------------------------------------------------------------
// gmm_bwd_marg_kernel replaces ops/gmm_fused.py::_bwd_marg_kernel, the
// marginalise backward. Per valid patch with the forward's logsumexp lse
// and cotangent dv:
//     w_k = exp(logit_k - lse),  u = dv · sum_k w_k (b_k - A_k x) / sum_k w_k
// with the logits recomputed from the saved patches (as the TPU kernel
// does: no (N, K) residual), then K2's epilogue.
//
// What bounds it: operations, the recomputed logits (5.6e10 flop at
// 1024², K = 200, 0.84 ms at the fp32 peak); the A_k x terms run only for
// components with w_k > 0 in some lane of the warp, about one per patch
// for the shipped GMMs (gmm_marg.cuh, whose per-row step it shares with
// gmm_patch.cu::gmm_unit_marg_kernel). Design: K1's component loop at one
// patch per thread (the gradient accumulator takes the registers of K1's
// second patch), triangle records double-buffered in shared memory,
// A_k read through the read-only path when the warp needs it. Invalid
// patches take no A_k x pass and store nothing. On an NVIDIA H100 80GB
// HBM3 (700 W limit) at 1024², K = 200: 2.58-2.61 ms (32% of its bound),
// 255 registers with 44 bytes spilled; gmm_fwd_kernel<true> 1.73-1.74 ms
// (168 registers, 8 bytes spilled) against 1.64 ms for <false>.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "gmm_logits.cuh"
#include "gmm_marg.cuh"
#include "gmm_patches.cuh"

namespace {

using gmm::kD;
using gmm::kRec;
using gmm::load_record;
using gmm::load_patch;
using gmm::load_row;
using gmm::kP;
using gmm::patch_pos;
using gmm::PatchPos;
using gmm::store_patch_gradient;

constexpr int kFwdThreads = 128;
constexpr int kPPT = 2;               // patches per forward thread
constexpr int kBwdThreads = 128;
constexpr int kBwdMargThreads = 128;

// Each thread scores kPPT patches, n = (blockIdx.x * kPPT + p) *
// blockDim.x + threadIdx.x, so that every float4 of A read from shared
// memory feeds kPPT * 4 multiply-adds.
template <bool kMarginalize>
__global__ void __launch_bounds__(kFwdThreads)
gmm_fwd_kernel(const float* __restrict__ img, int H, int W, int stride,
               int ny, int nx, int n_total, float sentinel,
               const float* __restrict__ rec, int K,
               float* __restrict__ values, int* __restrict__ argmax,
               float* __restrict__ valid_out, float* __restrict__ xtn) {
  __shared__ __align__(16) float smem[2][kRec];

  int n[kPPT];
  float x[kPPT][kD];
  float valid[kPPT];
#pragma unroll
  for (int p = 0; p < kPPT; ++p) {
    n[p] = (blockIdx.x * kPPT + p) * blockDim.x + threadIdx.x;
    valid[p] = load_patch(img, H, W, stride, ny, nx, n[p], n_total, sentinel,
                          xtn, x[p]);
  }

  load_record(smem[0], rec, 0);
  __syncthreads();

  float best[kPPT], sum[kPPT];
  int best_k[kPPT];
#pragma unroll
  for (int p = 0; p < kPPT; ++p) {
    best[p] = -CUDART_INF_F;
    sum[p] = 0.f;
    best_k[p] = 0;
  }
  for (int k = 0; k < K; ++k) {
    const float* cur = smem[k & 1];
    if (k + 1 < K) load_record(smem[(k + 1) & 1], rec, k + 1);

    float logit[kPPT];
    gmm::component_logits<kPPT>(cur, x, logit);
#pragma unroll
    for (int p = 0; p < kPPT; ++p) {
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
  for (int p = 0; p < kPPT; ++p) {
    if (n[p] < n_total) {
      values[n[p]] = kMarginalize ? best[p] + logf(sum[p]) : best[p];
      argmax[n[p]] = best_k[p];
      valid_out[n[p]] = valid[p];
    }
  }
}

__global__ void __launch_bounds__(kBwdThreads)
gmm_bwd_kernel(const float* __restrict__ xtn, const int* __restrict__ argmax,
               const float* __restrict__ valid, const float* __restrict__ dvalues,
               const float* __restrict__ a_full, const float* __restrict__ b_rows,
               int H, int W, int stride, int ny, int nx, int n_total,
               float* __restrict__ planes) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_total || valid[n] == 0.f) return;

  const int k = argmax[n];
  const float dv = dvalues[n];
  float x[kD];
  load_row(xtn, n, n_total, x);

  const float4* A = reinterpret_cast<const float4*>(a_full + (size_t)k * kD * kD);
  const float* bk = b_rows + (size_t)k * kD;
  float u[kD];
#pragma unroll
  for (int r = 0; r < kD; ++r) {
    float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll
    for (int c = 0; c < kD; c += 4) {
      const float4 a = __ldg(A + r * (kD / 4) + c / 4);
      t0 = fmaf(a.x, x[c], t0);
      t1 = fmaf(a.y, x[c + 1], t1);
      t2 = fmaf(a.z, x[c + 2], t2);
      t3 = fmaf(a.w, x[c + 3], t3);
    }
    u[r] = dv * (__ldg(bk + r) - ((t0 + t1) + (t2 + t3)));
  }
  store_patch_gradient(u, n, H, W, stride, ny, nx, planes);
}

// One patch per thread; every thread of the block runs the component loop
// (shared records, warp votes), valid or not.
__global__ void __launch_bounds__(kBwdMargThreads)
gmm_bwd_marg_kernel(const float* __restrict__ xtn, const float* __restrict__ lse,
                    const float* __restrict__ valid,
                    const float* __restrict__ dvalues,
                    const float* __restrict__ rec, const float* __restrict__ a_full,
                    int H, int W, int stride, int ny, int nx, int n_total, int K,
                    float* __restrict__ planes) {
  __shared__ __align__(16) float smem[2][kRec];

  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = n < n_total && valid[n] != 0.f;
  float x[1][kD];
  load_row(xtn, live ? n : n_total, n_total, x[0]);
  const float l = live ? __ldg(lse + n) : CUDART_INF_F;
  float acc[kD];
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] = 0.f;
  float wsum = 0.f;

  load_record(smem[0], rec, 0);
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const float* cur = smem[k & 1];
    if (k + 1 < K) load_record(smem[(k + 1) & 1], rec, k + 1);
    gmm::marg_unit_step(cur, a_full + (size_t)k * kD * kD, x, l, wsum, acc);
    __syncthreads();
  }

  if (!live) return;
  const float scale = dvalues[n] / wsum;
#pragma unroll
  for (int c = 0; c < kD; ++c) acc[c] *= scale;
  store_patch_gradient(acc, n, H, W, stride, ny, nx, planes);
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int gmm_fused_fwd(const void* img, int H, int W, int stride, int ny, int nx,
                  float sentinel, const void* rec, int K, int marginalize,
                  void* values, void* argmax, void* valid, void* xtn,
                  void* stream) {
  const int groups = (kP / stride) * (kP / stride);
  const int n_total = groups * ny * nx;
  const int blocks = (n_total + kFwdThreads * kPPT - 1) / (kFwdThreads * kPPT);
  auto kernel = marginalize ? gmm_fwd_kernel<true> : gmm_fwd_kernel<false>;
  kernel<<<blocks, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), H, W, stride, ny, nx, n_total, sentinel,
      static_cast<const float*>(rec), K, static_cast<float*>(values),
      static_cast<int*>(argmax), static_cast<float*>(valid),
      static_cast<float*>(xtn));
  return static_cast<int>(cudaGetLastError());
}

int gmm_fused_bwd(const void* xtn, const void* argmax, const void* valid,
                  const void* dvalues, const void* a_full, const void* b_rows,
                  int H, int W, int stride, int ny, int nx, void* planes,
                  void* stream) {
  const int groups = (kP / stride) * (kP / stride);
  const int n_total = groups * ny * nx;
  const int blocks = (n_total + kBwdThreads - 1) / kBwdThreads;
  gmm_bwd_kernel<<<blocks, kBwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xtn), static_cast<const int*>(argmax),
      static_cast<const float*>(valid), static_cast<const float*>(dvalues),
      static_cast<const float*>(a_full), static_cast<const float*>(b_rows), H, W,
      stride, ny, nx, n_total, static_cast<float*>(planes));
  return static_cast<int>(cudaGetLastError());
}

int gmm_fused_bwd_marg(const void* xtn, const void* lse, const void* valid,
                       const void* dvalues, const void* rec, const void* a_full,
                       int H, int W, int stride, int ny, int nx, int K,
                       void* planes, void* stream) {
  const int groups = (kP / stride) * (kP / stride);
  const int n_total = groups * ny * nx;
  const int blocks = (n_total + kBwdMargThreads - 1) / kBwdMargThreads;
  gmm_bwd_marg_kernel<<<blocks, kBwdMargThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xtn), static_cast<const float*>(lse),
      static_cast<const float*>(valid), static_cast<const float*>(dvalues),
      static_cast<const float*>(rec), static_cast<const float*>(a_full), H, W,
      stride, ny, nx, n_total, K, static_cast<float*>(planes));
  return static_cast<int>(cudaGetLastError());
}

const char* gmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
