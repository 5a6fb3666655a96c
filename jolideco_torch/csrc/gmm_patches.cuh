// Offset-group patches of an image, as the fused image-level scorers
// read them and their backwards write them back: gmm_fused.cu (the
// float32 MAP kernels), gmm_fused_tc.cu (the logsumexp kernels of the
// "split" and "bf16" modes) and gmm_score_wg.cu (the warpgroup kernels).
// The enumeration is stated at the top of gmm_fused.cu.

#pragma once

#include <cuda_runtime.h>

#include "gmm_logits.cuh"

namespace gmm {

constexpr int kP = 8;  // patch edge

struct PatchPos {
  int g, i, j, a, b;
  bool inside;
};

__device__ __forceinline__ PatchPos patch_pos(int n, int H, int W, int stride,
                                              int ny, int nx) {
  PatchPos p;
  const int per_group = ny * nx;
  p.g = n / per_group;
  const int rem = n - p.g * per_group;
  p.i = rem / nx;
  p.j = rem - p.i * nx;
  const int groups_per_row = kP / stride;
  p.a = (p.g / groups_per_row) * stride;
  p.b = (p.g % groups_per_row) * stride;
  p.inside = p.i < (H - p.a) / kP && p.j < (W - p.b) / kP;
  return p;
}

// Loads patch n (masked, mean-subtracted) into x, writes it to xtn and
// returns its validity; a patch index past the end gives x = 0.
__device__ __forceinline__ float load_patch(const float* __restrict__ img, int H,
                                            int W, int stride, int ny, int nx,
                                            int n, int n_total, float sentinel,
                                            float* __restrict__ xtn,
                                            float (&x)[kD]) {
  if (n >= n_total) {
#pragma unroll
    for (int c = 0; c < kD; ++c) x[c] = 0.f;
    return 0.f;
  }
  const PatchPos p = patch_pos(n, H, W, stride, ny, nx);
  bool ok = p.inside;
  if (ok) {
    const float* base = img + (size_t)(p.a + kP * p.i) * W + (p.b + kP * p.j);
#pragma unroll
    for (int dy = 0; dy < kP; ++dy) {
#pragma unroll
      for (int dx = 0; dx < kP; ++dx) {
        const float v = __ldg(base + (size_t)dy * W + dx);
        x[dy * kP + dx] = v;
        ok = ok && (v > sentinel);
      }
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    x[c] = ok ? x[c] : 0.f;
    sum += x[c];
  }
  const float mean = sum * (1.f / kD);
  float4* dst = reinterpret_cast<float4*>(xtn + (size_t)n * kD);
#pragma unroll
  for (int c = 0; c < kD; c += 4) {
    x[c] -= mean;
    x[c + 1] -= mean;
    x[c + 2] -= mean;
    x[c + 3] -= mean;
    dst[c / 4] = make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
  }
  return ok ? 1.f : 0.f;
}

// Subtracts the mean of u (the transpose of the mean subtraction) and
// stores it into patch n's place in its offset group's plane (the
// backwards' epilogue).
__device__ __forceinline__ void store_patch_gradient(float (&u)[kD], int n,
                                                     int H, int W, int stride,
                                                     int ny, int nx,
                                                     float* __restrict__ planes) {
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < kD; ++c) sum += u[c];
  const float mean = sum * (1.f / kD);

  const PatchPos p = patch_pos(n, H, W, stride, ny, nx);
  float* dst = planes + (size_t)p.g * H * W + (size_t)(p.a + kP * p.i) * W +
               (p.b + kP * p.j);
#pragma unroll
  for (int dy = 0; dy < kP; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kP; ++dx)
      dst[(size_t)dy * W + dx] = u[dy * kP + dx] - mean;
  }
}

// The gradient at pixel (y, x) of the (H, W) image from the patches' u
// rows (N, 64), already less their means: the sum over the offset
// groups, in order, of the u entry of the group's patch that covers it
// (the patches of one group do not overlap). The overlap-add of the
// backwards that write u rows to a scratch (K2 in gmm_fused.cu, K4 in
// gmm_score_wg.cu), one thread a pixel: no zero-fill, no float atomics,
// the same bits every run.
__device__ __forceinline__ float patch_units_at(const float* __restrict__ units,
                                                int y, int x, int stride,
                                                int ny, int nx) {
  float sum = 0.f;
  int g = 0;  // group (a / stride) (8 / stride) + b / stride
  for (int a = 0; a < kP; a += stride) {
    for (int b = 0; b < kP; b += stride, ++g) {
      const int dy = y - a, dx = x - b;
      if (dy < 0 || dx < 0 || dy >= kP * ny || dx >= kP * nx) continue;
      const size_t n = ((size_t)g * ny + dy / kP) * nx + dx / kP;
      sum += __ldg(units + n * kD + (dy % kP) * kP + dx % kP);
    }
  }
  return sum;
}

}  // namespace gmm
