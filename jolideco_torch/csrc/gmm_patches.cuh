// Offset-group patches of an image, as the fused image-level scorers
// read them (gmm_score_wg.cu) and their backwards write them back
// (gmm_fused.cu's K2, gmm_score_wg.cu's K4). The enumeration is stated at
// the top of gmm_fused.cu.

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
