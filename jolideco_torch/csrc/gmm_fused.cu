// The MAP backward of the fused GMM scorer on Hopper (sm_90a), K2, which
// reads no logit and so serves every mode of the precision dial. The
// forwards and the marginalise backward of every mode are
// gmm_score_wg.cu's (wgmma). Built by nvcc into a shared library with a
// plain C interface and loaded with ctypes
// (jolideco_torch/utils/cuda_build.py); the Python wrapper and the plain
// PyTorch version are in jolideco_torch/ops/gmm_fused.py.
//
// Patch enumeration (every fused kernel). For stride s the patches fall into
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
// gmm_bwd_kernel and gmm_bwd_add_kernel replace the JAX package's
// ops/gmm_fused.py::_bwd_kernel, two launches of one C entry point. Per
// valid patch with argmax k* and cotangent dv:
//     u = dv · (b_{k*} - A_{k*} x),  u -= mean(u)
// (the transpose of the mean subtraction; invalid patches have zero
// gradient), then the overlap-add of every offset group's patches into
// the (H, W) image gradient.
//
// What bounds it: operations, 64·64 multiply-adds per valid patch (0.0080
// ms at 1024²); the bytes (xtn once, the components used once, the
// gradient) are about as many. One thread per patch, each reading its
// own A_{k*} (16 KB) at an address its neighbours do not share, read
// about 1 GB a call from the caches; with the zero-filled planes and
// their sum that took 0.113-0.121 ms on an NVIDIA H100 80GB HBM3 (700 W
// limit). Design:
// - gmm_bwd_kernel: one block per tile of kBwdTile consecutive patches.
//   The tile's live patches are put in (k*, patch) order in shared
//   memory (each patch's rank among the tile's keys: no sort, no
//   atomics), their rows transposed into x^T by that order (coalesced
//   reads). A_{k*} less its column means, transposed, and b less its
//   mean (a_bwd, b_bwd, made once per GMM by
//   ops/gmm_fused.py::kernel_buffers) make dv ((b - mean b) - (A -
//   colmean A) x) u - mean(u) with no reduction over a patch's u. Each
//   half-warp takes 8 places of that order, run by run, each thread 4
//   rows of their u, reading its rows of A'^T as float4s (a half-warp
//   reads a run's A' once, the block's others from L1) and each x^T
//   value from shared memory for 4 multiply-adds. u rows go straight to
//   their patch's row of a scratch
//   (N, 64), zero for an invalid patch;
// - gmm_bwd_add_kernel: one thread per pixel sums the G groups' u
//   entries that cover it, group by group in order (the order of the
//   plain version's sum), and writes the gradient once: no zero-fill,
//   no float atomics, the same bits every run.
// No count goes back to the host: both grids follow from the shapes.
// No barrier separates one run from the next: a run costs only its
// half-warps a pass over A'. Runs staged in shared memory by the whole
// block, two barriers a run, took 0.63 ms where every tile's patches
// select 128 components (0.32 for the one-thread-per-patch kernel; 0.19
// now), and 0.046 ms where they select one (now 0.043): device time at
// 1024², NVIDIA H100 80GB HBM3 (700 W limit),
// scripts/torch_k2_pass1_times.py. A run boundary inside a half-warp's
// 8 places costs it a second pass, so a random image (1.09 components a
// tile) takes 0.060 ms.

#include <cuda_runtime.h>
#include <math_constants.h>

#include "gmm_patches.cuh"

namespace {

using gmm::kD;
using gmm::kP;

constexpr int kBwdThreads = 256;
constexpr int kBwdTile = 128;  // patches per backward block
// half-warp h of the block takes places [kSeg h, kSeg (h + 1)) of the
// tile's (k*, patch) order, a thread four rows of their u
constexpr int kSeg = kBwdTile / (kBwdThreads / 16);
constexpr int kLdX = kBwdTile + kSeg + 1;  // x^T row: odd, room past the last place
constexpr int kAddThreads = 256;
static_assert(kSeg == 8 && kD == 64, "a half-warp's 16 threads cover a u row");

// a_bwd (K, 64, 64): A_k less its column means, transposed ([c][r]);
// b_bwd (K, 64): b_k less its mean. Then dv (b_bwd - a_bwd^T x) is
// u - mean(u), with no reduction over a patch's u.
__global__ void __launch_bounds__(kBwdThreads)
gmm_bwd_kernel(const float* __restrict__ xtn, const int* __restrict__ argmax,
               const float* __restrict__ valid, const float* __restrict__ dvalues,
               const float* __restrict__ a_bwd, const float* __restrict__ b_bwd,
               int n_total, float* __restrict__ units) {
  __shared__ __align__(16) float xt[kD * kLdX];  // [c][place]: live patches
  __shared__ float dv[kBwdTile];
  __shared__ int key[kBwdTile];      // k*, or -1: invalid
  __shared__ int rank[kBwdTile];     // a live patch's place in (k*, q) order
  __shared__ int order[kBwdTile];    // the patch at each place
  __shared__ int run_end[kBwdTile];  // the end of each place's run of k*

  const int n0 = blockIdx.x * kBwdTile;
  if (n0 >= n_total) return;
  const int count = n_total - n0 < kBwdTile ? n_total - n0 : kBwdTile;
  for (int q = threadIdx.x; q < kBwdTile; q += blockDim.x) {
    const int n = n0 + (q < count ? q : 0);
    const float ok = __ldg(valid + n);
    const int k = __ldg(argmax + n);
    const float d = __ldg(dvalues + n);
    const bool live = q < count && ok != 0.f;
    key[q] = live ? k : -1;
    dv[q] = d;
  }
  __syncthreads();

  // each live patch's rank in (k*, q) order, and where its run ends
  for (int q = threadIdx.x; q < kBwdTile; q += blockDim.x) {
    const int k = key[q];
    if (k < 0) continue;
    int upto = 0, place = 0;
    for (int j = 0; j < kBwdTile; ++j) {
      const int kj = key[j];
      upto += kj >= 0 && kj <= k;
      place += kj >= 0 && (kj < k || (kj == k && j < q));
    }
    rank[q] = place;
    order[place] = q;
    run_end[place] = upto;
  }
  __syncthreads();

  // x^T of the live patches by rank, from coalesced float4 reads, kLoads
  // of a thread in flight together; an invalid patch's u row is zero
  constexpr int kLoads = kBwdTile * kD / 4 / kBwdThreads;
  const float4* x4 = reinterpret_cast<const float4*>(xtn + (size_t)n0 * kD);
  float4* u4 = reinterpret_cast<float4*>(units + (size_t)n0 * kD);
  for (int e0 = threadIdx.x; e0 < count * kD / 4;
       e0 += kLoads * blockDim.x) {
    float4 v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e < count * kD / 4) v[i] = __ldg(x4 + e);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = e0 + i * blockDim.x;
      if (e >= count * kD / 4) break;
      const int q = e / (kD / 4), c = 4 * (e % (kD / 4));
      if (key[q] < 0) {
        u4[e] = make_float4(0.f, 0.f, 0.f, 0.f);
        continue;
      }
      float* dst = xt + c * kLdX + rank[q];
      dst[0] = v[i].x;
      dst[kLdX] = v[i].y;
      dst[2 * kLdX] = v[i].z;
      dst[3 * kLdX] = v[i].w;
    }
  }
  int live = 0;
  for (int j = 0; j < kBwdTile; ++j) live += key[j] >= 0;
  __syncthreads();

  // thread t: half-warp h = t / 16 takes the places of its segment run
  // by run, the patches j + i (i < kSeg) of the run from place j, rows
  // r0 .. r0 + 3 of their u (r0 = 4 (t % 16)), reading those rows of
  // A_{k*}'^T from the caches. No barrier between runs: a half-warp's
  // runs do not wait for the others'.
  for (int t = threadIdx.x; t < kBwdThreads; t += blockDim.x) {
    const int seg = t / 16, r0 = 4 * (t % 16);
    const int seg_end = kSeg * (seg + 1) < live ? kSeg * (seg + 1) : live;
    for (int j = kSeg * seg; j < seg_end;) {
      const int k = key[order[j]];
      const int j0 = j;
      const int end = run_end[j] < seg_end ? run_end[j] : seg_end;
      j = end;
      const float* ak = a_bwd + (size_t)k * kD * kD + r0;
      float acc[kSeg][4];
#pragma unroll
      for (int i = 0; i < kSeg; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 8
      for (int c = 0; c < kD; ++c) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(ak + c * kD));
#pragma unroll
        for (int i = 0; i < kSeg; ++i) {
          const float x = xt[c * kLdX + j0 + i];
          acc[i][0] = fmaf(a.x, x, acc[i][0]);
          acc[i][1] = fmaf(a.y, x, acc[i][1]);
          acc[i][2] = fmaf(a.z, x, acc[i][2]);
          acc[i][3] = fmaf(a.w, x, acc[i][3]);
        }
      }
      const float4 b =
          __ldg(reinterpret_cast<const float4*>(b_bwd + (size_t)k * kD + r0));
#pragma unroll
      for (int i = 0; i < kSeg; ++i) {
        if (j0 + i >= end) break;
        const int q = order[j0 + i];
        const float d = dv[q];
        reinterpret_cast<float4*>(units + (size_t)(n0 + q) * kD + r0)[0] =
            make_float4(d * (b.x - acc[i][0]), d * (b.y - acc[i][1]),
                        d * (b.z - acc[i][2]), d * (b.w - acc[i][3]));
      }
    }
  }
}

// One thread per pixel (gmm_patches.cuh's patch_units_at).
__global__ void __launch_bounds__(kAddThreads)
gmm_bwd_add_kernel(const float* __restrict__ units, int H, int W, int stride,
                   int ny, int nx, float* __restrict__ grad) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= H * W) return;
  const int y = pix / W;
  grad[pix] = gmm::patch_units_at(units, y, pix - y * W, stride, ny, nx);
}

}  // namespace

extern "C" {

// units: scratch (N, 64) float32; grad: the (H, W) image gradient.
// Returns cudaGetLastError() after the launches (0 = cudaSuccess).
int gmm_fused_bwd(const void* xtn, const void* argmax, const void* valid,
                  const void* dvalues, const void* a_bwd, const void* b_bwd,
                  int H, int W, int stride, int ny, int nx, void* units,
                  void* grad, void* stream) {
  const int groups = (kP / stride) * (kP / stride);
  const int n_total = groups * ny * nx;
  const int blocks = (n_total + kBwdTile - 1) / kBwdTile;
  gmm_bwd_kernel<<<blocks, kBwdThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xtn), static_cast<const int*>(argmax),
      static_cast<const float*>(valid), static_cast<const float*>(dvalues),
      static_cast<const float*>(a_bwd), static_cast<const float*>(b_bwd),
      n_total, static_cast<float*>(units));
  const int pixel_blocks = (H * W + kAddThreads - 1) / kAddThreads;
  gmm_bwd_add_kernel<<<pixel_blocks, kAddThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(units), H, W, stride, ny, nx,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

const char* gmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
