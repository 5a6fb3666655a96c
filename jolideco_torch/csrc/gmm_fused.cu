// Fused patch extraction + GMM MAP scoring on Hopper (sm_90a), forward
// and MAP backward, in full float32. Built by nvcc into a shared library
// with a plain C interface and loaded with ctypes
// (jolideco_torch/utils/cuda_build.py); the Python wrappers and the plain
// PyTorch versions of both kernels are in jolideco_torch/ops/gmm_fused.py.
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
// gmm_fwd_kernel replaces the JAX package's ops/gmm_fused.py::_fwd_kernel
// (MAP branch). Per patch: load, mask, subtract the mean, then
//     logit_k = -1/2 x^T A_k x + b_k . x + c_k
// over all K components, keeping the running maximum and the LOWEST
// index among equal maxima (the TPU kernel's min-index argmax).
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
// and patch give the FMA pipe independent chains. At 1024², K = 200 on
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

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kP = 8;     // patch edge
constexpr int kD = 64;    // features per patch
constexpr int kSym = 2176;             // floats of the row-padded triangle
constexpr int kRec = kSym + kD + 4;    // A_sym, b, c and 3 pad floats
constexpr int kFwdThreads = 128;
constexpr int kPPT = 2;               // patches per forward thread
constexpr int kBwdThreads = 128;

// Offset of row r in the row-padded upper triangle: rows come in groups
// of four of equal length 64 - 4m, m = r / 4.
__host__ __device__ constexpr int sym_row_offset(int r) {
  return 4 * (64 * (r / 4) - 2 * (r / 4) * (r / 4 - 1)) +
         (r % 4) * (64 - 4 * (r / 4));
}
static_assert(sym_row_offset(64) == kSym, "triangle size");
static_assert(kRec % 4 == 0, "records are read as float4");

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

__device__ __forceinline__ void load_record(float* dst,
                                            const float* __restrict__ rec,
                                            int k) {
  const float4* src = reinterpret_cast<const float4*>(rec + (size_t)k * kRec);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int t = threadIdx.x; t < kRec / 4; t += blockDim.x) d4[t] = __ldg(src + t);
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

// Each thread scores kPPT patches, n = (blockIdx.x * kPPT + p) *
// blockDim.x + threadIdx.x, so that every float4 of A read from shared
// memory feeds kPPT * 4 multiply-adds.
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

  float best[kPPT];
  int best_k[kPPT];
#pragma unroll
  for (int p = 0; p < kPPT; ++p) {
    best[p] = -CUDART_INF_F;
    best_k[p] = 0;
  }
  for (int k = 0; k < K; ++k) {
    const float* cur = smem[k & 1];
    if (k + 1 < K) load_record(smem[(k + 1) & 1], rec, k + 1);

    float q[kPPT];
#pragma unroll
    for (int p = 0; p < kPPT; ++p) q[p] = 0.f;
#pragma unroll
    for (int r = 0; r < kD; ++r) {
      const int c0 = r & ~3;
      const float4* row = reinterpret_cast<const float4*>(cur + sym_row_offset(r));
      float t[kPPT][4];
#pragma unroll
      for (int p = 0; p < kPPT; ++p) t[p][0] = t[p][1] = t[p][2] = t[p][3] = 0.f;
#pragma unroll
      for (int c = c0; c < kD; c += 4) {
        const float4 u = row[(c - c0) / 4];
#pragma unroll
        for (int p = 0; p < kPPT; ++p) {
          t[p][0] = fmaf(u.x, x[p][c], t[p][0]);
          t[p][1] = fmaf(u.y, x[p][c + 1], t[p][1]);
          t[p][2] = fmaf(u.z, x[p][c + 2], t[p][2]);
          t[p][3] = fmaf(u.w, x[p][c + 3], t[p][3]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPPT; ++p)
        q[p] = fmaf(x[p][r], (t[p][0] + t[p][1]) + (t[p][2] + t[p][3]), q[p]);
    }

    const float4* bv = reinterpret_cast<const float4*>(cur + kSym);
    float s[kPPT][4];
#pragma unroll
    for (int p = 0; p < kPPT; ++p) s[p][0] = s[p][1] = s[p][2] = s[p][3] = 0.f;
#pragma unroll
    for (int c = 0; c < kD; c += 4) {
      const float4 u = bv[c / 4];
#pragma unroll
      for (int p = 0; p < kPPT; ++p) {
        s[p][0] = fmaf(u.x, x[p][c], s[p][0]);
        s[p][1] = fmaf(u.y, x[p][c + 1], s[p][1]);
        s[p][2] = fmaf(u.z, x[p][c + 2], s[p][2]);
        s[p][3] = fmaf(u.w, x[p][c + 3], s[p][3]);
      }
    }
    const float c_k = cur[kSym + kD];
#pragma unroll
    for (int p = 0; p < kPPT; ++p) {
      const float logit =
          fmaf(-0.5f, q[p], ((s[p][0] + s[p][1]) + (s[p][2] + s[p][3])) + c_k);
      if (logit > best[p]) {
        best[p] = logit;
        best_k[p] = k;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kPPT; ++p) {
    if (n[p] < n_total) {
      values[n[p]] = best[p];
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
  const float4* src = reinterpret_cast<const float4*>(xtn + (size_t)n * kD);
#pragma unroll
  for (int c = 0; c < kD; c += 4) {
    const float4 v = __ldg(src + c / 4);
    x[c] = v.x;
    x[c + 1] = v.y;
    x[c + 2] = v.z;
    x[c + 3] = v.w;
  }

  const float4* A = reinterpret_cast<const float4*>(a_full + (size_t)k * kD * kD);
  const float* bk = b_rows + (size_t)k * kD;
  float u[kD];
  float sum = 0.f;
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
    sum += u[r];
  }
  const float mean = sum * (1.f / kD);

  const PatchPos p = patch_pos(n, H, W, stride, ny, nx);
  float* dst = planes + (size_t)p.g * H * W + (size_t)(p.a + kP * p.i) * W +
               (p.b + kP * p.j);
#pragma unroll
  for (int dy = 0; dy < kP; ++dy) {
#pragma unroll
    for (int dx = 0; dx < kP; ++dx) dst[(size_t)dy * W + dx] = u[dy * kP + dx] - mean;
  }
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int gmm_fused_fwd(const void* img, int H, int W, int stride, int ny, int nx,
                  float sentinel, const void* rec, int K, void* values,
                  void* argmax, void* valid, void* xtn, void* stream) {
  const int groups = (kP / stride) * (kP / stride);
  const int n_total = groups * ny * nx;
  const int blocks = (n_total + kFwdThreads * kPPT - 1) / (kFwdThreads * kPPT);
  gmm_fwd_kernel<<<blocks, kFwdThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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

const char* gmm_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
