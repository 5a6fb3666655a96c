// Pair-packed linear convolution by a two-stage matrix DFT on Hopper
// (sm_90a), in full float32. Built by nvcc into a shared library with a
// plain C interface and loaded with ctypes (jolideco_torch/utils/
// cuda_build.py); the Python wrappers, the autograd rule and the plain
// PyTorch version are in jolideco_torch/ops/pallas_fft.py.
//
// For P pairs of real (H, W) images (H, W multiples of 128) and a
// transform size n = 128 m, it computes y0 = x0 * k0 and y1 = x1 * k1,
// cropped to (H, W), through one complex transform of z = x0 + i x1:
//     y0 + i y1 = IFFT2(A . Z) + FWDP2(B2 . conj(Z)),   Z = FFT2(z),
// with the spectra A = (K0 + K1)/2 and B2 (the frequency-reversed
// (K0 - K1)/2) given in the permuted order: storage position 128 k2 + k1
// holds frequency m k1 + k2. Each 1-D transform factors into stage A, an
// m-point DFT over the 128-strided blocks (n2 -> k2), and stage B, m
// complex products with 128 x 128 matrices that carry the size-n
// twiddles (mf, mi; mi holds the 1/n). The inverse runs stage B first and
// stage A on its outputs. FWDP is the inverse with conjugate matrices and
// conjugate stage-A weights. With conj_spec the imaginary parts of A and
// B2 change sign: that is the adjoint (a correlation).
//
// ---------------------------------------------------------------------
// Three kernels, one per pass over device memory, as the three TPU
// bodies of the JAX package's ops/pallas_fft.py:
//
// pfft_cols_fwd_kernel replaces _k1_body: for each column, the axis-0
//     forward of z into permuted rows, U (P, n, W) complex. One block per
//     (pair, k2, 32 columns): stage A folded into the operand load, then
//     U[k2 block] = mf[k2]^T S.
// pfft_rows_kernel replaces _k2_body: for each row of U, the lane-axis
//     forward Z (stage A in the operand load, then S mf[k2]), the combine
//     A . Z and conj(B2) . Z in that product's epilogue, then the lane
//     inverse of both against mi[k2]; stage A of the inverse runs in the
//     epilogue, adding w_a,k2 G into V1 and conj(w_a,k2 G) into V2 for
//     the output blocks a < W / 128 (columns beyond W are never formed).
//     One block per (pair, 16 rows), a loop over k2 inside; V1 and V2
//     (P, n, W) complex are read, added to and written by the thread
//     that owns each element, once per k2 (they stay in L2 between
//     iterations).
// pfft_cols_inv_kernel replaces _k3_body: per column, the axis-0 inverse
//     of V1 plus the permuted forward of V2, rows cropped to H. Since y0
//     is the real part and y1 the imaginary part,
//         y0 = Re(sum_k2 w_a,k2 mi[k2]^T (V1 + conj V2)),
//         y1 = Im(sum_k2 w_a,k2 mi[k2]^T (V1 - conj V2)),
//     one product per k2 whose right operand is [V1 + conj V2 | V1 -
//     conj V2]; its epilogue adds into y0 or y1. One block per (pair, 16
//     columns), a loop over k2 inside, as in pfft_rows_kernel.
//
// What bounds them on the H100: operations. Counted as the TPU kernel
// does them (3 real products per complex one, 98,304 flop per 128-vector
// and matrix), a direction at P = 5 pairs of 1024^2, n = 1152 is 29 GFLOP
// (0.43 ms at the 67 TFLOP/s fp32 peak) against about 0.48 GB of
// traffic (0.14 ms at 3.35 TB/s). This first version does 4 real
// products per complex one on the fp32 CUDA cores: every stage-B product
// is a tiled complex GEMM over a depth of 128 with the 128 x 128 matrix
// (128 KB) and the operand in shared memory, each thread a tile of 4 (or
// 2) rows by 4 columns in registers. A thread's columns are Nc/4 apart,
// so that neighbouring threads read neighbouring float2 of the operand
// (no bank conflicts); the matrix row is read by all threads of a warp
// at once (a broadcast). One block per SM (160-178 KB of shared memory).
// Tiles go to threads round-robin and no register state outlives a
// barrier, so the result does not depend on the block size. The TPU's
// 128-lane stage split is kept (it is the factorisation); its VMEM strip
// scratch and chunk sizes are not. On an NVIDIA H100 80GB HBM3 (700 W
// limit), 5 pairs of 1024^2, n = 1152 (chip_smoke.py phase 2): pass 1
// 0.36 ms, pass 2 2.12 ms, pass 3 1.39 ms, a direction 3.92 ms (11% of
// the bound; cuFFT's packed pair 0.57 ms); 72-77 registers, no spills.

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;          // stage-B block: transform sizes are 128 m
constexpr int kThreads = 256;
constexpr int kColsFwd = 32;        // columns per block, pfft_cols_fwd_kernel
constexpr int kColsInv = 16;        // columns per block, pfft_cols_inv_kernel
constexpr int kRows = 16;           // rows per block, pfft_rows_kernel
constexpr int kLdS = kRows + 1;     // padded strides of the transposed
constexpr int kLdU = 2 * kRows + 1; // operands (fewer bank conflicts)
constexpr int kMat = kLane * kLane;

constexpr int kSmemColsFwd = (kMat + kLane * kColsFwd) * sizeof(float2);
constexpr int kSmemRows = (kMat + kLane * (kLdS + kLdU)) * sizeof(float2);
constexpr int kSmemColsInv = (kMat + kLane * 2 * kColsInv) * sizeof(float2);

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 conj2(float2 a) {
  return make_float2(a.x, -a.y);
}

// dst[0 : 128 * 128] = src[0 : 128 * 128], complex, by the whole block.
__device__ __forceinline__ void load_matrix(float2* dst,
                                            const float2* __restrict__ src) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(dst);
  for (int i = threadIdx.x; i < kMat / 2; i += blockDim.x) d[i] = s[i];
}

// C = A B for complex A (M x 128) and B (128 x Nc) in shared memory, A
// transposed (at[k * lda + i] = A[i][k]), B row-major (b[k * ldb + j]).
// Tile t covers rows i0 .. i0 + TM - 1 and columns jt + q * cs (q < 4,
// cs = Nc / 4); epi(i0, jt, cs, acc) takes it. M is a multiple of TM and
// Nc of 4.
template <int TM, class Epi>
__device__ __forceinline__ void cgemm128(const float2* __restrict__ at,
                                         int lda,
                                         const float2* __restrict__ b,
                                         int ldb, int M, int Nc, Epi epi) {
  const int cs = Nc / 4;
  const int n_tiles = (M / TM) * cs;
  for (int t = threadIdx.x; t < n_tiles; t += blockDim.x) {
    const int i0 = (t / cs) * TM;
    const int jt = t % cs;
    float2 acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] = make_float2(0.f, 0.f);
    }
    const float2* ap = at + i0;
    const float2* bp = b + jt;
#pragma unroll 4
    for (int k = 0; k < kLane; ++k) {
      float2 av[TM], bv[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = ap[k * lda + i];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = bp[k * ldb + q * cs];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[i][q].x = fmaf(av[i].x, bv[q].x,
                             fmaf(-av[i].y, bv[q].y, acc[i][q].x));
          acc[i][q].y = fmaf(av[i].x, bv[q].y,
                             fmaf(av[i].y, bv[q].x, acc[i][q].y));
        }
      }
    }
    epi(i0, jt, cs, acc);
  }
}

// ---------------------------------------------------------------------
// pass 1: axis-0 forward, natural rows -> permuted rows

__global__ void __launch_bounds__(kThreads)
pfft_cols_fwd_kernel(const float* __restrict__ x0,
                     const float* __restrict__ x1, int P, int H, int W,
                     int m, const float2* __restrict__ mf,
                     const float2* __restrict__ wf, float2* __restrict__ u) {
  const int tiles = W / kColsFwd;
  int bid = blockIdx.x;
  if (bid >= P * m * tiles) return;
  const int c0 = (bid % tiles) * kColsFwd;
  bid /= tiles;
  const int k2 = bid % m;
  const int p = bid / m;
  const int n = kLane * m;

  extern __shared__ __align__(16) float2 smem[];
  float2* mat = smem;               // mf[k2] as [n1][k1]
  float2* opnd = smem + kMat;       // stage A as [n1][c]
  load_matrix(mat, mf + (size_t)k2 * kMat);
  const size_t base = (size_t)p * H * W + c0;
  for (int e = threadIdx.x; e < kLane * kColsFwd; e += blockDim.x) {
    const int n1 = e / kColsFwd, c = e % kColsFwd;
    float sr = 0.f, si = 0.f;
    for (int n2 = 0; n2 < H / kLane; ++n2) {
      const float2 w = wf[n2 * m + k2];
      const size_t off = base + (size_t)(kLane * n2 + n1) * W + c;
      const float xr = x0[off], xi = x1[off];
      sr = fmaf(w.x, xr, fmaf(-w.y, xi, sr));
      si = fmaf(w.x, xi, fmaf(w.y, xr, si));
    }
    opnd[e] = make_float2(sr, si);
  }
  __syncthreads();

  float2* out = u + ((size_t)p * n + kLane * k2) * W + c0;
  cgemm128<4>(mat, kLane, opnd, kColsFwd, kLane, kColsFwd,
              [&](int i0, int jt, int cs, const float2 (&acc)[4][4]) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                  for (int q = 0; q < 4; ++q)
                    out[(size_t)(i0 + i) * W + jt + q * cs] = acc[i][q];
              });
}

// ---------------------------------------------------------------------
// pass 2: lane forward, spectrum combine, lane inverse and permuted
// forward, columns cropped to W

__global__ void __launch_bounds__(kThreads)
pfft_rows_kernel(const float2* __restrict__ u,
                 const float* __restrict__ a_re,
                 const float* __restrict__ a_im,
                 const float* __restrict__ b_re,
                 const float* __restrict__ b_im, int P, int W, int m,
                 float asign, const float2* __restrict__ mf,
                 const float2* __restrict__ mi,
                 const float2* __restrict__ wf,
                 const float2* __restrict__ wi, float2* __restrict__ v1,
                 float2* __restrict__ v2) {
  const int n = kLane * m;
  const int strips = n / kRows;
  const int bid = blockIdx.x;
  if (bid >= P * strips) return;
  const int r0 = (bid % strips) * kRows;
  const int p = bid / strips;
  const int wb = W / kLane;

  extern __shared__ __align__(16) float2 smem[];
  float2* mat = smem;                // mf[k2] or mi[k2]
  float2* st = smem + kMat;          // stage A as [n1][r]
  float2* ut = st + kLane * kLdS;    // [k1][row]: A.Z rows, then conj(B2).Z
  const size_t row0 = (size_t)p * n + r0;
  const float2* urow = u + row0 * W;
  float2* v1row = v1 + row0 * W;
  float2* v2row = v2 + row0 * W;

  for (int k2 = 0; k2 < m; ++k2) {
    __syncthreads();  // the previous k2 is done with mat and ut
    load_matrix(mat, mf + (size_t)k2 * kMat);
    for (int e = threadIdx.x; e < kLane * kRows; e += blockDim.x) {
      const int n1 = e % kLane, r = e / kLane;
      float2 s = make_float2(0.f, 0.f);
      for (int n2 = 0; n2 < wb; ++n2) {
        const float2 w = wf[n2 * m + k2];
        const float2 x = urow[(size_t)r * W + kLane * n2 + n1];
        s.x = fmaf(w.x, x.x, fmaf(-w.y, x.y, s.x));
        s.y = fmaf(w.x, x.y, fmaf(w.y, x.x, s.y));
      }
      st[n1 * kLdS + r] = s;
    }
    __syncthreads();

    // Z = S mf[k2]; then A . Z and conj(B2) . Z
    cgemm128<2>(st, kLdS, mat, kLane, kRows, kLane,
                [&](int i0, int jt, int cs, const float2 (&acc)[2][4]) {
#pragma unroll
                  for (int i = 0; i < 2; ++i) {
                    const int r = i0 + i;
                    const size_t spec = (row0 + r) * n + kLane * k2;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                      const int k1 = jt + q * cs;
                      const float2 a = make_float2(
                          a_re[spec + k1], asign * a_im[spec + k1]);
                      const float2 bc = make_float2(
                          b_re[spec + k1], -asign * b_im[spec + k1]);
                      ut[k1 * kLdU + r] = cmul(a, acc[i][q]);
                      ut[k1 * kLdU + kRows + r] = cmul(bc, acc[i][q]);
                    }
                  }
                });
    __syncthreads();
    load_matrix(mat, mi + (size_t)k2 * kMat);
    __syncthreads();

    // G = [A.Z; conj(B2).Z] mi[k2]; V1 += w G, V2 += conj(w G)
    cgemm128<4>(ut, kLdU, mat, kLane, 2 * kRows, kLane,
                [&](int i0, int jt, int cs, const float2 (&acc)[4][4]) {
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    const int row = i0 + i;
                    const bool second = row >= kRows;
                    float2* dst = second ? v2row + (size_t)(row - kRows) * W
                                         : v1row + (size_t)row * W;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                      const int b = jt + q * cs;
                      for (int a = 0; a < wb; ++a) {
                        float2 val = cmul(wi[a * m + k2], acc[i][q]);
                        if (second) val = conj2(val);
                        float2* d = dst + kLane * a + b;
                        if (k2 > 0) {
                          const float2 old = *d;
                          val.x += old.x;
                          val.y += old.y;
                        }
                        *d = val;
                      }
                    }
                  }
                });
  }
}

// ---------------------------------------------------------------------
// pass 3: axis-0 inverse (V1) plus permuted forward (V2), rows cropped
// to H

__global__ void __launch_bounds__(kThreads)
pfft_cols_inv_kernel(const float2* __restrict__ v1,
                     const float2* __restrict__ v2, int P, int H, int W,
                     int m, const float2* __restrict__ mi,
                     const float2* __restrict__ wi, float* __restrict__ y0,
                     float* __restrict__ y1) {
  const int tiles = W / kColsInv;
  const int bid = blockIdx.x;
  if (bid >= P * tiles) return;
  const int c0 = (bid % tiles) * kColsInv;
  const int p = bid / tiles;
  const int n = kLane * m;
  constexpr int kLdB = 2 * kColsInv;

  extern __shared__ __align__(16) float2 smem[];
  float2* mat = smem;               // mi[k2] as [k1][b]
  float2* opnd = smem + kMat;       // [k1][V1 + conj V2 | V1 - conj V2]
  const size_t out0 = (size_t)p * H * W + c0;

  for (int k2 = 0; k2 < m; ++k2) {
    __syncthreads();  // the previous k2 is done with mat and opnd
    load_matrix(mat, mi + (size_t)k2 * kMat);
    const size_t in0 = ((size_t)p * n + kLane * k2) * W + c0;
    for (int e = threadIdx.x; e < kLane * kColsInv; e += blockDim.x) {
      const int k1 = e / kColsInv, c = e % kColsInv;
      const float2 a = v1[in0 + (size_t)k1 * W + c];
      const float2 b = v2[in0 + (size_t)k1 * W + c];
      opnd[k1 * kLdB + c] = make_float2(a.x + b.x, a.y - b.y);
      opnd[k1 * kLdB + kColsInv + c] = make_float2(a.x - b.x, a.y + b.y);
    }
    __syncthreads();

    cgemm128<4>(mat, kLane, opnd, kLdB, kLane, kLdB,
                [&](int i0, int jt, int cs, const float2 (&acc)[4][4]) {
#pragma unroll
                  for (int i = 0; i < 4; ++i) {
                    const int b = i0 + i;
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                      const int col = jt + q * cs;
                      const bool imag = col >= kColsInv;
                      float* y = imag ? y1 : y0;
                      const size_t at = out0 + (size_t)b * W
                                        + (imag ? col - kColsInv : col);
                      for (int a = 0; a < H / kLane; ++a) {
                        const float2 val = cmul(wi[a * m + k2], acc[i][q]);
                        float* d = y + at + (size_t)kLane * a * W;
                        const float part = imag ? val.y : val.x;
                        *d = k2 > 0 ? *d + part : part;
                      }
                    }
                  }
                });
  }
}

int finish(cudaError_t attr) {
  const cudaError_t launch = cudaGetLastError();
  return (int)(attr != cudaSuccess ? attr : launch);
}

}  // namespace

extern "C" {

int pfft_cols_fwd(const float* x0, const float* x1, int P, int H, int W,
                  int m, const float2* mf, const float2* wf, float2* u,
                  cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      pfft_cols_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemColsFwd);
  const int blocks = P * m * (W / kColsFwd);
  pfft_cols_fwd_kernel<<<blocks, kThreads, kSmemColsFwd, stream>>>(
      x0, x1, P, H, W, m, mf, wf, u);
  return finish(attr);
}

int pfft_rows(const float2* u, const float* a_re, const float* a_im,
              const float* b_re, const float* b_im, int P, int W, int m,
              int conj_spec, const float2* mf, const float2* mi,
              const float2* wf, const float2* wi, float2* v1, float2* v2,
              cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      pfft_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemRows);
  const int blocks = P * (kLane * m / kRows);
  const float asign = conj_spec ? -1.f : 1.f;
  pfft_rows_kernel<<<blocks, kThreads, kSmemRows, stream>>>(
      u, a_re, a_im, b_re, b_im, P, W, m, asign, mf, mi, wf, wi, v1, v2);
  return finish(attr);
}

int pfft_cols_inv(const float2* v1, const float2* v2, int P, int H, int W,
                  int m, const float2* mi, const float2* wi, float* y0,
                  float* y1, cudaStream_t stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      pfft_cols_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemColsInv);
  const int blocks = P * (W / kColsInv);
  pfft_cols_inv_kernel<<<blocks, kThreads, kSmemColsInv, stream>>>(
      v1, v2, P, H, W, m, mi, wi, y0, y1);
  return finish(attr);
}

const char* pfft_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
