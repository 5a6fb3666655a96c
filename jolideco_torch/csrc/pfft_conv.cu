// Pass 2 of the pair-packed linear convolution by a two-stage matrix DFT
// on Hopper (sm_90a), in full float32 (the precision dial's "f32" mode,
// the "highest" setting). Built by nvcc into a shared library with a
// plain C interface and loaded with ctypes (jolideco_torch/utils/
// cuda_build.py); the Python wrappers, the autograd rule and the plain
// PyTorch version are in jolideco_torch/ops/pallas_fft.py. Passes 1 and
// 3 of the same mode run on the tensor cores (pfft_conv_wg.cu's
// pfft_cols_fwd_f32_kernel and pfft_cols_inv_f32_kernel).
//
// For P pairs of real (H, W) images (H, W multiples of 128) and a
// transform size n = 128 m, the three passes compute y0 = x0 * k0 and
// y1 = x1 * k1, cropped to (H, W), through one complex transform of z =
// x0 + i x1:
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
// pfft_rows_kernel replaces _k2_body of the JAX package's
//     ops/pallas_fft.py: for each row of U (P, n, W) complex, the
//     lane-axis forward Z (stage A in the operand load, then S mf[k2]),
//     the combine A . Z and conj(B2) . Z in that product's epilogue, then
//     the lane inverse of both against mi[k2]; stage A of the inverse
//     runs in the epilogue, adding w_a,k2 G into V1 and conj(w_a,k2 G)
//     into V2 for the output blocks a < W / 128 (columns beyond W are
//     never formed). One block per (pair, 16 rows), a loop over k2
//     inside; V1 and V2 (P, n, W) complex are read, added to and written
//     by the thread that owns each element, once per k2 (they stay in L2
//     between iterations).
//
// What bounds it on the H100: operations. Counted as the TPU kernel
// does them (3 real products per complex one, 98,304 flop per 128-vector
// and matrix), 3 m products per row: 0.23 ms at the 67 TFLOP/s fp32 peak
// at P = 5 pairs of 1024^2, n = 1152. This first version does 4 real
// products per complex one on the fp32 CUDA cores: every stage-B product
// is a tiled complex GEMM over a depth of 128 with the 128 x 128 matrix
// (128 KB) and the operand in shared memory, each thread a tile of 4 (or
// 2) rows by 4 columns in registers. A thread's columns are Nc/4 apart,
// so that neighbouring threads read neighbouring float2 of the operand
// (no bank conflicts); the matrix row is read by all threads of a warp
// at once (a broadcast). One block per SM (178 KB of shared memory).
// Tiles go to threads round-robin and no register state outlives a
// barrier, so the result does not depend on the block size. The TPU's
// 128-lane stage split is kept (it is the factorisation); its VMEM strip
// scratch and chunk sizes are not. On an NVIDIA H100 80GB HBM3 (700 W
// limit), 5 pairs of 1024^2, n = 1152 (chip_smoke.py phase 2): 2.12 ms,
// 72-77 registers, no spills.

#include <cuda_runtime.h>

namespace {

constexpr int kLane = 128;          // stage-B block: transform sizes are 128 m
constexpr int kThreads = 256;
constexpr int kRows = 16;           // rows per block, pfft_rows_kernel
constexpr int kLdS = kRows + 1;     // padded strides of the transposed
constexpr int kLdU = 2 * kRows + 1; // operands (fewer bank conflicts)
constexpr int kMat = kLane * kLane;

constexpr int kSmemRows = (kMat + kLane * (kLdS + kLdU)) * sizeof(float2);

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

int finish(cudaError_t attr) {
  const cudaError_t launch = cudaGetLastError();
  return (int)(attr != cudaSuccess ? attr : launch);
}

}  // namespace

extern "C" {

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

const char* pfft_conv_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
