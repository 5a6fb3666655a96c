// Pass 1 of the pair-packed matrix-DFT convolution on Hopper's tensor
// cores (sm_90a), in the precision dial's "split" and "bf16" modes. Built
// by nvcc into a shared library with a plain C interface and loaded with
// ctypes (jolideco_torch/utils/cuda_build.py); the wrappers, the
// dispatch by mode and the plain PyTorch version (mode="split",
// mode="bf16") are in jolideco_torch/ops/pallas_fft.py, whose docstring
// and pfft_conv_wg.cu's header state the algorithm. Passes 2 and 3 of
// these modes, and the three passes of the "f32" mode, run on
// pfft_conv_wg.cu's wgmma kernels. The kernel is a template over kProd,
// the bf16 products a k16 step: 3 for "split", 1 for "bf16".
//
// "split" is the JAX package's _dot in split mode: both operands of each
// stage-B product split into bf16 high and low parts (hi = bf16(x), lo =
// bf16(x - hi), round to nearest even) and three products hi.hi + hi.lo
// + lo.hi summed in float32. A complex product x . M (x a row of 128
// complex, M a 128 x 128 stage matrix) runs as the real product of the
// row as it lies in memory, (re, im, re, im, ...), with the interleaved
// real form R (256 x 256) of M: R[2k][2j] = Re M, R[2k][2j+1] = Im M,
// R[2k+1][2j] = -Im M, R[2k+1][2j+1] = Re M. Then each accumulator pair
// (c0, c1) of an m16n8k16 mma is one complex output, and the epilogue
// works on whole complex values. That is 4 real products per complex one
// where the TPU uses Karatsuba's 3; it rounds no re + im sums.
//
// "bf16" is the JAX package's _dot in bf16 mode (the dial's "default"):
// both operands rounded to bf16, one product summed in float32. Here the
// operand is rounded into its hi plane only (put_operand), each stage
// copies the hi half of R's tile (hi = bf16(R): the split tables' hi
// planes), and each k16 step issues one mma where "split" issues three.
// The JAX package also rounds Karatsuba's sr + si to bf16; the
// interleaved form has no such sum, so its error is at most the JAX
// package's (1.3e-2 of the result's max-abs, documented).
//
// ---------------------------------------------------------------------
// pfft_cols_fwd_tc_kernel replaces _k1_body (jolideco_tpu/ops/
//     pallas_fft.py) under "split" and "bf16": per column, stage A S_k2 =
//     sum_n2 wf[n2][k2] z[128 n2 + ., c] (z = x0 + i x1) in float32, then
//     U[128 k2 : 128 (k2 + 1), c] = mf[k2]^T S_k2, run from the right:
//     the columns of S_k2 are the operand rows. Since mf[k2] is the
//     128-point DFT F = mf[0] after the twiddle Wn^(n1 k2) on its rows,
//     stage A ends with that twiddle and every k2 multiplies R(F): three
//     k2 share each streamed tile. One block per (pair, 16 columns), a
//     loop over the k2 inside; the block's columns of x0 and x1 are read
//     from device memory once, into registers.
//
// What bounds it on the H100: bytes. Counted as the TPU kernel counts
// its work (3 real products per complex one, 3 bf16 products each), pass
// 1 at 5 pairs of 1024^2, n = 1152 is 13.6 GFLOP (0.014 ms at 989
// TFLOP/s bf16) against 90 MB of traffic (0.027 ms at 3.35 TB/s). The
// design:
// - the products run as warp-level mma.sync m16n8k16 (bf16 in, float32
//   accumulate), 8 warps of a block each owning 32 of R's 256 columns;
// - R is streamed in tiles of 32 of its rows (hi and lo, 32 KB) through
//   two shared-memory stages with cp.async, the next tile loading while
//   the current one is multiplied; the tables are stored on the device
//   tile by tile (pallas_fft.tensor_core_tables), so a stage is one
//   contiguous copy, and transposed ([n][k]), the mma's column-major B;
// - the operand is split once, as it is formed by stage A, into bf16 hi
//   and lo planes in shared memory, from the same float32 values that
//   the plain version splits;
// - fragments come from shared memory with ldmatrix; rows are padded
//   (264 and 40 bf16) so that its eight 16-byte rows fall on distinct
//   banks;
// - the block keeps its input in registers (244 of them, no spills; 128
//   KB of shared memory would leave no room for its operand rows) for
//   images of up to 1024 rows: 0.157 ms at 5 pairs of 1024², where the
//   variant that re-reads it from L2 per k2 (taller images) takes 0.196
//   (scripts/torch_k2_pass1_times.py);
// - with R(mf[k2]) streamed for each k2, every block of 16 columns read
//   2.4 MB of tables from L2, 755 MB a call, and took 0.28 ms; one R(F)
//   for three k2 at a time reads a third of that.
// On an NVIDIA H100 80GB HBM3 (700 W limit), 5 pairs of 1024^2, n = 1152
// (chip_smoke.py phase 2): 0.16 ms, 17% of the split bound; the "bf16"
// instance 0.12 ms.
//
// The mma.sync kernels of passes 2 and 3 lived here until the wgmma ones
// replaced them; their times stay in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_frag.cuh"

namespace {

using tc::bf16;

constexpr int kLane = 128;                  // stage-B block
constexpr int kK = 2 * kLane;               // R is kK x kK
constexpr int kThreads = 256;               // 8 warps
constexpr int kWarpCols = kK / 8;           // R's columns per warp: 32
constexpr int kCols = 16;                   // columns per block
constexpr int kKTile = 32;                  // R's rows per stage
constexpr int kTiles = kK / kKTile;         // stages per product
constexpr int kLdB = kKTile + 8;            // padded stage row (80 B)
constexpr int kLdA = kK + 8;                // padded operand row (528 B)
constexpr int kTileElems = 2 * kK * kKTile; // hi and lo of one tile
constexpr int kStageElems = 2 * kK * kLdB;  // the same, padded
static_assert(kCols % 16 == 0, "whole m16 tiles");

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x4;
using tc::mma;
using tc::put_operand;

// One tile of R (hi and lo, [n][32] each, contiguous in device memory)
// into a stage with padded rows, by the whole block: both planes for
// three products, the hi plane for one.
template <int kProd>
__device__ __forceinline__ void load_stage(bf16* dst,
                                           const bf16* __restrict__ src) {
  constexpr int kCopies = (kProd == 3 ? kTileElems : kTileElems / 2) / 8;
  for (int c = threadIdx.x; c < kCopies; c += kThreads)
    cp_async16(dst + (c >> 2) * kLdB + (c & 3) * 8, src + c * 8);
}

// acc += A[:, k0 : k0 + 32] . R[k0 : k0 + 32, warp's 32 columns] in the
// three split products (kProd = 3) or the one product hi.hi (kProd = 1,
// whose lo planes are neither read nor written); A has MT * 16 rows
// (planes a_hi, a_lo), the stage holds the tile as [n][k] (planes b_hi,
// b_lo).
template <int MT, int kProd>
__device__ __forceinline__ void mma_tile(float (&acc)[MT][4][4],
                                         const bf16* a_hi, const bf16* a_lo,
                                         int k0, const bf16* b_hi,
                                         const bf16* b_lo) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int ks = 0; ks < kKTile; ks += 16) {
    // B fragments of the warp's 4 column tiles, two per ldmatrix.x4:
    // matrices (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7),
    // (n 8-15, k 8-15)
    uint32_t bh[2][4], bl[2][4];
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      const int nr = warp * kWarpCols + np * 16 + (lane & 7) +
                     ((lane >> 4) << 3);
      const int kc = ks + ((lane >> 3) & 1) * 8;
      ldsm_x4(bh[np], b_hi + nr * kLdB + kc);
      if constexpr (kProd == 3) ldsm_x4(bl[np], b_lo + nr * kLdB + kc);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // A fragment: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7),
      // (rows 0-7, k 8-15), (rows 8-15, k 8-15)
      uint32_t ah[4], al[4];
      const int r = mt * 16 + (lane & 15);
      const int kc = k0 + ks + (lane >> 4) * 8;
      ldsm_x4(ah, a_hi + r * kLdA + kc);
      if constexpr (kProd == 3) ldsm_x4(al, a_lo + r * kLdA + kc);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t* bhp = &bh[nt >> 1][(nt & 1) * 2];
        if constexpr (kProd == 3) {
          const uint32_t* blp = &bl[nt >> 1][(nt & 1) * 2];
          mma(acc[mt][nt], al, bhp);
          mma(acc[mt][nt], ah, blp);
        }
        mma(acc[mt][nt], ah, bhp);
      }
    }
  }
}

// One product A . R over the kTiles tiles t0 .. t0 + kTiles - 1 of the
// block's stream of T tiles (src(t) is tile t's address): each tile's
// successor is copied into the other stage while it is multiplied. The
// caller has issued tile t0 (or the stream's first tile). On return
// every warp is done with A and both stages. kProd products a k16 step.
template <int MT, int kProd, class Src>
__device__ __forceinline__ void product(float (&acc)[MT][4][4],
                                        const bf16* a_hi, const bf16* a_lo,
                                        bf16* stages, int t0, int T,
                                        Src src) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  for (int kt = 0; kt < kTiles; ++kt) {
    const int t = t0 + kt;
    if (t + 1 < T) {
      load_stage<kProd>(stages + ((t + 1) & 1) * kStageElems, src(t + 1));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t and the operand are visible to all
    const bf16* b = stages + (t & 1) * kStageElems;
    mma_tile<MT, kProd>(acc, a_hi, a_lo, kt * kKTile, b, b + kK * kLdB);
    __syncthreads();  // stage t & 1 is free for tile t + 2
  }
}

// ---------------------------------------------------------------------
// pass 1: axis-0 forward, natural rows -> permuted rows

// mf[k2][n1][k1] = W128^(n1 k1) Wn^(n1 k2): the stage matrix of k2 is
// F = mf[0] (the 128-point DFT) after the twiddle tw[k2][n1] =
// Wn^(n1 k2) on its rows. So stage A also applies the twiddle, and one
// R(F) serves every k2: kChunk k2 at a time share each streamed tile of
// it, as kChunk x kCols operand rows. A thread's share of the block's
// columns of x0 and x1 stays in its registers for images of up to
// kResidentBlocks 128-row blocks; taller ones are re-read from device
// memory (L2) per k2.
constexpr int kResidentBlocks = 8;
constexpr int kChunk = 3;
constexpr int kFwdElems = kLane * kCols / kThreads;  // (n1, c) of a thread
constexpr int kSmemColsFwd = (2 * kStageElems + 2 * kChunk * kCols * kLdA) * 2;
static_assert(kSmemColsFwd <= 232448, "pass 1 fits a block's shared memory");

template <bool kResident, int kProd>
__global__ void __launch_bounds__(kThreads, 1)
pfft_cols_fwd_tc_kernel(const float* __restrict__ x0,
                        const float* __restrict__ x1, int P, int H, int W,
                        int m, const bf16* __restrict__ rf,
                        const float2* __restrict__ wf,
                        const float2* __restrict__ tw,
                        float2* __restrict__ u) {
  const int tiles = W / kCols;
  const int bid = blockIdx.x;
  if (bid >= P * tiles) return;
  const int c0 = (bid % tiles) * kCols;
  const int p = bid / tiles;
  const int n = kLane * m;
  const int hb = H / kLane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* stages = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_hi = stages + 2 * kStageElems;  // [S'_k2^T, k2 of the chunk]
  bf16* s_lo = s_hi + kChunk * kCols * kLdA;

  // the stream: R(F)'s kTiles tiles once per chunk of k2
  const int chunks = (m + kChunk - 1) / kChunk;
  const int T = kTiles * chunks;
  auto src = [&](int t) { return rf + (size_t)(t % kTiles) * kTileElems; };
  load_stage<kProd>(stages, src(0));
  cp_async_commit();

  // a thread's elements e = threadIdx.x + i kThreads of each 128-row
  // block n2: row 128 n2 + e / kCols, column e % kCols
  const size_t in0 = (size_t)p * H * W + c0;
  auto at = [&](int n2, int i) {
    const int e = threadIdx.x + i * kThreads;
    return in0 + (size_t)(kLane * n2 + e / kCols) * W + e % kCols;
  };
  float2 z[kResident ? kResidentBlocks : 1][kFwdElems];
  if (kResident) {
#pragma unroll
    for (int n2 = 0; n2 < kResidentBlocks; ++n2)
#pragma unroll
      for (int i = 0; i < kFwdElems; ++i)
        z[n2][i] = n2 < hb ? make_float2(x0[at(n2, i)], x1[at(n2, i)])
                           : make_float2(0.f, 0.f);
  }

  for (int ch = 0; ch < chunks; ++ch) {
    // stage A, S'[n1][c] = tw[k2][n1] sum_n2 wf[n2][k2] z[128 n2 + n1][c],
    // split into operand row kk kCols + c (zero past the last k2)
    for (int kk = 0; kk < kChunk; ++kk) {
      const int k2 = kChunk * ch + kk;
      float2 s[kFwdElems];
#pragma unroll
      for (int i = 0; i < kFwdElems; ++i) s[i] = make_float2(0.f, 0.f);
      auto add = [&](float2 w, int i, float xr, float xi) {
        s[i].x = fmaf(w.x, xr, fmaf(-w.y, xi, s[i].x));
        s[i].y = fmaf(w.x, xi, fmaf(w.y, xr, s[i].y));
      };
      if (k2 < m) {
        if (kResident) {
#pragma unroll
          for (int n2 = 0; n2 < kResidentBlocks; ++n2) {
            if (n2 >= hb) break;
            const float2 w = wf[n2 * m + k2];
#pragma unroll
            for (int i = 0; i < kFwdElems; ++i)
              add(w, i, z[n2][i].x, z[n2][i].y);
          }
        } else {
          for (int n2 = 0; n2 < hb; ++n2) {
            const float2 w = wf[n2 * m + k2];
#pragma unroll
            for (int i = 0; i < kFwdElems; ++i)
              add(w, i, __ldg(x0 + at(n2, i)), __ldg(x1 + at(n2, i)));
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kFwdElems; ++i) {
        const int e = threadIdx.x + i * kThreads;
        const int n1 = e / kCols;
        const float2 t = k2 < m ? tw[k2 * kLane + n1] : make_float2(0.f, 0.f);
        put_operand<kProd>(s_hi, s_lo,
                           (kk * kCols + e % kCols) * kLdA + 2 * n1,
                           cmul(t, s[i]));
      }
    }

    // U[128 k2 + k1][c] = (S'_k2^T R(F))[c][k1]: a thread's accumulator
    // pair (kk, nt, half) is k2 = kChunk ch + kk, row c = g + 8 half,
    // complex column k1
    float acc[kChunk][4][4];
    product<kChunk, kProd>(acc, s_hi, s_lo, stages, kTiles * ch, T, src);
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const int k2 = kChunk * ch + kk;
      if (k2 >= m) break;
      float2* out = u + ((size_t)p * n + kLane * k2) * W + c0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int k1 = warp * (kWarpCols / 2) + nt * 4 + tig;
          out[(size_t)k1 * W + g + 8 * half] =
              make_float2(acc[kk][nt][2 * half], acc[kk][nt][2 * half + 1]);
        }
    }
  }
}

int finish(cudaError_t attr) {
  const cudaError_t launch = cudaGetLastError();
  return (int)(attr != cudaSuccess ? attr : launch);
}

// The products a k16 step that the kernels are instantiated for.
bool valid_products(int products) { return products == 1 || products == 3; }

}  // namespace

extern "C" {

// Pass 1 takes products, 3 ("split") or 1 ("bf16"), and returns the
// first CUDA error of setting the shared-memory size and the launch (0 =
// cudaSuccess); 1 (cudaErrorInvalidValue) for another number of
// products.
int pfft_cols_fwd_tc(const float* x0, const float* x1, int P, int H,
                     int W, int m, const void* rf, const float2* wf,
                     const float2* tw, float2* u, int products,
                     cudaStream_t stream) {
  if (!valid_products(products)) return (int)cudaErrorInvalidValue;
  const bool resident = H <= kLane * kResidentBlocks;
  auto kernel = products == 3 ? (resident ? pfft_cols_fwd_tc_kernel<true, 3>
                                          : pfft_cols_fwd_tc_kernel<false, 3>)
                              : (resident ? pfft_cols_fwd_tc_kernel<true, 1>
                                          : pfft_cols_fwd_tc_kernel<false, 1>);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemColsFwd);
  const int blocks = P * (W / kCols);
  kernel<<<blocks, kThreads, kSmemColsFwd, stream>>>(
      x0, x1, P, H, W, m, static_cast<const bf16*>(rf), wf, tw, u);
  return finish(attr);
}

const char* pfft_conv_tc_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
