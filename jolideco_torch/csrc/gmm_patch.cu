// Patch-level GMM scoring on Hopper (sm_90a), in full float32: the MAP
// scorer of the precision dial's "highest" setting (K5), the MAP unit
// gradient and Hessian action (K6, K7) and the second stage of the
// marginalise Hessian action (K9b). Built by nvcc into a shared library
// with a plain C interface and loaded with ctypes
// (jolideco_torch/utils/cuda_build.py); the Python wrappers and the
// plain PyTorch versions are in jolideco_torch/ops/gmm_pallas.py. Rows
// are contiguous (N, 64) float32 arrays of already masked,
// mean-subtracted 8x8 patches; the ragged tail of N is masked in each
// kernel. The probe's other row kernels are gmm_score_wg.cu's instances
// on the warpgroup core: K5's MAP scorer of the bf16 modes, and, in
// every mode, K5's logsumexp with the marginalise unit gradient (K8) and
// the first stage of its Hessian action (K9a), which recompute its
// logits bit for bit.
//
// ---------------------------------------------------------------------
// gmm_score_rows_kernel replaces the JAX package's
// ops/gmm_pallas.py::_score_kernel (MAP). Per row x:
//     logit_k = -1/2 x^T A_k x + b_k . x + c_k
// over all K components; values = max_k logit_k, argmax = the LOWEST
// index among equal maxima.
//
// What bounds it on the H100: operations. The quadratic form over the
// symmetric triangle is 2,080 + 64 multiply-adds per row and component,
// 5.6e10 flop for 65,025 rows and K = 200, about 0.83 ms at the 67
// TFLOP/s fp32 (non-tensor) peak; the bytes (17 MB) take 5 µs. Design:
// two rows per thread in registers, the row-padded triangle of A_k read
// as float4 shared-memory broadcasts (gmm_logits.cuh), component records
// double-buffered through shared memory, one __syncthreads per
// component. The TPU kernel's one-hot MXU tricks, bf16 hi/lo splits and
// K padding to 128 are not carried over. At 65,025 rows, K = 200 on an
// NVIDIA H100 80GB HBM3 (700 W limit): 1.67-1.70 ms.
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
// rows), the argmax and the selected components' A (16 KB each) are
// about 33 MB, 0.010 ms at 3.35 TB/s; the 0.53 GFLOP take 8 µs. Design
// (the product stage of K2, gmm_fused.cu::gmm_bwd_kernel, without its
// overlap-add): one block of 256 threads per 128 consecutive rows. The
// rows and their argmax come in by coalesced float4 reads (a warp over
// 512 contiguous bytes) into shared memory, all of a thread's loads in
// flight together; each row's place in (k*, row) order is its rank
// among the block's keys (no sort, no atomics). Each half-warp then
// takes 8 places of that order, run by run of equal k*: a thread four
// entries of the 8 rows' outputs, reading row c of A_{k*} (its column c,
// A symmetric) as float4s, so a half-warp reads a run's A_{k*} once,
// whole 256-byte lines, and the block's other half-warps find it in L1;
// each row comes from shared memory as a float4 per four columns. Each
// output row is written by its half-warp as one 256-byte line, at the
// row's own index: rows keep their order, and every entry is one fixed
// sum, so two calls give the same bits. A run boundary inside a
// half-warp's 8 places costs it a second pass.
// The first kernel (one thread per row, the row in registers, A_{k*}
// read through the read-only path, 256-byte rows per thread that no
// warp access coalesced) took 0.059-0.082 ms of device time on an
// NVIDIA H100 80GB HBM3 (700 W limit), 0.28-0.30 ms where every block's
// rows select 128 components. This one (device time, the same card and
// inputs, scripts/torch_probe_kernel_times.py): 0.027-0.028 ms at the
// main path's trained flux (one component a block; 36% of the bound),
// 0.031-0.032 ms at a random image, 0.029 ms at its ragged 56,025 rows,
// 0.14 ms at 128 components a block (each row's A_k from L2); 106-108
// registers, no spills. A version that kept the rows transposed by
// rank in shared memory (scalar reads, 60-64 registers) took the same
// at the trained flux and 0.034-0.038 ms at the random image.

//
// ---------------------------------------------------------------------
// gmm_hvp_marg_mix_kernel (C entry gmm_hvp_marg_mix) replaces
// ops/gmm_pallas.py::_hvp_marg_mix_kernel, the second stage of the
// Hessian action of the marginalised score along a tangent t:
//     H t = sum_k [dp_k b_k - A_k (p_k t + dp_k x)]
// from the first stage's p_k = w_k / sum_j w_j and dp_k = p_k (g_k -
// sum_j p_j g_j), g_k = (b_k - A_k x) . t (K9a, gmm_score_wg.cu). p and
// dp are (K, N), component-major, so that a warp's loads for one
// component are contiguous.
//
// K9b needs no logits. What bounds it: bytes where the weights
// are one-hot (p and dp, 104 MB of the 154 MB read and written at 65,025
// rows and K = 200: 0.046 ms at 3.35 TB/s), operations where they are
// mixed (4,288 multiply-adds a nonzero entry: 1.66 ms with all 200
// nonzero). Its first kernel took a row a thread, walking all K
// components with a warp vote each and running every product for the
// whole warp where any lane had a nonzero weight, A_k through L1 one
// float4 per four multiply-adds: 0.27-0.31 ms one-hot (0.69 ms on a
// ragged image whose tiles select up to 22 components), 12.5-12.6 ms
// mixed. The kernel below reads p and dp once, coalesced, ranks each
// component's nonzero entries per tile of rows, does each entry's
// product once and reads A_k from shared memory: see its comment for the
// design and scripts/torch_k9b_times.py for its times.

#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "gmm_logits.cuh"

namespace {

using gmm::kD;
using gmm::kRec;
using gmm::load_record;
using gmm::load_row;

constexpr int kScoreThreads = 128;
constexpr int kRPT = 2;              // rows per scoring thread
// the row map: kMapTile rows a block; half-warp h of the block takes
// places [kMapSeg h, kMapSeg (h + 1)) of the tile's (k*, row) order, a
// thread four entries of their output rows
constexpr int kMapTile = 128;
constexpr int kMapThreads = 256;
constexpr int kMapSeg = kMapTile / (kMapThreads / 16);
constexpr int kMapLd = kD + 4;  // a row in shared memory: float4-aligned
static_assert(kMapSeg == 8 && kD == 64, "a half-warp's 16 threads cover a row");

// Each thread scores kRPT rows, n = (blockIdx.x * kRPT + p) * blockDim.x +
// threadIdx.x.
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

  float best[kRPT];
  int best_k[kRPT];
#pragma unroll
  for (int p = 0; p < kRPT; ++p) {
    best[p] = -CUDART_INF_F;
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
        best[p] = logit[p];
        best_k[p] = k;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int p = 0; p < kRPT; ++p) {
    if (n[p] < n_total) {
      values[n[p]] = best[p];
      argmax[n[p]] = best_k[p];
    }
  }
}

// out = b_{k*} - A_{k*} x (kUnit) or -A_{k*} x (the Hessian action, x = t)
// for the block's kMapTile consecutive rows. A_k is symmetric, so row c
// of A_k is its column c: (A_k x)_r = sum_c A_k[c][r] x_c, and a
// half-warp reads row c as 16 float4s, one 256-byte line.
template <bool kUnit>
__global__ void __launch_bounds__(kMapThreads)
gmm_row_map_kernel(const float* __restrict__ rows, const int* __restrict__ argmax,
                   const float* __restrict__ a_full,
                   const float* __restrict__ b_rows, int n_total,
                   float* __restrict__ out) {
  __shared__ __align__(16) float xs[kMapTile * kMapLd];  // the rows
  __shared__ int key[kMapTile];      // each row's k*
  __shared__ int order[kMapTile];    // the row at each place of (k*, q) order
  __shared__ int run_end[kMapTile];  // the end of each place's run of k*

  // the block's rows and keys, from coalesced float4 reads (a warp over
  // 512 contiguous bytes), all of a thread's in flight together
  const int n0 = blockIdx.x * kMapTile;
  const int count = n_total - n0 < kMapTile ? n_total - n0 : kMapTile;
  const float4* x4 = reinterpret_cast<const float4*>(rows + (size_t)n0 * kD);
  for (int e = threadIdx.x; e < count * kD / 4; e += blockDim.x) {
    const int q = e / (kD / 4), c = 4 * (e % (kD / 4));
    *reinterpret_cast<float4*>(xs + q * kMapLd + c) = __ldg(x4 + e);
  }
  for (int q = threadIdx.x; q < count; q += blockDim.x)
    key[q] = __ldg(argmax + n0 + q);
  __syncthreads();

  // each row's place in (k*, q) order, and where its run ends
  for (int q = threadIdx.x; q < count; q += blockDim.x) {
    const int k = key[q];
    int upto = 0, place = 0;
    for (int j = 0; j < count; ++j) {
      const int kj = key[j];
      upto += kj <= k;
      place += kj < k || (kj == k && j < q);
    }
    order[place] = q;
    run_end[place] = upto;
  }
  __syncthreads();

  // thread t: half-warp h = t / 16 takes places kMapSeg h .. kMapSeg h +
  // kMapSeg - 1, run by run, the rows at places j0 + i (i < kMapSeg) of
  // the run from place j0 (a place past the run's end reads the run's
  // first row and is not stored), entries r0 .. r0 + 3 of their output
  // (r0 = 4 (t % 16)): per four columns c, four float4s of A_{k*} and a
  // float4 of each row, 64 multiply-adds. Each output row is stored by
  // its half-warp as one 256-byte line. No barrier between runs.
  for (int t = threadIdx.x; t < kMapThreads; t += blockDim.x) {
    const int seg = t / 16, r0 = 4 * (t % 16);
    const int seg_end = kMapSeg * (seg + 1) < count ? kMapSeg * (seg + 1)
                                                    : count;
    for (int j = kMapSeg * seg; j < seg_end;) {
      const int k = key[order[j]];
      const int j0 = j;
      const int end = run_end[j] < seg_end ? run_end[j] : seg_end;
      j = end;
      int q[kMapSeg];
#pragma unroll
      for (int i = 0; i < kMapSeg; ++i) q[i] = order[j0 + i < end ? j0 + i : j0];
      const float* ak = a_full + (size_t)k * kD * kD + r0;
      float acc[kMapSeg][4];
#pragma unroll
      for (int i = 0; i < kMapSeg; ++i)
        acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
#pragma unroll 2
      for (int c = 0; c < kD; c += 4) {
        float4 a[4];
#pragma unroll
        for (int m = 0; m < 4; ++m)
          a[m] = __ldg(reinterpret_cast<const float4*>(ak + (c + m) * kD));
#pragma unroll
        for (int i = 0; i < kMapSeg; ++i) {
          const float4 x =
              *reinterpret_cast<const float4*>(xs + q[i] * kMapLd + c);
          const float xv[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            acc[i][0] = fmaf(a[m].x, xv[m], acc[i][0]);
            acc[i][1] = fmaf(a[m].y, xv[m], acc[i][1]);
            acc[i][2] = fmaf(a[m].z, xv[m], acc[i][2]);
            acc[i][3] = fmaf(a[m].w, xv[m], acc[i][3]);
          }
        }
      }
      const float4 b =
          kUnit ? __ldg(reinterpret_cast<const float4*>(b_rows + (size_t)k * kD + r0))
                : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int i = 0; i < kMapSeg; ++i) {
        if (j0 + i >= end) break;
        reinterpret_cast<float4*>(out + (size_t)(n0 + q[i]) * kD + r0)[0] =
            make_float4(b.x - acc[i][0], b.y - acc[i][1], b.z - acc[i][2],
                        b.w - acc[i][3]);
      }
    }
  }
}

// Stage 2: H t = sum_k [dp_k b_k - A_k (p_k t + dp_k x)], a block per
// tile of kMixTile rows. The tile's x, t and running sums stay in shared
// memory. The components come in chunks of kMixChunk: the block reads
// the chunk's (component, row) slabs of p and dp once, coalesced along N,
// and keeps a mask of the rows with p_k or dp_k nonzero for each
// component (zero terms are skipped, exactly, as before). Then, for each
// component with rows in ascending order, A_k and that component's p and
// dp come into shared memory by cp.async, double-buffered (the next
// component's while this one multiplies); the rows of the mask are ranked
// by row into a list, with v = p_k t + dp_k x staged for each; and each
// entry's y = A_k v is summed by a half-warp, a thread four entries of y,
// R entries at a time (R = 1, 2 or 4, the fewest that give every entry a
// half-warp). dp_k b_k - y is then added to the entry's running sum.
// Every float32 sum is the first kernel's: a chain of 64 terms per
// component, then one over the components in ascending order, each row's
// entries one after the other (a barrier between components), so the
// output is the first kernel's bit for bit, and two calls give the same
// bits, with no atomics. A tile of 64 rows keeps the shared memory at
// 105 KB, two blocks an SM, so that one block's loads overlap the
// other's products (scripts/torch_k9b_variants.py: 128 rows a block, one
// an SM, took 0.104 and 4.39 ms where 64 took 0.087 and 3.87). On an
// NVIDIA H100 80GB HBM3 (700 W limit), 65,025 rows, K = 200, device time
// (scripts/torch_k9b_times.py): 0.087-0.088 ms at one-hot weights (53% of
// the byte bound; 0.272-0.297 before), 0.098-0.099 ms at a ragged image
// of 56,025 rows whose tiles select up to 22 components (0.71 before),
// 3.86 ms with all 200 weights nonzero (43% of the operation bound; 12.55
// before), held there by the two barriers and the v staging of each
// component of a tile and by the shared-memory reads (eight float4s per
// 64 multiply-adds). ptxas: 90 registers, 0 spilled.
constexpr int kMixTile = 64;    // rows a block
constexpr int kMixBlocks = 2;   // blocks an SM (the shared memory's share)
constexpr int kMixThreads = 256;
constexpr int kMixChunk = 64;   // components a chunk of the masks
constexpr int kMixLoads = 16;   // (component, row) slab entries of a thread in flight
constexpr int kMixUnroll = 16;  // four-column steps of a product unrolled
constexpr int kMixWords = kMixTile / 32;  // mask words a component
constexpr int kMixHalves = kMixThreads / 16;  // half-warps a block
constexpr int kMixMaxR = kMixTile > 4 * kMixHalves ? 8 : 4;  // entries a half-warp
constexpr int kMixLdV = kD + 4; // a staged v: entries e, e + 1 four banks apart
static_assert(kMixTile % 32 == 0 && kMixTile <= 256 && kMixChunk % 4 == 0 &&
                  kMixChunk <= 64,
              "whole mask words; a row's index in a byte; the chunk's "
              "components in a 64-bit mask");
static_assert(kMixTile <= 8 * kMixHalves, "at most eight entries a half-warp");
// the dynamic shared memory, in floats: x, t, the running sums, the
// staged v, A_k, p_k and dp_k of two stages, the chunk's masks, then
// bytes: a flag per (component, row) of the chunk, a component's entry
// list and the chunk's active components
constexpr int kMixX = 0;
constexpr int kMixT = kMixX + kMixTile * kD;
constexpr int kMixAcc = kMixT + kMixTile * kD;
constexpr int kMixV = kMixAcc + kMixTile * kD;
constexpr int kMixA = kMixV + kMixTile * kMixLdV;
constexpr int kMixP = kMixA + 2 * kD * kD;
constexpr int kMixDp = kMixP + 2 * kMixTile;
constexpr int kMixMask = kMixDp + 2 * kMixTile;
constexpr int kMixFlags = kMixMask + kMixWords * kMixChunk;
constexpr int kMixRows = kMixFlags + kMixChunk * kMixTile / 4;
constexpr int kMixActive = kMixRows + kMixTile / 4;
constexpr int kMixSmem = 4 * (kMixActive + kMixChunk / 4);

// The four bits 0, 8, 16, 24 of v (flags of 0 or 1, one a byte) as bits
// 0 .. 3.
__device__ __forceinline__ unsigned pack_flags(unsigned v) {
  return (v | v >> 7 | v >> 14 | v >> 21) & 0xFu;
}

// Issues the copies of A_k and of p_k, dp_k over the tile's rows into a
// stage, as one cp.async group.
__device__ __forceinline__ void mix_stage(float* a_dst, float* p_dst,
                                          float* dp_dst,
                                          const float* __restrict__ a_full,
                                          const float* __restrict__ p,
                                          const float* __restrict__ dp,
                                          int k, int n_total, int n0,
                                          int count) {
  const float4* a4 = reinterpret_cast<const float4*>(a_full + (size_t)k * kD * kD);
  for (int e = threadIdx.x; e < kD * kD / 4; e += blockDim.x)
    __pipeline_memcpy_async(a_dst + 4 * e, a4 + e, 16);
  const size_t g = (size_t)k * n_total + n0;
  for (int q = threadIdx.x; q < count; q += blockDim.x) {
    __pipeline_memcpy_async(p_dst + q, p + g + q, 4);
    __pipeline_memcpy_async(dp_dst + q, dp + g + q, 4);
  }
  __pipeline_commit();
}

// y = A_k v for the m staged entries and acc[row] += dp_k b_k - y: half-
// warp h takes entries h, h + H, ..., h + H (R - 1), H = kMixHalves (an
// entry past m reads entry h and is not stored), a thread entries
// r0 .. r0 + 3 of their y (r0 = 4 (t % 16)). A_k is symmetric, so row c of A_k is its
// column c, and per four columns c a thread reads four float4s of A_k
// (the half-warp a 256-byte line of each row, the warp's other half-warp
// the same) and a float4 of each entry's v, 16 R multiply-adds.
template <int R>
__device__ __forceinline__ void mix_product(const float* a, const float* vs,
                                            const unsigned char* rows,
                                            const float* dps,
                                            const float* __restrict__ bk,
                                            float* acc, int m) {
  for (int u = threadIdx.x; u < kMixThreads; u += blockDim.x) {
    const int h = u / 16, r0 = 4 * (u % 16);
    if (h >= m) continue;
    float y[R][4];
#pragma unroll
    for (int i = 0; i < R; ++i) y[i][0] = y[i][1] = y[i][2] = y[i][3] = 0.f;
#pragma unroll kMixUnroll
    for (int c = 0; c < kD; c += 4) {
      float4 av[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        av[j] = *reinterpret_cast<const float4*>(a + (c + j) * kD + r0);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int e = h + kMixHalves * i < m ? h + kMixHalves * i : h;
        const float4 v = *reinterpret_cast<const float4*>(vs + e * kMixLdV + c);
        const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[i][0] = fmaf(av[j].x, vv[j], y[i][0]);
          y[i][1] = fmaf(av[j].y, vv[j], y[i][1]);
          y[i][2] = fmaf(av[j].z, vv[j], y[i][2]);
          y[i][3] = fmaf(av[j].w, vv[j], y[i][3]);
        }
      }
    }
    const float4 b = __ldg(reinterpret_cast<const float4*>(bk + r0));
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int e = h + kMixHalves * i;
      if (e >= m) break;
      const int q = rows[e];
      const float d = dps[q];
      float4* dst = reinterpret_cast<float4*>(acc + q * kD + r0);
      float4 o = *dst;
      o.x += fmaf(d, b.x, -y[i][0]);
      o.y += fmaf(d, b.y, -y[i][1]);
      o.z += fmaf(d, b.z, -y[i][2]);
      o.w += fmaf(d, b.w, -y[i][3]);
      *dst = o;
    }
  }
}

__global__ void __launch_bounds__(kMixThreads, kMixBlocks)
gmm_hvp_marg_mix_kernel(const float* __restrict__ rows,
                        const float* __restrict__ tangents,
                        const float* __restrict__ p, const float* __restrict__ dp,
                        const float* __restrict__ a_full,
                        const float* __restrict__ b_rows, int n_total, int K,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem + kMixX;
  float* ts = smem + kMixT;
  float* acc = smem + kMixAcc;
  float* vs = smem + kMixV;
  unsigned* mask = reinterpret_cast<unsigned*>(smem + kMixMask);
  unsigned char* flags = reinterpret_cast<unsigned char*>(smem + kMixFlags);
  unsigned char* list = reinterpret_cast<unsigned char*>(smem + kMixRows);
  unsigned char* active = reinterpret_cast<unsigned char*>(smem + kMixActive);

  const int n0 = blockIdx.x * kMixTile;
  const int count = n_total - n0 < kMixTile ? n_total - n0 : kMixTile;
  if (count <= 0) return;  // the whole block: no barrier is skipped

  // the tile's x and t by cp.async (waited for with the first stage)
  const float4* x4 = reinterpret_cast<const float4*>(rows + (size_t)n0 * kD);
  const float4* t4 = reinterpret_cast<const float4*>(tangents + (size_t)n0 * kD);
  for (int e = threadIdx.x; e < count * kD / 4; e += blockDim.x) {
    __pipeline_memcpy_async(xs + 4 * e, x4 + e, 16);
    __pipeline_memcpy_async(ts + 4 * e, t4 + e, 16);
  }
  __pipeline_commit();
  for (int e = threadIdx.x; e < kMixTile * kD / 4; e += blockDim.x)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  int s = 0;  // the stage of the next component
  for (int c0 = 0; c0 < K; c0 += kMixChunk) {
    const int kc = K - c0 < kMixChunk ? K - c0 : kMixChunk;
    // the chunk's flags: a (component, row) entry's p and dp, read by a
    // warp as 32 consecutive rows of one component, kMixLoads entries of
    // a thread in flight together
    const int items = kc * kMixTile;
    for (int base = threadIdx.x; base < items; base += kMixLoads * blockDim.x) {
      float pv[kMixLoads], dv[kMixLoads];
#pragma unroll
      for (int i = 0; i < kMixLoads; ++i) {
        const int e = base + i * blockDim.x;
        const int q = e % kMixTile;
        const size_t g = (size_t)(c0 + e / kMixTile) * n_total + n0 + q;
        const bool live = e < items && q < count;
        pv[i] = live ? __ldg(p + g) : 0.f;
        dv[i] = live ? __ldg(dp + g) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kMixLoads; ++i) {
        const int e = base + i * blockDim.x;
        if (e < items) flags[e] = pv[i] != 0.f || dv[i] != 0.f;
      }
    }
    __syncthreads();
    // each component's mask of rows (kMixWords words) and whether it has
    // any
    for (int j = threadIdx.x; j < kMixChunk; j += blockDim.x) {
      unsigned any = 0;
      if (j < kc) {
        const unsigned* f = reinterpret_cast<const unsigned*>(flags + j * kMixTile);
        for (int w = 0; w < kMixWords; ++w) {
          unsigned bits = 0;
#pragma unroll
          for (int i = 0; i < 8; ++i) bits |= pack_flags(f[8 * w + i]) << (4 * i);
          mask[kMixWords * j + w] = bits;
          any |= bits;
        }
      }
      active[j] = any != 0;
    }
    __syncthreads();
    unsigned long long todo = 0;  // the chunk's components with entries
#pragma unroll
    for (int i = 0; i < kMixChunk / 4; ++i)
      todo |= (unsigned long long)pack_flags(
                  reinterpret_cast<const unsigned*>(active)[i]) << (4 * i);
    if (todo)
      mix_stage(smem + kMixA + s * kD * kD, smem + kMixP + s * kMixTile,
                smem + kMixDp + s * kMixTile, a_full, p, dp,
                c0 + __ffsll((long long)todo) - 1, n_total, n0, count);
    while (todo) {
      const int j = __ffsll((long long)todo) - 1;
      todo &= todo - 1;
      const int k = c0 + j;
      const float* ak = smem + kMixA + s * kD * kD;
      const float* ps = smem + kMixP + s * kMixTile;
      const float* dps = smem + kMixDp + s * kMixTile;
      __pipeline_wait_prior(0);
      // the stage is in for every thread, and every thread is done with
      // the last component's list, v and stage
      __syncthreads();
      if (todo)
        mix_stage(smem + kMixA + (s ^ 1) * kD * kD,
                  smem + kMixP + (s ^ 1) * kMixTile,
                  smem + kMixDp + (s ^ 1) * kMixTile, a_full, p, dp,
                  c0 + __ffsll((long long)todo) - 1, n_total, n0, count);
      // v = p_k t + dp_k x for each row of the mask, at its rank (the
      // entries before it in row order)
      const unsigned* mk = mask + kMixWords * j;
      int ones[kMixWords], m = 0;
#pragma unroll
      for (int w = 0; w < kMixWords; ++w) m += ones[w] = __popc(mk[w]);
      for (int e = threadIdx.x; e < kMixTile * kD / 4; e += blockDim.x) {
        const int q = e / (kD / 4), c = 4 * (e % (kD / 4));
        const unsigned word = mk[q / 32];
        const unsigned bit = 1u << (q % 32);
        if (!(word & bit)) continue;
        int rank = __popc(word & (bit - 1u));
#pragma unroll
        for (int w = 0; w < kMixWords; ++w) rank += w < q / 32 ? ones[w] : 0;
        const float pk = ps[q], dpk = dps[q];
        const float4 xv = *reinterpret_cast<const float4*>(xs + q * kD + c);
        const float4 tv = *reinterpret_cast<const float4*>(ts + q * kD + c);
        *reinterpret_cast<float4*>(vs + rank * kMixLdV + c) =
            make_float4(fmaf(dpk, xv.x, pk * tv.x), fmaf(dpk, xv.y, pk * tv.y),
                        fmaf(dpk, xv.z, pk * tv.z), fmaf(dpk, xv.w, pk * tv.w));
        if (c == 0) list[rank] = static_cast<unsigned char>(q);
      }
      __syncthreads();
      const float* bk = b_rows + (size_t)k * kD;
      if (m <= kMixHalves)
        mix_product<1>(ak, vs, list, dps, bk, acc, m);
      else if (m <= 2 * kMixHalves)
        mix_product<2>(ak, vs, list, dps, bk, acc, m);
      else if (m <= 4 * kMixHalves || kMixMaxR == 4)
        mix_product<4>(ak, vs, list, dps, bk, acc, m);
      else
        mix_product<kMixMaxR>(ak, vs, list, dps, bk, acc, m);
      s ^= 1;
    }
  }
  __pipeline_wait_prior(0);  // a tile without entries never waited
  __syncthreads();
  float4* dst = reinterpret_cast<float4*>(out + (size_t)n0 * kD);
  for (int e = threadIdx.x; e < count * kD / 4; e += blockDim.x)
    dst[e] = reinterpret_cast<const float4*>(acc)[e];
}

int blocks_for(int n, int per_block) { return (n + per_block - 1) / per_block; }

}  // namespace

extern "C" {

// Each returns cudaGetLastError() after the launch (0 = cudaSuccess); the
// wrappers never call them with n = 0.
int gmm_score_rows(const void* rows, int n, const void* rec, int K,
                   void* values, void* argmax, void* stream) {
  gmm_score_rows_kernel<<<blocks_for(n, kScoreThreads * kRPT), kScoreThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), n, static_cast<const float*>(rec), K,
      static_cast<float*>(values), static_cast<int*>(argmax));
  return static_cast<int>(cudaGetLastError());
}

int gmm_unit_map(const void* rows, const void* argmax, const void* a_full,
                 const void* b_rows, int n, void* out, void* stream) {
  gmm_row_map_kernel<true><<<blocks_for(n, kMapTile), kMapThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const int*>(argmax),
      static_cast<const float*>(a_full), static_cast<const float*>(b_rows), n,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int gmm_hvp_map(const void* tangents, const void* argmax, const void* a_full,
                int n, void* out, void* stream) {
  gmm_row_map_kernel<false><<<blocks_for(n, kMapTile), kMapThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tangents), static_cast<const int*>(argmax),
      static_cast<const float*>(a_full), nullptr, n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

int gmm_hvp_marg_mix(const void* rows, const void* tangents, const void* p,
                     const void* dp, const void* a_full, const void* b_rows,
                     int n, int K, void* out, void* stream) {
  const cudaError_t attr = cudaFuncSetAttribute(
      gmm_hvp_marg_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMixSmem);
  gmm_hvp_marg_mix_kernel<<<blocks_for(n, kMixTile), kMixThreads, kMixSmem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), static_cast<const float*>(tangents),
      static_cast<const float*>(p), static_cast<const float*>(dp),
      static_cast<const float*>(a_full), static_cast<const float*>(b_rows), n, K,
      static_cast<float*>(out));
  const cudaError_t launch = cudaGetLastError();
  return static_cast<int>(attr != cudaSuccess ? attr : launch);
}

const char* gmm_patch_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
