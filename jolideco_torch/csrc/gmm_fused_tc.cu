// The flux-error probe's marginalised row kernels on Hopper's tensor
// cores (sm_90a, mma.sync), in the precision dial's "split" and "bf16"
// modes: K5 lse (the logsumexp of rows), K8 (the marginalise unit
// gradient) and K9a (the first stage of its Hessian action). Built by
// nvcc into a shared library with a plain C interface and loaded with
// ctypes (jolideco_torch/utils/cuda_build.py); the wrappers and the plain
// PyTorch versions are in jolideco_torch/ops/gmm_pallas.py and
// jolideco_torch/ops/gmm_fused.py. Every kernel is a template over kProd,
// the bf16 products a k16 step: 3 for "split" (precision HIGH, described
// below), 1 for "bf16" (precision DEFAULT, at the end of this header).
// Their "f32" kernels are gmm_patch.cu's; the fused branch's kernels (K1
// MAP and logsumexp, K4) and the MAP row scorer (K5) of every mode are
// gmm_score_wg.cu's (wgmma), and K2 is gmm_fused.cu's.
//
// K8 split and K9a split take K5 lse split's lse as the stabiliser of
// exp(logit - lse) and recompute the logits by tile_logits in the same
// block geometry and order, bit for bit: over logits of 1e5 to 1e8 an
// lse summed in another order would move those weights by whole units of
// the exponent, so the three move to a new core together or not at all.
//
// gmm_score_rows_tc_kernel (K5 lse split) replaces ops/gmm_pallas.py::
// _score_kernel (logsumexp) under precision HIGH ("split3"): per row x
// (N, 64) float32, already masked and mean-subtracted,
//     logit_k = -1/2 x^T A_k x + b_k . x + c_k
// and the logsumexp with the LOWEST index among equal maxima. As in the
// JAX kernel, the quadratic form is a matrix product of the pair
// products u = x (x) x with A, both operands split into bf16 high and
// low parts (hi = bf16(v), lo = bf16(v - hi), round to nearest even),
// three products hi.hi + hi.lo + lo.hi summed in float32, and b . x in
// float32. A is symmetric, so only the 2,080 pairs a <= b are formed:
// u_ab = x_a x_b against A_aa on the diagonal and A_ab + A_ba off it
// (doubling is exact, so the products are the JAX kernel's, summed in
// another order).
//
// What bounds it on the H100: operations. At 65,025 rows, K = 200: 3 x
// 2 x 65,025 x 200 x 2,144 flop = 0.169 ms at the bf16 peak of 989
// TFLOP/s; bytes are 17 MB in (0.005 ms). The design (tile_logits, the
// one code of the logits in all three kernels):
// - one block of 8 warps owns 128 rows and a tile of kKP = 208
//   components (K = 200 padded; the padding is masked out of the
//   reductions); a warp owns 32 rows x 104 components: 2 x 13 m16n8
//   tiles, 104 float32 accumulators a thread. A GMM of more components
//   runs its tiles one after another in the same block, each tile's
//   reduction merged into the rows' running one in shared memory;
// - the block's 128 rows come in by coalesced float4 reads (load_rows);
//   a row past the end is zero and is not written;
// - the pair dimension runs in 65 chunks of 32 pairs. Per chunk the
//   block forms u for its 128 rows in float32 from the rows in shared
//   memory and splits it into bf16 hi and lo planes (double buffered),
//   while A's chunk (hi and lo, pair-major, 26 KB, stored on the device
//   chunk by chunk by ops/gmm_fused.py::kernel_buffers) streams in
//   through two cp.async stages; one __syncthreads a chunk;
// - fragments come from shared memory with ldmatrix (rows padded to 40
//   bf16, so that ldmatrix's eight rows fall on distinct banks) into
//   mma.sync m16n8k16, bf16 in, float32 accumulate, the small products
//   first, each k16 step's three into fresh accumulators that are added
//   to the running sums on the CUDA cores (add_split says why);
// - b . x + c in float32 on the CUDA cores before the main loop: the
//   accumulators start at -2 (b . x + c), so that -1/2 of the sum is the
//   logit (scaling by powers of two is exact);
// - the maximum and the sum of exp(logit - maximum), rescaled whenever
//   the maximum grows, over each thread's 26 components, then over the
//   four threads of a quad (shuffles), then over the two warps of a row
//   and the earlier tiles (shared memory), ties to the lower index, in
//   one fixed order.
// A's 1.7 MB a tile is read from L2 once per block (509 blocks, 0.88
// GB); mma.sync, not wgmma, and no TMA: a first version that is right.
//
// gmm_unit_marg_tc_kernel (K8 split) replaces ops/gmm_pallas.py::
// _unit_marg_kernel under precision HIGH: per row with K5 lse split's
// logsumexp lse,
//     w_k = exp(logit_k - lse),  u = sum_k w_k (b_k - A_k x) / sum_k w_k
// written to (N, 64), the logits recomputed by tile_logits in K5 lse's
// block geometry, chunk order and add_split order: bit for bit the
// logits lse summed. That matters: the shipped GMMs' logits are 1e5 to
// 1e8, and the split logits differ from float32 ones by up to 6.4e-5 of
// their value, hundreds of units in the exponent (gmm_marg.cuh). The JAX
// kernel mixes with p and A split into bf16 hi and lo; this one in
// float32.
//
// What bounds it: the recomputed logits (K5's 0.17 ms), plus the A_k x
// terms of the nonzero weights in float32 (4,096 multiply-adds and 16 KB
// of A_k each). For the shipped GMMs nearly every weight underflows to
// exactly 0 (about one nonzero a row), and skipping a zero term is exact.
// The design (marg_rows, with K9a split): after a tile's main loop its
// weights go to shared memory (over the stages and u, 104 KB); each warp
// owns 16 rows, finds their nonzero weights 32 components at a time with
// one ballot per row, and runs each component's term for those rows in
// turn, one warp per (row, component): lane l accumulates entries 2l, 2l
// + 1 of A_k x while the warp reads A_k row by row, coalesced, through
// the read-only path (A_k stays in L1 across the rows that share it).
// The gradient rows (33 KB) stay in shared memory across the tiles; each
// row is summed by its one warp, components in ascending order, so the
// result is deterministic without atomics, for any K and any number of
// nonzero weights.
//
// gmm_hvp_marg_weights_tc_kernel (K9a split) replaces ops/gmm_pallas.py::
// _hvp_marg_weights_kernel under precision HIGH: with the same weights,
// p = w / sum w and dp_k = p_k (g_k - sum_j p_j g_j), g_k = t . (b_k -
// A_k x), out (K, N) as gmm_patch.cu's K9a. The JAX kernel computes g by
// a second split product, the cross form u(t, x) . A, for every (row,
// component); this one computes g in float32 for the nonzero weights
// only (marg_dot, one warp a term, as K8's A_k x), since g_k drops out
// of dp where p_k = 0: for the shipped GMMs about one term a row. dp is
// taken against the heaviest component's g, so that a row whose weight
// sits on one component gets dp = 0 exactly. The normalisation needs
// every tile's weights, so w and g go to the (K, N) outputs tile by tile
// (a component's 128 rows of the block are one 512-byte line), and a
// second pass over the block's rows, a thread a row, finishes p and dp
// there. What bounds it: K8 split's work, with t . (b_k - A_k x) in
// place of the mixture, and p and dp written (104 MB at 65,025 rows, K
// = 200, 0.031 ms).
//
// On an NVIDIA H100 80GB HBM3 (700 W limit) at 65,025 rows, K = 200,
// astro-snr-v1 (chip_smoke.py phase 2): gmm_score_rows_tc_kernel 0.747
// ms, 23% of the split bound; gmm_unit_marg_tc_kernel 0.832-0.845 ms,
// gmm_hvp_marg_weights_tc_kernel 0.943 (gmm_patch.cu's float32 K8
// 2.51-2.52, K9a 2.89-2.90), 21% and 19% of their split bounds; 255
// registers, 32 and 204 bytes spilled; mixed weights 14.28 and 17.01 ms
// (float32 10.71-10.77, 15.27-15.30). K9a split's first version, which
// sent the last tile's weights through p too, took 1.066 ms.
//
// The "bf16" instances (kProd = 1) replace the same JAX bodies under
// precision DEFAULT, the dial's "default" setting, whose matrix unit
// rounds each float32 operand to bf16 (round to nearest even),
// multiplies exactly and sums in float32: u's chunk is rounded into the
// hi plane only (put_operand), A's chunk stages its hi half only (13 KB;
// pair_tc holds hi then lo per chunk, and hi = bf16(A), of the JAX
// package's float32 A doubled off the diagonal: kernel_buffers' A is
// symmetric bit for bit and bf16 doubles exactly, so u_ab (2 A_ab) is
// the JAX form's u_ab A_ab + u_ba A_ba), and each k16 step issues one
// mma into fresh accumulators (add_single), a third of the split's
// tensor-core work: 0.056 ms at 65,025 rows, K = 200. b . x + c, the
// reductions, the mixtures and K9a's float32 g are the split instances'
// code. The JAX kernel's K9a computes g by the cross form at DEFAULT;
// this one keeps g in float32, as under "split". On the H100 (700 W) at
// 65,025 rows, K = 200: gmm_score_rows_tc_kernel<1> 0.423-0.428 ms,
// gmm_unit_marg_tc_kernel<1> 0.512-0.515, gmm_hvp_marg_weights_tc_kernel
// <1> 0.587-0.592 (chip_smoke.py phase 2), 11-13% of their one-product
// bounds (0.056-0.064 ms); 252-255 registers, 0 bytes spilled. Outside
// the mma (b . x, forming u, the reductions, the mixtures) the two modes
// do the same work, which is why one product takes 56-66% of three's
// time, not a third.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "gmm_patches.cuh"
#include "tc_frag.cuh"

namespace {

using gmm::kD;
using tc::bf16;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait;
using tc::ldsm_x2;
using tc::ldsm_x4;
using tc::mma;
using tc::put_operand;

constexpr int kPairs = kD * (kD + 1) / 2;    // 2,080 pairs a <= b
constexpr int kKP = 208;                     // components a tile
constexpr int kBlockRows = 128;              // rows per block
constexpr int kThreads = 256;                // 8 warps: 4 (rows) x 2 (cols)
constexpr int kWarpCols = kKP / 2;           // components per warp: 104
constexpr int kMT = 2;                       // m16 tiles per warp
constexpr int kNT = kWarpCols / 8;           // n8 tiles per warp: 13
constexpr int kKC = 32;                      // pairs per chunk
constexpr int kChunks = kPairs / kKC;        // 65
constexpr int kLd = kKC + 8;                 // padded bf16 row (80 B)
constexpr int kXLd = kD + 1;                 // padded float row
constexpr int kTileElems = 2 * kKP * kKC;    // A's chunk, hi and lo
constexpr int kStageElems = 2 * kKP * kLd;   // the same, padded
constexpr int kUElems = 2 * kBlockRows * kLd;  // u's chunk, hi and lo
static_assert(kPairs % kKC == 0 && kKC % 16 == 0, "whole k16 steps");
static_assert(kNT % 2 == 1, "pairs of n8 tiles and one more");

// shared memory: the rows (float, padded), the pair table, A's two
// stages (which hold b and c before the main loop), u's two buffers; K5
// lse's reductions (maximum, argmax and the sum of exponentials of the
// two warp columns and the rows' running ones), or the mixture kernels'
// logsumexp and weight sums of the rows, then their gradient or tangent
// rows (float, padded: MargSmem). Their weights of a tile overlay the
// stages and u once the tile's main loop is done.
constexpr int kXBytes = kBlockRows * kXLd * 4;
constexpr int kPairBytes = kPairs * 2;
constexpr int kStageBytes = 2 * kStageElems * 2;
constexpr int kUBytes = 2 * kUElems * 2;
constexpr int kRedBytes = 3 * kBlockRows * 12;
constexpr int kGLd = kD + 2;                 // padded gradient row
constexpr int kGradBytes = kBlockRows * kGLd * 4;
constexpr int kWLd = kKP;                    // weight row
constexpr int kRowsPerWarp = kBlockRows / (kThreads / 32);  // 16
constexpr int kSmemFwd =
    kXBytes + kPairBytes + kStageBytes + kUBytes + kRedBytes;
constexpr int kSmemBwd = kSmemFwd + kGradBytes;
static_assert(kXBytes % 16 == 0 && kPairBytes % 16 == 0 &&
                  kStageBytes % 16 == 0 && kUBytes % 16 == 0 &&
                  kRedBytes % 16 == 0,
              "16-byte aligned regions");
static_assert(kBlockRows * kWLd * 4 <= kStageBytes + kUBytes,
              "a tile's weights fit the stages and u");
static_assert(kRowsPerWarp <= 32 && kGLd % 2 == 0, "rows of a warp");
static_assert(kThreads == 2 * kBlockRows && 7 * kBlockRows * 4 <= kRedBytes,
              "K9a split: two threads a row, sums beside lse, wsum, g_ref");
static_assert(kSmemBwd <= 232448, "shared memory of a block");
static_assert((kD + 1) * kKP * 4 <= kStageBytes, "b and c fit the stages");

// A's chunk c of a tile (hi then lo, [component][32 pairs] each,
// contiguous on the device) into a stage with padded rows, by the whole
// block: both halves for three products, the hi half for one.
template <int kProd>
__device__ __forceinline__ void load_stage(bf16* dst,
                                           const bf16* __restrict__ src) {
  constexpr int kCopies = (kProd == 3 ? kTileElems : kTileElems / 2) / 8;
  for (int i = threadIdx.x; i < kCopies; i += kThreads)
    cp_async16(dst + (i >> 2) * kLd + (i & 3) * 8, src + i * 8);
}

// u's chunk c for the block's rows into the hi and lo planes (hi
// alone for one product): thread t forms pairs (2j, 2j + 1), j = t % 16,
// of rows t / 16 + 16 i.
template <int kProd>
__device__ __forceinline__ void form_u(bf16* u, const float* xs,
                                       const uint16_t* pairs, int c) {
  const int j = threadIdx.x & 15;
  const uint32_t ab =
      *reinterpret_cast<const uint32_t*>(pairs + c * kKC + 2 * j);
  const int a0 = ab & 0xff, b0 = (ab >> 8) & 0xff;
  const int a1 = (ab >> 16) & 0xff, b1 = ab >> 24;
  bf16* u_hi = u;
  bf16* u_lo = u + kBlockRows * kLd;
#pragma unroll
  for (int i = 0; i < kBlockRows / 16; ++i) {
    const int r = (threadIdx.x >> 4) + 16 * i;
    const float* x = xs + r * kXLd;
    put_operand<kProd>(u_hi + r * kLd, u_lo + r * kLd, 2 * j,
                       make_float2(x[a0] * x[b0], x[a1] * x[b1]));
  }
}

// acc += u[:, chunk] . A[chunk, warp's components] in the three split
// products. Each k16 step's three products go into fresh accumulators,
// which are then added to acc on the CUDA cores, rounded to nearest.
// The mma's float32 sums are not IEEE sums: on an H100, with all 390
// products of a logit summed in the mma, the values were 4.5e-6 (mean,
// relative) above the exact sum of the same products; flushed every k16
// step the bias is gone (4.7e-8), and the largest difference stays 1.5e-5
// (astro-snr-v1; builtin-8x8-v1 4.7e-5) at 1024^2, where cuBLAS's float32
// sums of the split plain version are 3.6e-6 (8.3e-6) off. Flushing each
// product, or k8 products, changed neither (a variant build of this file,
// jolideco_torch/utils/gmm_tc_variants.py of commit 4a9e377). The split
// itself is 6.4e-5 (1.5e-4) off float64 there, and the kernel's error
// against float64 is the plain version's; chip_smoke.py phase 2 holds
// the bias and the difference.
__device__ __forceinline__ void add_split(float (&acc)[4],
                                          const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4],
                                          const uint32_t* bh,
                                          const uint32_t* bl) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, al, bh);
  mma(t, ah, bl);
  mma(t, ah, bh);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += t[q];
}

// The "bf16" mode's product hi.hi, into fresh accumulators added to acc
// on the CUDA cores, as add_split's three.
__device__ __forceinline__ void add_single(float (&acc)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t* bh) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma(t, ah, bh);
#pragma unroll
  for (int q = 0; q < 4; ++q) acc[q] += t[q];
}

// acc += u[:, chunk] . A[chunk, warp's components]: add_split's three
// products (kProd = 3) or add_single's one, whose lo planes are neither
// read nor written.
template <int kProd>
__device__ __forceinline__ void mma_chunk(float (&acc)[kMT][kNT][4],
                                          const bf16* u, const bf16* stage,
                                          int wm, int wn, int lane) {
  const bf16* u_hi = u;
  const bf16* u_lo = u + kBlockRows * kLd;
  const bf16* b_hi = stage;
  const bf16* b_lo = stage + kKP * kLd;
#pragma unroll
  for (int ks = 0; ks < kKC; ks += 16) {
    // A fragments: matrices (rows 0-7, k 0-7), (rows 8-15, k 0-7),
    // (rows 0-7, k 8-15), (rows 8-15, k 8-15)
    uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      const int r = wm * 32 + mt * 16 + (lane & 15);
      const int kc = ks + (lane >> 4) * 8;
      ldsm_x4(ah[mt], u_hi + r * kLd + kc);
      if constexpr (kProd == 3) ldsm_x4(al[mt], u_lo + r * kLd + kc);
    }
    // B fragments, two n8 tiles per ldmatrix.x4: matrices (n 0-7, k
    // 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
#pragma unroll
    for (int np = 0; np < kNT / 2; ++np) {
      uint32_t bh[4], bl[4];
      const int nr = wn * kWarpCols + np * 16 + (lane & 7) +
                     ((lane >> 4) << 3);
      const int kc = ks + ((lane >> 3) & 1) * 8;
      ldsm_x4(bh, b_hi + nr * kLd + kc);
      if constexpr (kProd == 3) ldsm_x4(bl, b_lo + nr * kLd + kc);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          if constexpr (kProd == 3)
            add_split(acc[mt][2 * np + h], ah[mt], al[mt], bh + 2 * h,
                      bl + 2 * h);
          else
            add_single(acc[mt][2 * np + h], ah[mt], bh + 2 * h);
        }
    }
    // the last n8 tile: matrices (n 0-7, k 0-7), (n 0-7, k 8-15)
    uint32_t bh[2], bl[2];
    const int nr = wn * kWarpCols + (kNT - 1) * 8 + (lane & 7);
    const int kc = ks + ((lane >> 3) & 1) * 8;
    ldsm_x2(bh, b_hi + nr * kLd + kc);
    if constexpr (kProd == 3) ldsm_x2(bl, b_lo + nr * kLd + kc);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      if constexpr (kProd == 3)
        add_split(acc[mt][kNT - 1], ah[mt], al[mt], bh, bl);
      else
        add_single(acc[mt][kNT - 1], ah[mt], bh);
    }
  }
}

// The larger of (v, k) and (ov, ok), ties to the lower index.
__device__ __forceinline__ void take_max(float& v, int& k, float ov, int ok) {
  if (ov > v || (ov == v && ok < k)) {
    v = ov;
    k = ok;
  }
}

// The pair table: pair p = (a, b), a <= b, row-major over a.
__device__ __forceinline__ void build_pairs(uint16_t* pairs) {
  if (threadIdx.x < kD) {
    const int a = threadIdx.x, off = a * kD - a * (a - 1) / 2;
    for (int b = a; b < kD; ++b)
      pairs[off + b - a] = static_cast<uint16_t>(a | (b << 8));
  }
}

// One tile's logits, times -2, for the block's rows in xs: acc holds
// rows wm*32 + mt*16 + lane/4 (+ 8) and components wn*104 + nt*8 +
// 2 (lane % 4) (+ 1) of the tile. The one code of the three kernels, so
// that K8 and K9a recompute, bit for bit, the logits whose logsumexp K5
// lse computed; kProd products a k16 step (3 "split", 1 "bf16"). Starts
// with a __syncthreads (xs and the pair table written; the previous
// tile's readers of the stages done); ends with the last chunk
// multiplied, the stages and u's buffers still in use.
template <int kProd>
__device__ __forceinline__ void tile_logits(float (&acc)[kMT][kNT][4],
                                            const float* xs,
                                            const uint16_t* pairs,
                                            bf16* stages, bf16* us,
                                            const bf16* __restrict__ a_tile,
                                            const float* __restrict__ bc_tile,
                                            int wm, int wn, int lane) {
  const int tid = threadIdx.x, g = lane >> 2, tq = lane & 3;
  float* bcs = reinterpret_cast<float*>(stages);
  __syncthreads();
  // b (rows 0-63, [d][component]) and c (row 64) into the stages
  {
    const float4* src = reinterpret_cast<const float4*>(bc_tile);
    float4* dst = reinterpret_cast<float4*>(bcs);
    for (int i = tid; i < (kD + 1) * kKP / 4; i += kThreads)
      dst[i] = __ldg(src + i);
  }
  __syncthreads();

  // accumulators: -2 (b . x + c)
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  for (int d = 0; d < kD; ++d) {
    float xr[kMT][2];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        xr[mt][h] = xs[(wm * 32 + mt * 16 + g + 8 * h) * kXLd + d];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float2 b = *reinterpret_cast<const float2*>(
          bcs + d * kKP + wn * kWarpCols + nt * 8 + 2 * tq);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        acc[mt][nt][0] = fmaf(xr[mt][0], b.x, acc[mt][nt][0]);
        acc[mt][nt][1] = fmaf(xr[mt][0], b.y, acc[mt][nt][1]);
        acc[mt][nt][2] = fmaf(xr[mt][1], b.x, acc[mt][nt][2]);
        acc[mt][nt][3] = fmaf(xr[mt][1], b.y, acc[mt][nt][3]);
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float2 c = *reinterpret_cast<const float2*>(
        bcs + kD * kKP + wn * kWarpCols + nt * 8 + 2 * tq);
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      acc[mt][nt][0] = -2.f * (acc[mt][nt][0] + c.x);
      acc[mt][nt][1] = -2.f * (acc[mt][nt][1] + c.y);
      acc[mt][nt][2] = -2.f * (acc[mt][nt][2] + c.x);
      acc[mt][nt][3] = -2.f * (acc[mt][nt][3] + c.y);
    }
  }
  __syncthreads();  // b and c are read; the stages are free

  // main loop over the pair chunks: A's chunk c + 1 streams in and u's
  // chunk c + 1 is formed while chunk c is multiplied
  load_stage<kProd>(stages, a_tile);
  cp_async_commit();
  form_u<kProd>(us, xs, pairs, 0);
  for (int c = 0; c < kChunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c visible to all; chunk c - 1's buffers free
    if (c + 1 < kChunks) {
      load_stage<kProd>(stages + ((c + 1) & 1) * kStageElems,
                        a_tile + (size_t)(c + 1) * kTileElems);
      cp_async_commit();
      form_u<kProd>(us + ((c + 1) & 1) * kUElems, xs, pairs, c + 1);
    }
    mma_chunk<kProd>(acc, us + (c & 1) * kUElems,
                     stages + (c & 1) * kStageElems, wm, wn, lane);
  }
}

// Merges the running logsumexp (v, s: the maximum and the sum of
// exp(logit - v)) and argmax k with another's; ties to the lower index.
// A part that has seen no component is (-inf, 0).
__device__ __forceinline__ void take_lse(float& v, float& s, int& k, float ov,
                                         float os, int ok) {
  const float m = fmaxf(v, ov);
  if (m > -CUDART_INF_F) s = fmaf(s, expf(v - m), os * expf(ov - m));
  take_max(v, k, ov, ok);
}

// K5 lse's shared memory: the rows (float, padded), the pair table, A's
// two stages, u's two buffers and the reductions.
struct FwdSmem {
  float* xs;
  uint16_t* pairs;
  bf16* stages;
  bf16* us;
  float* red_v;
  int* red_k;
  float* red_s;
};

__device__ __forceinline__ FwdSmem fwd_smem(unsigned char* raw) {
  FwdSmem s;
  s.xs = reinterpret_cast<float*>(raw);
  s.pairs = reinterpret_cast<uint16_t*>(raw + kXBytes);
  s.stages = reinterpret_cast<bf16*>(raw + kXBytes + kPairBytes);
  s.us = reinterpret_cast<bf16*>(raw + kXBytes + kPairBytes + kStageBytes);
  s.red_v = reinterpret_cast<float*>(raw + kXBytes + kPairBytes +
                                     kStageBytes + kUBytes);
  s.red_k = reinterpret_cast<int*>(s.red_v + 3 * kBlockRows);
  s.red_s = reinterpret_cast<float*>(s.red_k + 3 * kBlockRows);
  return s;
}

// The logsumexp of the block's rows n0 .. n0 + 127 (in s.xs, the pair
// table built) over every tile of components, and the lowest index
// among equal maxima, written for the rows below n_total; kProd products
// a k16 step.
template <int kProd>
__device__ __forceinline__ void score_block(const FwdSmem& s,
                                            const bf16* __restrict__ a_pairs,
                                            const float* __restrict__ bc,
                                            int K, int n0, int n_total,
                                            float* __restrict__ values,
                                            int* __restrict__ argmax) {
  float* red_v = s.red_v;
  int* red_k = s.red_k;
  float* red_s = s.red_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int n_tiles = (K + kKP - 1) / kKP;

  const int g = lane >> 2, tq = lane & 3;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kKP;
    float acc[kMT][kNT][4];
    tile_logits<kProd>(acc, s.xs, s.pairs, s.stages, s.us,
                a_pairs + (size_t)tile * kChunks * kTileElems,
                bc + (size_t)tile * (kD + 1) * kKP, wm, wn, lane);

    // the tile's maximum, argmax and sum of exp(logit - maximum),
    // rescaled whenever the maximum grows: over the thread's components,
    // the quad, then the two warp columns and the earlier tiles
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float best = -CUDART_INF_F, sum = 0.f;
        int best_k = K;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = k0 + wn * kWarpCols + nt * 8 + 2 * tq + e;
            const float logit = -0.5f * acc[mt][nt][2 * h + e];
            if (k < K) {
              if (logit > best) {
                sum = fmaf(sum, expf(best - logit), 1.f);
                best = logit;
                best_k = k;
              } else {
                sum += expf(logit - best);
              }
            }
          }
#pragma unroll
        for (int m = 1; m < 4; m <<= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, best, m);
          const int ok = __shfl_xor_sync(0xffffffffu, best_k, m);
          take_lse(best, sum, best_k, ov,
                   __shfl_xor_sync(0xffffffffu, sum, m), ok);
        }
        if (tq == 0) {
          const int r = wm * 32 + mt * 16 + g + 8 * h;
          red_v[wn * kBlockRows + r] = best;
          red_k[wn * kBlockRows + r] = best_k;
          red_s[wn * kBlockRows + r] = sum;
        }
      }
    __syncthreads();
    if (tid < kBlockRows) {
      float best = red_v[tid], sum = red_s[tid];
      int best_k = red_k[tid];
      take_lse(best, sum, best_k, red_v[kBlockRows + tid],
               red_s[kBlockRows + tid], red_k[kBlockRows + tid]);
      if (tile > 0)
        take_lse(best, sum, best_k, red_v[2 * kBlockRows + tid],
                 red_s[2 * kBlockRows + tid], red_k[2 * kBlockRows + tid]);
      red_s[2 * kBlockRows + tid] = sum;
      red_v[2 * kBlockRows + tid] = best;
      red_k[2 * kBlockRows + tid] = best_k;
    }
  }
  // the rows' sums were merged by the threads that write them
  if (tid < kBlockRows && n0 + tid < n_total) {
    const int best_k = red_k[2 * kBlockRows + tid];
    values[n0 + tid] = red_v[2 * kBlockRows + tid] +
                       logf(red_s[2 * kBlockRows + tid]);
    argmax[n0 + tid] = best_k >= K ? 0 : best_k;
  }
}

// The block's rows n0 .. n0 + 127 of a (n_total, 64) float32 array into
// shared memory, rows ld floats apart, by coalesced float4 reads (a
// warp's 32 threads over 512 contiguous bytes); a row past the end is
// zero.
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int n0, int n_total) {
  const float4* s4 = reinterpret_cast<const float4*>(src);
  for (int i = threadIdx.x; i < kBlockRows * kD / 4; i += kThreads) {
    const int r = i / (kD / 4), c = 4 * (i % (kD / 4));
    const float4 v = n0 + r < n_total ? __ldg(s4 + (size_t)n0 * (kD / 4) + i)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
    float* d = dst + r * ld + c;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
}

// K5 lse split (K5 lse bf16 for kProd = 1): the logsumexp of rows
// (n_total, 64) float32, already masked and mean-subtracted, their patch
// tile loaded by load_rows.
template <int kProd>
__global__ void __launch_bounds__(kThreads, 1)
gmm_score_rows_tc_kernel(const float* __restrict__ rows, int n_total,
                         const bf16* __restrict__ a_pairs,
                         const float* __restrict__ bc, int K,
                         float* __restrict__ values,
                         int* __restrict__ argmax) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FwdSmem s = fwd_smem(smem_raw);
  const int n0 = blockIdx.x * kBlockRows;

  build_pairs(s.pairs);
  load_rows(s.xs, kXLd, rows, n0, n_total);
  score_block<kProd>(s, a_pairs, bc, K, n0, n_total, values, argmax);
}

// (A_k x) entries 2 lane and 2 lane + 1 of row x (shared memory). A_k is
// symmetric (the packing, ops/gmm_pack.py, forms it as P diag(w) P^T; the
// shipped GMMs' float32 A_k are symmetric bit for bit), so (A_k x)_c =
// sum_r A_k[r][c] x_r: the warp reads row r of A_k (256 bytes, from L2 or
// L1) coalesced.
__device__ __forceinline__ float2 row_ax(const float* x,
                                         const float* __restrict__ a,
                                         int lane) {
  const float2* A = reinterpret_cast<const float2*>(a) + lane;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll 8
  for (int r = 0; r < kD; r += 2) {
    const float2 a0 = __ldg(A + r * (kD / 2));
    const float2 a1 = __ldg(A + (r + 1) * (kD / 2));
    const float x0 = x[r], x1 = x[r + 1];
    t0 = fmaf(a0.x, x0, t0);
    t1 = fmaf(a0.y, x0, t1);
    t2 = fmaf(a1.x, x1, t2);
    t3 = fmaf(a1.y, x1, t3);
  }
  return make_float2(t0 + t2, t1 + t3);
}

// One nonzero weight w of row x and component k: g += w (b_k - A_k x),
// lane l taking entries 2l and 2l + 1.
__device__ __forceinline__ void marg_entry(float* grow, const float* x,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           float w, int lane) {
  const float2 ax = row_ax(x, a, lane);
  const float2 bk = __ldg(reinterpret_cast<const float2*>(b) + lane);
  float2* gp = reinterpret_cast<float2*>(grow) + lane;
  float2 gv = *gp;
  gv.x = fmaf(w, bk.x - ax.x, gv.x);
  gv.y = fmaf(w, bk.y - ax.y, gv.y);
  *gp = gv;
}

// g_k = t . (b_k - A_k x) of row x and tangent t (shared memory, t's
// rows 8-byte aligned), summed over the warp: every lane returns it.
__device__ __forceinline__ float marg_dot(const float* t, const float* x,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          int lane) {
  const float2 ax = row_ax(x, a, lane);
  const float2 bk = __ldg(reinterpret_cast<const float2*>(b) + lane);
  const float2 tv = reinterpret_cast<const float2*>(t)[lane];
  float s = fmaf(tv.x, bk.x - ax.x, tv.y * (bk.y - ax.y));
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

// The mixture kernels' shared memory: the rows (float, padded), the pair
// table, A's two stages, u's two buffers (a tile's weights overlay both
// once its main loop is done), the rows' logsumexp, weight sums and one
// more float each, then 128 float rows of kGLd: the gradient rows (K8
// split) or the tangents (K9a split).
struct MargSmem {
  float* xs;
  uint16_t* pairs;
  bf16* stages;
  bf16* us;
  float* lse;
  float* wsum;
  float* extra;
  float* rows2;
};

__device__ __forceinline__ MargSmem marg_smem(unsigned char* raw) {
  MargSmem s;
  s.xs = reinterpret_cast<float*>(raw);
  s.pairs = reinterpret_cast<uint16_t*>(raw + kXBytes);
  s.stages = reinterpret_cast<bf16*>(raw + kXBytes + kPairBytes);
  s.us = reinterpret_cast<bf16*>(raw + kXBytes + kPairBytes + kStageBytes);
  s.lse = reinterpret_cast<float*>(raw + kXBytes + kPairBytes + kStageBytes +
                                   kUBytes);
  s.wsum = s.lse + kBlockRows;
  s.extra = s.wsum + kBlockRows;
  s.rows2 = reinterpret_cast<float*>(raw + kXBytes + kPairBytes +
                                     kStageBytes + kUBytes + kRedBytes);
  return s;
}

// The logsumexp of the block's rows into shared memory: +inf for a row
// past the end (its weights are 0).
__device__ __forceinline__ void load_lse(float* lse_s,
                                         const float* __restrict__ lse,
                                         int n0, int n_total) {
  if (threadIdx.x < kBlockRows) {
    const int n = n0 + threadIdx.x;
    lse_s[threadIdx.x] = n < n_total ? __ldg(lse + n) : CUDART_INF_F;
  }
}

// marg_rows' entry of K8 split: row r's gradient row +=
// w (b_k - A_k x); nothing at the end of a tile.
struct MixEntry {
  float* grad;
  const float* xs;
  const float* __restrict__ a_full;
  const float* __restrict__ b_rows;
  int lane;
  __device__ __forceinline__ void operator()(int r, int k, float w) const {
    marg_entry(grad + r * kGLd, xs + r * kXLd, a_full + (size_t)k * kD * kD,
               b_rows + (size_t)k * kD, w, lane);
  }
  __device__ __forceinline__ void tile_done(const float*, int) const {}
};

// marg_rows' entry of K9a split: g_k = t . (b_k - A_k x) of row r to dp,
// and the row's heaviest weight so far and its g to w_ref[r], g_ref[r]
// (shared memory; components come in ascending order, so the lowest
// index among equal weights is kept), all by lane 0 of the warp that
// owns the row. At the end of a tile before the last (k0 < k_last) its
// weights go to p, a thread its own entries of wts (8 rows of 4
// components a warp store); the last tile's stay in wts.
struct DotEntry {
  const float* ts;
  const float* xs;
  const float* __restrict__ a_full;
  const float* __restrict__ b_rows;
  float* p;
  float* dp;
  float* w_ref;
  float* g_ref;
  int n0, n_total, K, k_last, lane;
  __device__ __forceinline__ void operator()(int r, int k, float w) const {
    const float gk = marg_dot(ts + r * kGLd, xs + r * kXLd,
                              a_full + (size_t)k * kD * kD,
                              b_rows + (size_t)k * kD, lane);
    if (lane == 0) {
      if (w > w_ref[r]) {
        w_ref[r] = w;
        g_ref[r] = gk;
      }
      if (n0 + r < n_total) dp[(size_t)k * n_total + n0 + r] = gk;
    }
  }
  __device__ __forceinline__ void tile_done(const float* wts, int k0) const {
    if (k0 == k_last) return;
    const int warp = threadIdx.x >> 5, wm = warp & 3, wn = warp >> 2;
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        if (n0 + r >= n_total) continue;
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int col = wn * kWarpCols + nt * 8 + 2 * tq;
          const float2 w =
              *reinterpret_cast<const float2*>(wts + r * kWLd + col);
          const size_t i = (size_t)(k0 + col) * n_total + n0 + r;
          if (k0 + col < K) p[i] = w.x;
          if (k0 + col + 1 < K) p[i + n_total] = w.y;
        }
      }
  }
};

// The mixture phase of the block's rows (xs, their logsumexp in lse_s)
// over every tile of components, the one code of K8 split and K9a
// split. Per tile: its logits (tile_logits), then the weights w =
// exp(logit - lse) into wts over the stages and u (0 for the padding
// components); then each warp over its 16 rows, 32 components at a
// time: a ballot per row finds the nonzero weights, and entry(r, k, w)
// runs for each (row, component) that has one, the whole warp together,
// rows in order (so that A_k stays in L1 across them), each row's
// components in ascending order; then entry.tile_done(wts, k0). Each
// row is summed by its one warp, so the result is deterministic without
// atomics, for any K and any number of nonzero weights. Skipping a zero
// weight is exact, and for the shipped GMMs nearly every weight
// underflows to 0. The rows' weight sums go to wsum_s. Ends with a
// __syncthreads. kProd products a k16 step in the logits.
template <int kProd, typename Entry>
__device__ __forceinline__ void marg_rows(
    const float* xs, const uint16_t* pairs, bf16* stages, bf16* us,
    const float* lse_s, float* wsum_s, const bf16* __restrict__ a_pairs,
    const float* __restrict__ bc, int K, const Entry& entry) {
  float* wts = reinterpret_cast<float*>(stages);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int g = lane >> 2, tq = lane & 3;
  const int n_tiles = (K + kKP - 1) / kKP;
  const int r0 = warp * kRowsPerWarp;
  float wsum = 0.f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * kKP;
    float acc[kMT][kNT][4];
    tile_logits<kProd>(acc, xs, pairs, stages, us,
                a_pairs + (size_t)tile * kChunks * kTileElems,
                bc + (size_t)tile * (kD + 1) * kKP, wm, wn, lane);
    __syncthreads();  // every warp's last chunk is multiplied

    // the weights w = exp(logit - lse), 0 for the padding components
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mt * 16 + g + 8 * h;
        const float l = lse_s[r];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const int col = wn * kWarpCols + nt * 8 + 2 * tq;
          float2 w;
          w.x = k0 + col < K ? expf(-0.5f * acc[mt][nt][2 * h] - l) : 0.f;
          w.y = k0 + col + 1 < K ? expf(-0.5f * acc[mt][nt][2 * h + 1] - l)
                                 : 0.f;
          *reinterpret_cast<float2*>(wts + r * kWLd + col) = w;
        }
      }
    __syncthreads();

    float part[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) part[i] = 0.f;
    for (int j = 0; j < kKP; j += 32) {
      const int col = j + lane;
      uint32_t nz[kRowsPerWarp];
      uint32_t any = 0;
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float w = col < kKP ? wts[(r0 + i) * kWLd + col] : 0.f;
        part[i] += w;
        nz[i] = __ballot_sync(0xffffffffu, w > 0.f);
        any |= nz[i];
      }
      while (any) {
        const int bit = __ffs(any) - 1;
        any &= any - 1;
        const int k = k0 + j + bit;
        uint32_t rows = 0;
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          rows |= ((nz[i] >> bit) & 1u) << i;
        while (rows) {
          const int r = r0 + __ffs(rows) - 1;
          rows &= rows - 1;
          entry(r, k, wts[r * kWLd + j + bit]);
        }
      }
    }
    // the tile's weight sums: each lane's, then over the warp
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      float s = part[i];
#pragma unroll
      for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
      if (lane == i) wsum += s;
    }
    entry.tile_done(wts, k0);
  }
  if (lane < kRowsPerWarp) wsum_s[r0 + lane] = wsum;
  __syncthreads();
}

// K8 split (K8 bf16 for kProd = 1): the marginalise unit gradient of
// rows (n_total, 64) float32 with K5 lse split's (bf16's) logsumexp,
// written to (n_total, 64) as whole lines.
template <int kProd>
__global__ void __launch_bounds__(kThreads, 1)
gmm_unit_marg_tc_kernel(const float* __restrict__ rows,
                        const float* __restrict__ lse, int n_total,
                        const bf16* __restrict__ a_pairs,
                        const float* __restrict__ bc,
                        const float* __restrict__ a_full,
                        const float* __restrict__ b_rows, int K,
                        float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MargSmem s = marg_smem(smem_raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBlockRows;

  build_pairs(s.pairs);
  load_rows(s.xs, kXLd, rows, n0, n_total);
  load_lse(s.lse, lse, n0, n_total);
  for (int i = tid; i < kBlockRows * kGLd; i += kThreads) s.rows2[i] = 0.f;
  marg_rows<kProd>(s.xs, s.pairs, s.stages, s.us, s.lse, s.wsum, a_pairs, bc,
                   K, MixEntry{s.rows2, s.xs, a_full, b_rows, tid & 31});

  // unit = (sum_k w_k (b_k - A_k x)) / sum_k w_k
  for (int i = tid; i < kBlockRows * kD; i += kThreads) {
    const int r = i / kD, c = i % kD;
    if (n0 + r < n_total)
      out[(size_t)(n0 + r) * kD + c] =
          s.rows2[r * kGLd + c] * (1.f / s.wsum[r]);
  }
}

// K9a split: the first stage of the marginalise Hessian action of rows
// (n_total, 64) float32 along tangents (n_total, 64), with K5 lse
// split's logsumexp: p and dp, (K, n_total). Per tile, for the nonzero
// weights, g_k = t . (b_k - A_k x) goes to dp, and w to p (but for the
// last tile, whose weights stay in shared memory) (DotEntry); each
// row's heaviest component's g is kept. Then a finishing pass over the
// block's rows, two threads a row, turns them into p = w / sum w and
// dp = p (g - g_ref - gbar), gbar = sum p (g - g_ref): a row whose
// weight sits on one component gets dp = 0 exactly (gmm_patch.cu's
// rule). dp is read only where w is nonzero, and written everywhere.
// K9a bf16 (kProd = 1) is the same with single-bf16 logits.
template <int kProd>
__global__ void __launch_bounds__(kThreads, 1)
gmm_hvp_marg_weights_tc_kernel(const float* __restrict__ rows,
                               const float* __restrict__ tangents,
                               const float* __restrict__ lse, int n_total,
                               const bf16* __restrict__ a_pairs,
                               const float* __restrict__ bc,
                               const float* __restrict__ a_full,
                               const float* __restrict__ b_rows, int K,
                               float* p, float* dp) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const MargSmem s = marg_smem(smem_raw);
  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBlockRows;

  build_pairs(s.pairs);
  load_rows(s.xs, kXLd, rows, n0, n_total);
  load_rows(s.rows2, kGLd, tangents, n0, n_total);
  load_lse(s.lse, lse, n0, n_total);
  // each row's heaviest weight so far (s.wsum, then its weight sum) and
  // its g (s.extra)
  if (tid < kBlockRows) s.wsum[tid] = -1.f;
  const int k_last = (K - 1) / kKP * kKP;
  marg_rows<kProd>(s.xs, s.pairs, s.stages, s.us, s.lse, s.wsum, a_pairs, bc,
                   K,
                   DotEntry{s.rows2, s.xs, a_full, b_rows, p, dp, s.wsum,
                            s.extra, n0, n_total, K, k_last, tid & 31});

  // the finishing pass: row r by threads r and r + 128, even and odd
  // components, the weights of the tiles before the last from p, of the
  // last from wts (shared memory; a single tile for K <= 208 never goes
  // through p); their partial sums meet in shared memory
  const float* wts = reinterpret_cast<const float*>(s.stages);
  float* part = s.extra + kBlockRows;
  const int r = tid % kBlockRows, half = tid / kBlockRows;
  const bool live = n0 + r < n_total;
  const size_t n = n0 + r;
  const float gr = s.extra[r];
  float w_total = 0.f, gsum = 0.f;
  if (live) {
#pragma unroll 4
    for (int k = half; k < K; k += 2) {
      const size_t i = (size_t)k * n_total + n;
      const float w = k >= k_last ? wts[r * kWLd + k - k_last] : p[i];
      w_total += w;
      if (w != 0.f) gsum = fmaf(w, dp[i] - gr, gsum);
    }
  }
  if (half) {
    part[r] = w_total;
    part[kBlockRows + r] = gsum;
  }
  __syncthreads();
  if (!half) {
    const float inv = 1.f / (w_total + part[r]);
    part[2 * kBlockRows + r] = inv;
    part[3 * kBlockRows + r] = (gsum + part[kBlockRows + r]) * inv;
  }
  __syncthreads();
  if (!live) return;
  const float inv = part[2 * kBlockRows + r];
  const float gbar = part[3 * kBlockRows + r];  // sum_k p_k g_k - g_ref
#pragma unroll 4
  for (int k = half; k < K; k += 2) {
    const size_t i = (size_t)k * n_total + n;
    const float w = k >= k_last ? wts[r * kWLd + k - k_last] : p[i];
    const float pk = w * inv;
    p[i] = pk;
    dp[i] = w != 0.f ? pk * ((dp[i] - gr) - gbar) : 0.f;
  }
}

// Launches a mixture kernel on rows (n, 64) with the shared memory of
// the mixture kernels (MargSmem).
template <typename Kernel, typename... Args>
int launch_rows(Kernel kernel, int n, void* stream, Args... args) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBwd);
  const int blocks = (n + kBlockRows - 1) / kBlockRows;
  kernel<<<blocks, kThreads, kSmemBwd, static_cast<cudaStream_t>(stream)>>>(
      args...);
  const cudaError_t launch = cudaGetLastError();
  return static_cast<int>(attr != cudaSuccess ? attr : launch);
}

// The products a k16 step that the kernels are instantiated for.
bool valid_products(int products) { return products == 1 || products == 3; }

}  // namespace

extern "C" {

// a_pairs holds ceil(K / 208) tiles of A's chunks, bc as many tiles of b
// and c (ops/gmm_fused.py::kernel_buffers); products is 3 ("split") or 1
// ("bf16"). Each entry returns the first CUDA error of setting the
// shared-memory size and the launch (0 = cudaSuccess); 1
// (cudaErrorInvalidValue) for K < 1 or another number of products. The
// wrappers never call them with n = 0.
//
// K5 lse split or bf16 on rows (n, 64) float32: values (the logsumexp)
// and argmax (the lowest index among equal maxima).
int gmm_score_rows_tc(const void* rows, int n, const void* a_pairs,
                      const void* bc, int K, int products, void* values,
                      void* argmax, void* stream) {
  if (K < 1 || !valid_products(products))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = products == 3 ? gmm_score_rows_tc_kernel<3>
                              : gmm_score_rows_tc_kernel<1>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemFwd);
  const int blocks = (n + kBlockRows - 1) / kBlockRows;
  kernel<<<blocks, kThreads, kSmemFwd, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rows), n, static_cast<const bf16*>(a_pairs),
      static_cast<const float*>(bc), K, static_cast<float*>(values),
      static_cast<int*>(argmax));
  const cudaError_t launch = cudaGetLastError();
  return static_cast<int>(attr != cudaSuccess ? attr : launch);
}

// K8 split on rows (n, 64) float32 with lse (n,), the logsumexp that
// gmm_score_rows_tc computed for them with the same products (the weights
// are exp(logit - lse) of the same logits), A (K, 64, 64) and b (K, 64);
// out (n, 64).
int gmm_unit_marg_tc(const void* rows, const void* lse, int n,
                     const void* a_pairs, const void* bc, const void* a_full,
                     const void* b_rows, int K, int products, void* out,
                     void* stream) {
  if (K < 1 || !valid_products(products))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows(products == 3 ? gmm_unit_marg_tc_kernel<3>
                                   : gmm_unit_marg_tc_kernel<1>,
                     n, stream,
                     static_cast<const float*>(rows),
                     static_cast<const float*>(lse), n,
                     static_cast<const bf16*>(a_pairs),
                     static_cast<const float*>(bc),
                     static_cast<const float*>(a_full),
                     static_cast<const float*>(b_rows), K,
                     static_cast<float*>(out));
}

// K9a split on rows and tangents (n, 64) float32 with lse as
// gmm_unit_marg_tc; p and dp (K, n).
int gmm_hvp_marg_weights_tc(const void* rows, const void* tangents,
                            const void* lse, int n, const void* a_pairs,
                            const void* bc, const void* a_full,
                            const void* b_rows, int K, int products, void* p,
                            void* dp, void* stream) {
  if (K < 1 || !valid_products(products))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows(products == 3 ? gmm_hvp_marg_weights_tc_kernel<3>
                                   : gmm_hvp_marg_weights_tc_kernel<1>,
                     n, stream,
                     static_cast<const float*>(rows),
                     static_cast<const float*>(tangents),
                     static_cast<const float*>(lse), n,
                     static_cast<const bf16*>(a_pairs),
                     static_cast<const float*>(bc),
                     static_cast<const float*>(a_full),
                     static_cast<const float*>(b_rows), K,
                     static_cast<float*>(p), static_cast<float*>(dp));
}

const char* gmm_fused_tc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
