// The GMM scorer on Hopper's warpgroup instructions (sm_90a), one core
// for every mode of the precision dial: K1's forward on an image, MAP
// (gmm_score_wg_image) and logsumexp (gmm_score_wg_image_lse), and K4,
// the marginalise backward (gmm_score_wg_mix); K5 on rows
// (gmm_score_wg_rows): its MAP scorer in "split" and "bf16", its
// logsumexp in every mode; and the marginalised probe's K8, the unit
// gradient (gmm_score_wg_unit), and K9a, the first stage of the Hessian
// action (gmm_score_wg_weights), in every mode: "f32" ("highest"),
// "split" (the default dial) and "bf16" ("default"). Built by nvcc into a
// shared library with a plain C interface and loaded with ctypes
// (jolideco_torch/utils/cuda_build.py); the wrappers are gmm_fused_fwd*,
// gmm_fused_fwd_marg* and gmm_fused_bwd_marg* in
// jolideco_torch/ops/gmm_fused.py and gmm_score_rows*, gmm_unit_marg*
// and gmm_hvp_marg_weights* in jolideco_torch/ops/gmm_pallas.py, whose
// plain versions (fused_forward_plain, fused_backward_marg_plain,
// score_*_plain, unit_marg_plain, marg_unit_*_plain,
// hvp_marg_weights*_plain) the card holds them to.
//
// What it replaces: the JAX package's ops/gmm_fused.py::_fwd_kernel (both
// branches), ::_bwd_marg_kernel, ops/gmm_pallas.py::_score_kernel (both
// reductions), ::_unit_marg_kernel and ::_hvp_marg_weights_kernel under
// precision HIGHEST (kProd = 6, the six products of three-way splits
// below), HIGH ("split3", kProd = 3: hi.hi + hi.lo + lo.hi of the bf16
// hi/lo parts) and DEFAULT (kProd = 1: hi.hi); and in this port the
// FFMA kernels of gmm_fused.cu and gmm_patch.cu (K1, K1 lse, K4, K5 lse,
// K8, K9a) and the mma.sync kernels of gmm_fused_tc.cu (all deleted). Per
// row x (a masked, mean-subtracted 8x8 patch),
//     logit_k = -1/2 x^T A_k x + b_k . x + c_k,
// the quadratic form as the product of the 2,080 pair products u = x_a
// x_b (a <= b) with the pair-major A (off-diagonals doubled), then the
// maximum and the lowest index among equal maxima (kMax), or beside them
// the logsumexp (kLse), or from the forward's logsumexp a mixture of the
// weights w_k = exp(logit_k - lse): K4's (kMix)
//     u = dv sum_k w_k (b_k - A_k x) / sum_k w_k,
// less its mean, then the overlap-add into the image gradient; K8's
// (kUnit), the same without dv and the mean, into the u rows; or K9a's
// (kWeights) p = w / sum w and dp_k = p_k (g_k - sum_j p_j g_j), g_k = t
// . (b_k - A_k x). K4 recomputes K1 lse's logits, and K8 and K9a K5 lse's,
// by the very same instance of the core's main loop (kProd, the tile and
// flush order) on the very floats the logsumexp scored: over logits of
// 1e5 to 1e8 an lse summed in another order would move exp(logit - lse)
// by whole units of the exponent. Only the epilogue differs.
//
// What bounds it on the H100: operations. At 1024^2 (65,536 patches),
// K = 200: 3 x 2 x 65,536 x 200 x 2,144 flop = 0.17 ms at the bf16 peak
// of 989 TFLOP/s (one product: 0.057 ms; six: 0.341 ms, K4 with the
// mixture's float32 terms about the same); bytes are 4 MB in and 17 MB
// out (0.006 ms). Beside the products, the CUDA cores form u, add each
// group of products to the running sums and reduce, and A's 1.7 MB a
// tile of components (2.5 MB in three planes) flows from L2 into every
// CTA once for each of its tiles of rows (0.89 GB at 1024^2; 1.28 GB).
//
// The design:
// - one CTA of three warpgroups on each SM, persistent, walking over tiles
//   of 128 rows (blockIdx.x, + gridDim.x, ...);
// - warpgroups 0 and 1 multiply, 64 rows each, by wgmma.mma_async
//   m64n200k16 (bf16 in, float32 out): A is u, formed by each thread from
//   the rows in shared memory (stored transposed, [feature][row], so that
//   the fragment loads fall on distinct banks) straight into the m16n8k16
//   fragment registers and split into bf16 parts (hi and lo for "split",
//   tc_frag.cuh's put_operand; hi alone for "bf16"; hi, mid and lo for
//   "f32", put_parts3); B is A's chunk of components in shared memory,
//   K-major 8 x 8 core matrices (no swizzle): 32 pairs a stage in one or
//   two planes, or, in "f32", one k16 step of 16 pairs in three (hi, mid,
//   lo: 19,200 bytes);
// - each group of products goes into fresh accumulators (the first with
//   scale-d = 0), which after wgmma.wait_group are added to the running
//   float32 sums on the CUDA cores: the tensor cores carry no sum across
//   groups (sums they carried across all 130 steps lay 4.5e-6, relative,
//   above the exact sums on an H100; chip_smoke.py phase 2 holds these to
//   the bars of that finding). A group is a chunk's two k16 steps in the bf16 modes, one
//   k16 step's six products in "f32" (the products of parts i + j <= 2,
//   the small ones first, as the JAX package's HIGHEST): the tensor cores'
//   float32 sums truncate, and hi.hi, one instruction a group, meets at
//   most five smaller products there. The two warpgroups take turns to
//   issue (two named barriers), so that one's adds and fragments run
//   while the other's products do;
// - b . x + c off the CUDA cores' loop: the accumulators start at -2 c
//   (in "f32" at zero, -2 c added after the pairs: minus_2c), then -2 b .
//   x runs as four k16 steps of the six products, x and -2 b each split
//   into three bf16 parts (float32's 24 bits), into fresh accumulators
//   added as the pairs' are; -2 b's parts (77 KB with c) stay in shared
//   memory while the tile of components does (for K <= 200 the whole
//   run);
// - warpgroup 2 is cut to 40 registers by setmaxnreg (the multiplying
//   warpgroups get 232): one thread keeps A's chunks in flight in a ring
//   of shared-memory stages (3 for "split", 6 for "bf16", 4 for "f32"),
//   each a bulk copy of the chunk's image (ops/gmm_fused.py::_wg_buffers
//   and _wg3_buffer lay the device buffers out as the stages' bytes)
//   completing on the stage's mbarrier; its other three warps load the
//   next tile's rows (K1: the patches, masked and mean-subtracted, also
//   written to xtn and valid) into the
//   second of two row buffers while the current tile is multiplied;
// - kMax and kLse: the maximum (and the sum of exp(logit - maximum),
//   rescaled whenever the maximum grows) over each thread's 50
//   components, then over the four threads of a quad (shuffles), then
//   over the tiles of components (in registers), ties to the lower index,
//   in one fixed order;
// - kMix (K4, the rows from xtn: the very floats K1 lse wrote into its
//   row buffer, so that the same core gives K1 lse's logits bit for bit):
//   each thread writes its weights w = exp(logit - lse) to the CTA's
//   slice of a scratch in L2 (kRows x kKP floats); then each warp takes
//   its 16 rows 32 components at a time, a ballot a row finding the
//   nonzero weights, and runs each weighed component's terms w (b_k - A_k
//   x) in float32 with the whole warp, lane l taking entries 2l and 2l +
//   1 of A_k x while the warp reads A_k row by row, components in
//   ascending order (each_weighted, mix_rows): for one row alone (row_ax)
//   or, where several rows weigh the component, for all 16 at once
//   (rows_ax). For the shipped GMMs about one weight a row is nonzero
//   (their logits' gaps exceed the ~104 at which exp underflows) and
//   skipping a zero term is exact; a GMM of mixed weights runs all of
//   them, A_k read once a warp. The rows' sums carry across tiles of
//   components through the output rows and a scratch of weight sums;
//   after the last, dv / sum w, less the row's mean, into the u rows (N,
//   64), and a second launch adds them into the image (gmm_patches.cuh's
//   patch_units_at, K2's epilogue). No atomics: the same bits every call;
// - kUnit (K8, the probe's rows with K5 lse's logsumexp): kMix's weights
//   and mixture, u = g / sum w straight into the (N, 64) output, one
//   launch;
// - kWeights (K9a): the same weights; for each nonzero one g_k = t . (b_k
//   - A_k x) in float32 (A_k x as kMix's, lane l reading t's entries 2l
//   and 2l + 1 from the tangent rows in device memory, a warp sum) into
//   dp at (k, n), the heaviest weight's g kept a row (ties to the lower
//   index); after the last tile a pass over the warp's rows turns w and g
//   into p and dp (K, N), g taken against the heaviest component's, so
//   that a row whose weight sits on one component gets p = 1 and dp = 0
//   exactly (weigh_rows); past one tile of components the weights go to
//   p tile by tile and the heaviest weight and its g to a scratch.
// Any K: tiles of 200 components one after another (the last padded with
// zero components, masked out of the reductions).
//
// A first version, with a k16 step a flush, b . x by FMAs interleaved
// with the chunks (its loads waited one at a time on the few registers
// left) and a cluster of two CTAs sharing each chunk by a multicast bulk
// copy (whose handshake a chunk cost more than the halved L2 reads saved),
// was no faster than the mma.sync kernel it replaced; those three went.
// On an NVIDIA H100 80GB HBM3 (700 W limit) at 1024^2, K = 200,
// astro-snr-v1 (scripts/torch_marg_f32_times.py, in turns with the
// kernels each instance replaced): K1 MAP 0.46 ms in "f32" (the FFMA
// kernel 1.63), 0.28 in "split", 0.20 in "bf16"; K1 lse 0.50, 0.31 (the
// mma.sync kernel 0.76), 0.24 (0.44); K4 0.61, 0.39 (0.86), 0.31 (0.56);
// under mixed weights (200 a row) K4 5.9, 5.6 (14.4), 5.5 (14.2), its
// float32 mixture the same code in every mode. The probe's K5 lse, K8
// and K9a at 65,025 rows: see PERF.md (scripts/torch_marg_f32_times.py
// --probe). The multiplying warpgroups have 232 registers; the image
// instances spill 56-84 bytes (the split logsumexp the most), the row,
// K4, K8 and K9a instances 0-16.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

#include "gmm_patches.cuh"
#include "tc_frag.cuh"
#include "wg_hopper.cuh"

namespace {

using gmm::kD;
using gmm::kP;
using tc::bf16;

constexpr int kPairs = kD * (kD + 1) / 2;  // 2,080 pairs a <= b
constexpr int kKP = wg::kMmaN;             // components a tile: 200
constexpr int kRegs = wg::kMmaRegs;        // accumulators a thread: 100
constexpr int kKC = 32;                    // pairs a chunk
constexpr int kChunks = kPairs / kKC;      // 65
constexpr int kStep3 = 16;                 // pairs a stage of "f32"
constexpr int kRows = 128;                 // rows a CTA tile
constexpr int kThreads = 384;              // three warpgroups
constexpr int kXLd = kRows + 4;            // transposed row buffer stride
constexpr int kXFloats = kD * kXLd;
constexpr int kPlaneBytes = kKP * kKC * 2;  // 12,800: a bf16 plane
constexpr int kPlane3 = kKP * kStep3 * 2;   // 6,400: a plane of "f32"
constexpr int kLinPart = kKP * kD * 2;      // 25,600: a bf16 part of -2 b
constexpr int kCQuads = 13;                 // float4s of c a thread
constexpr int kLinBytes = 3 * kLinPart + 4 * 16 * kCQuads;  // 77,632
constexpr int kLoaders = 96;                // warps 9-11
constexpr int kConsumerWarps = 8;
constexpr int kAddThreads = 256;
static_assert(kPairs % kKC == 0 && kKC == 32, "two k16 steps a chunk");
static_assert(kPairs % kStep3 == 0 && kStep3 == 16, "a k16 step a stage");

// the epilogues: the maximum (K1, K5 MAP), the logsumexp (K1 lse, K5
// lse), the marginalise backward's mixture (K4), the marginalise unit
// gradient (K8) and the first stage of its Hessian action (K9a)
constexpr int kMax = 0;
constexpr int kLse = 1;
constexpr int kMix = 2;
constexpr int kUnit = 3;
constexpr int kWeights = 4;

// Shared memory: the ring of A's chunks (kStage bytes a stage, the first
// kStage of each kRecord-byte record of the device buffer: kStages
// records a tile of components), the linear terms (b's three parts, c),
// two row buffers, the pair table and the barriers.
template <int kProd>
struct Layout {
  static constexpr bool kF32 = kProd == 6;
  static constexpr int kStage =
      kF32 ? 3 * kPlane3 : kProd == 3 ? 2 * kPlaneBytes : kPlaneBytes;
  static constexpr int kRecord = kF32 ? kStage : 2 * kPlaneBytes;
  static constexpr int kStages = kF32 ? kPairs / kStep3 : kChunks;
  static constexpr int kDepth = kF32 ? 4 : kProd == 3 ? 3 : 6;
  static constexpr int kLinOffset = kDepth * kStage;
  static constexpr int kXOffset = kLinOffset + kLinBytes;
  static constexpr int kPairOffset = kXOffset + 2 * kXFloats * 4;
  static constexpr int kBarOffset = kPairOffset + kPairs * 2;
  static constexpr int kSmem = kBarOffset + (2 * kDepth + 6) * 8;
  static_assert(kStage % 128 == 0 && kLinBytes % 16 == 0, "aligned");
  static_assert(kBarOffset % 8 == 0, "aligned barriers");
  static_assert(kSmem <= 232448, "shared memory of a CTA");
};

// Where a CTA reads its rows: an image's patches (K1) or rows (K5, K4).
struct Source {
  const float* img;
  int H, W, stride, ny, nx;
  float sentinel;
  float* valid;
  float* xtn;
  const float* rows;
  int n_total;
};

// What a CTA writes. kMax, kLse: the values (maximum or logsumexp) and
// argmax of the rows. kMix (K4): from the forward's logsumexp, valid and
// cotangents of the rows, the components' A_k (row-major) and b_k, the u
// rows (N, 64); scratch: the weights of each CTA's tile (kRows x kKP
// floats a CTA) and the rows' weight sums. kUnit (K8): the same from the
// logsumexp alone (no valid, no cotangents). kWeights (K9a): from the
// logsumexp and the tangents (N, 64), p and dp (K, N); scratch: the
// weights and the rows' heaviest weight and its g (ref, 2N).
struct Out {
  float* values;
  int* argmax;
  const float* lse;
  const float* valid;
  const float* dv;
  const float* a_full;
  const float* b_rows;
  float* wts;
  float* wsum;
  float* units;
  const float* tangents;
  float* ref;
  float* p;
  float* dp;
};

// Row r of a CTA's tile (row n of the whole) into the transposed buffer
// xs. K1: patch n, masked and mean-subtracted (its mean summed in feature
// order), written to xtn and valid too, read twice to spare registers;
// K5, K4: row n. Past the end: zeros, nothing written.
template <bool kImage>
__device__ __forceinline__ void load_row(float* xs, int r, int n,
                                         const Source& s) {
  if (n >= s.n_total) {
#pragma unroll 8
    for (int c = 0; c < kD; ++c) xs[c * kXLd + r] = 0.f;
    return;
  }
  if constexpr (kImage) {
    const gmm::PatchPos p =
        gmm::patch_pos(n, s.H, s.W, s.stride, s.ny, s.nx);
    bool ok = p.inside;
    float sum = 0.f;
    const float* base =
        s.img + (size_t)(p.a + kP * p.i) * s.W + (p.b + kP * p.j);
    if (ok) {
#pragma unroll 8
      for (int c = 0; c < kD; ++c) {
        const float v = __ldg(base + (size_t)(c >> 3) * s.W + (c & 7));
        ok = ok && (v > s.sentinel);
        sum += v;
      }
    }
    const float mean = ok ? sum * (1.f / kD) : 0.f;
    float4* dst = reinterpret_cast<float4*>(s.xtn + (size_t)n * kD);
#pragma unroll 2
    for (int c = 0; c < kD; c += 4) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = ok ? __ldg(base + (size_t)((c + e) >> 3) * s.W + ((c + e) & 7))
                        - mean
                  : 0.f;
        xs[(c + e) * kXLd + r] = v[e];
      }
      dst[c / 4] = make_float4(v[0], v[1], v[2], v[3]);
    }
    s.valid[n] = ok ? 1.f : 0.f;
  } else {
    const float4* src = reinterpret_cast<const float4*>(s.rows) +
                        (size_t)n * (kD / 4);
#pragma unroll 4
    for (int c = 0; c < kD; c += 4) {
      const float4 v = __ldg(src + c / 4);
      xs[c * kXLd + r] = v.x;
      xs[(c + 1) * kXLd + r] = v.y;
      xs[(c + 2) * kXLd + r] = v.z;
      xs[(c + 3) * kXLd + r] = v.w;
    }
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

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, 4);
  return u;
}

// The pair v into register q of three bf16 parts p[0] + p[1] + p[2] (each
// the rounding of what the earlier ones leave, as put_split's hi and lo):
// float32's 24 bits.
__device__ __forceinline__ void put_parts3(uint32_t (&p)[3][4], int q,
                                           float2 v) {
#pragma unroll
  for (int part = 0; part < 3; ++part) {
    const __nv_bfloat162 b = __float22bfloat162_rn(v);
    const float2 f = __bfloat1622float2(b);
    p[part][q] = bits(b);
    v = make_float2(v.x - f.x, v.y - f.y);
  }
}

// u's fragment of k16 step `step` for rows r0 and r0 + 8 of the tile:
// registers q = 0..3 hold (row r0 + 8 (q & 1), pairs 16 step + 2t + 8
// (q >> 1) and + 1), split into bf16 hi and lo (hi alone for one
// product) by put_operand, or into three parts (kProd = 6, hi in hi[0]).
template <int kProd, int kParts>
__device__ __forceinline__ void form_fragment(uint32_t (&p)[kParts][4],
                                              const float* xs,
                                              const uint16_t* pairs, int step,
                                              int r0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint32_t ab = *reinterpret_cast<const uint32_t*>(
        pairs + 16 * step + 2 * t + 8 * half);
    const int a0 = ab & 0xff, b0 = (ab >> 8) & 0xff;
    const int a1 = (ab >> 16) & 0xff, b1 = ab >> 24;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      const float2 v = make_float2(xs[a0 * kXLd + r] * xs[b0 * kXLd + r],
                                   xs[a1 * kXLd + r] * xs[b1 * kXLd + r]);
      if constexpr (kProd == 6) {
        put_parts3(p, 2 * half + h, v);
      } else {
        __nv_bfloat162 vh, vl;
        tc::put_operand<kProd>(reinterpret_cast<bf16*>(&vh),
                               reinterpret_cast<bf16*>(&vl), 0, v);
        p[0][2 * half + h] = bits(vh);
        if constexpr (kProd == 3) p[1][2 * half + h] = bits(vl);
      }
    }
  }
}

// x's fragment of k16 step `step` of b . x (features 16 step ..) for rows
// r0 and r0 + 8, in three bf16 parts (put_parts3).
__device__ __forceinline__ void form_x_parts(uint32_t (&p)[3][4],
                                             const float* xs, int step,
                                             int r0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * step + 2 * t + 8 * half, r = r0 + 8 * h;
      put_parts3(p, 2 * half + h,
                 make_float2(xs[d * kXLd + r], xs[(d + 1) * kXLd + r]));
    }
}

// Keeps a group's fragments in their registers until the products that
// read them are done (called after the wait that covers them): an
// asynchronous product reads its A registers after the instruction.
template <int kParts>
__device__ __forceinline__ void fence_fragment(uint32_t (&p)[kParts][4]) {
#pragma unroll
  for (int part = 0; part < kParts; ++part)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(p[part][q])::"memory");
}

// B's descriptor: 8 x 8 core matrices, 128 bytes apart along K, `sbo`
// bytes between groups of eight components.
__device__ __forceinline__ uint64_t b_desc(const unsigned char* p, int sbo) {
  return wg::smem_desc(p, 128, sbo);
}

// One k16 step of u . A: kProd products, the small ones first (as
// add_split), into fresh accumulators when `fresh`, else chained onto t.
template <int kProd, bool fresh>
__device__ __forceinline__ void issue_step(float (&t)[kRegs],
                                           const uint32_t (&hi)[4],
                                           const uint32_t (&lo)[4],
                                           const unsigned char* stage,
                                           int s) {
  const uint64_t b_hi = b_desc(stage + 256 * s, 512);
  if constexpr (kProd == 3) {
    const uint64_t b_lo = b_desc(stage + kPlaneBytes + 256 * s, 512);
    if constexpr (fresh)
      wg::wgmma_n200_zero(t, lo, b_hi);
    else
      wg::wgmma_n200_acc(t, lo, b_hi);
    wg::wgmma_n200_acc(t, hi, b_lo);
    wg::wgmma_n200_acc(t, hi, b_hi);
  } else if constexpr (fresh) {
    wg::wgmma_n200_zero(t, hi, b_hi);
  } else {
    wg::wgmma_n200_acc(t, hi, b_hi);
  }
}

// One k16 step in six products of the parts, a_i b_j for i + j <= 2
// (parts from 0), the smallest first, into fresh accumulators: float32's
// accuracy, as the JAX package's HIGHEST. `b(j)` is the descriptor of
// B's part j: -2 b's (b . x) or A's (u . A, "f32").
template <class Desc>
__device__ __forceinline__ void issue_six(float (&t)[kRegs],
                                          const uint32_t (&a)[3][4],
                                          Desc&& b) {
  wg::wgmma_n200_zero(t, a[2], b(0));
  wg::wgmma_n200_acc(t, a[1], b(1));
  wg::wgmma_n200_acc(t, a[0], b(2));
  wg::wgmma_n200_acc(t, a[1], b(0));
  wg::wgmma_n200_acc(t, a[0], b(1));
  wg::wgmma_n200_acc(t, a[0], b(0));
}

// acc += t once the group's products are done: the float32 sums of the
// logits, rounded to nearest on the CUDA cores.
__device__ __forceinline__ void flush(float (&acc)[kRegs], float (&t)[kRegs]) {
  wg::wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    wg::fence_operand(t[i]);
    acc[i] += t[i];
  }
}

// acc = -2 c (kInit) or acc += -2 c, c from the linear terms in shared
// memory (thread t of a quad: components 8 j + 2 t and + 1). The bf16
// modes start their sums at -2 c; "f32" adds it after the pairs: c is
// about the size of the logits (80 for the random GMMs of the CPU tests,
// the quadratic form's sums a third of that), and every flush onto a sum
// started at -2 c rounds at that size (ten times the float32 plain
// version's error in the logits there, where this order keeps 1.3
// times).
template <bool kInit>
__device__ __forceinline__ void minus_2c(float (&acc)[kRegs],
                                         const unsigned char* lin, int t) {
  const float4* c4 =
      reinterpret_cast<const float4*>(lin + 3 * kLinPart) + kCQuads * t;
#pragma unroll
  for (int q = 0; q < kCQuads; ++q) {
    const float4 c = c4[q];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n8 = 2 * q + h;
      if (n8 < kKP / 8) {
        const float c0 = -2.f * (h ? c.z : c.x), c1 = -2.f * (h ? c.w : c.y);
        if constexpr (kInit) {
          acc[4 * n8] = acc[4 * n8 + 2] = c0;
          acc[4 * n8 + 1] = acc[4 * n8 + 3] = c1;
        } else {
          acc[4 * n8] += c0;
          acc[4 * n8 + 2] += c0;
          acc[4 * n8 + 1] += c1;
          acc[4 * n8 + 3] += c1;
        }
      }
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

// Merges the running logsumexp (v, s: the maximum and the sum of
// exp(logit - v)) and argmax k with another's; ties to the lower index.
// A part that has seen no component is (-inf, 0).
__device__ __forceinline__ void take_lse(float& v, float& s, int& k, float ov,
                                         float os, int ok) {
  const float m = fmaxf(v, ov);
  if (m > -CUDART_INF_F) s = fmaf(s, expf(v - m), os * expf(ov - m));
  take_max(v, k, ov, ok);
}

// (A_k x) entries 2 lane and 2 lane + 1 of the row whose feature r is
// x[r kXLd] (the transposed row buffer). A_k is symmetric (the packing,
// ops/gmm_pack.py, forms it as P diag(w) P^T), so (A_k x)_c = sum_r
// A_k[r][c] x_r: the warp reads row r of A_k (256 bytes, from L2 or L1)
// coalesced, and each x_r is a shared-memory broadcast.
__device__ __forceinline__ float2 row_ax(const float* x,
                                         const float* __restrict__ a,
                                         int lane) {
  const float2* A = reinterpret_cast<const float2*>(a) + lane;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
#pragma unroll 8
  for (int r = 0; r < kD; r += 2) {
    const float2 a0 = __ldg(A + r * (kD / 2));
    const float2 a1 = __ldg(A + (r + 1) * (kD / 2));
    const float x0 = x[r * kXLd], x1 = x[(r + 1) * kXLd];
    t0 = fmaf(a0.x, x0, t0);
    t1 = fmaf(a0.y, x0, t1);
    t2 = fmaf(a1.x, x1, t2);
    t3 = fmaf(a1.y, x1, t3);
  }
  return make_float2(t0 + t2, t1 + t3);
}

// (A_k x_i) entries 2 lane and 2 lane + 1 of the 16 rows whose feature r
// is x[r kXLd + i] (16 neighbours of the transposed row buffer): A_k read
// once for all of them, row r by the warp, coalesced, and x_r of the 16
// rows as four shared-memory broadcasts.
__device__ __forceinline__ void rows_ax(float2 (&ax)[16], const float* x,
                                        const float* __restrict__ a,
                                        int lane) {
  const float2* A = reinterpret_cast<const float2*>(a) + lane;
#pragma unroll
  for (int i = 0; i < 16; ++i) ax[i] = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int r = 0; r < kD; ++r) {
    const float2 av = __ldg(A + r * (kD / 2));
    const float4* xr = reinterpret_cast<const float4*>(x + r * kXLd);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = xr[q];
      const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ax[4 * q + e].x = fmaf(av.x, xv[e], ax[4 * q + e].x);
        ax[4 * q + e].y = fmaf(av.y, xv[e], ax[4 * q + e].y);
      }
    }
  }
}

// Calls term(i, k, w, ax, b) for each component k of a tile (k0 .. k0 +
// kKP - 1) that some of a warp's 16 rows weigh (their features x[r kXLd +
// i], their weights at w_rows, kKP a row), components in ascending
// order, 32 at a time, one ballot a row finding the nonzero weights; w is
// row i's weight of k, ax and b lane l's entries 2l and 2l + 1 of A_k x_i
// and b_k. A component that one row weighs runs that row alone (row_ax:
// the shipped GMMs, about one a row), term(r, ...) with r that row; one
// that several rows weigh runs all 16 (rows_ax: A_k read once for them),
// term(i, ...) for each row i in order, of which the rows whose weight is
// 0 add exactly nothing (K4, K8) or are skipped (K9a). part[i] gathers
// the lane's share of row i's weight sum.
template <class Term>
__device__ __forceinline__ void each_weighted(const float* x,
                                              const float* w_rows, int k0,
                                              const Out& out,
                                              float (&part)[16], int lane,
                                              Term&& term) {
  for (int j = 0; j < kKP; j += 32) {
    float w[16];
    uint32_t nz[16], any = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      w[i] = j + lane < kKP ? w_rows[i * kKP + j + lane] : 0.f;
      part[i] += w[i];
      nz[i] = __ballot_sync(0xffffffffu, w[i] > 0.f);
      any |= nz[i];
    }
    while (any) {
      const int bit = __ffs(any) - 1;
      any &= any - 1;
      uint32_t on = 0;
#pragma unroll
      for (int i = 0; i < 16; ++i) on |= ((nz[i] >> bit) & 1u) << i;
      const int k = k0 + j + bit;
      const float* a = out.a_full + (size_t)k * kD * kD;
      const float2 b = __ldg(
          reinterpret_cast<const float2*>(out.b_rows + (size_t)k * kD) +
          lane);
      if (__popc(on) == 1) {
        const int r = __ffs(on) - 1;
        float wr = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) wr = i == r ? w[i] : wr;
        term(r, k, __shfl_sync(0xffffffffu, wr, bit), row_ax(x + r, a, lane),
             b);
      } else {
        float2 ax[16];
        rows_ax(ax, x, a, lane);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          term(i, k, __shfl_sync(0xffffffffu, w[i], bit), ax[i], b);
      }
    }
  }
}

// The marginalise mixture of a warp's 16 rows n0 .. n0 + 15 (the first
// `rows` of them before the end; their features x[r kXLd + i], their
// weights of a tile of components k0 .. k0 + kKP - 1 at w_rows, kKP a
// row) by the whole warp: lane l keeps entries 2l and 2l + 1 of g_i =
// sum_k w_ik (b_k - A_k x_i) for the 16 rows (each_weighted), a zero
// weight adding exactly nothing. The first tile starts g and the weight
// sums at zero, a later one from the u rows and wsum where the one before
// left them; after the last, u = g / sum w into the u rows, times dv and
// less its mean (0 for an invalid patch) for K4 (kMix), as it is for K8
// (kUnit).
template <int kEpi>
__device__ __forceinline__ void mix_rows(const float* x, const float* w_rows,
                                         int n0, int rows, int k0, bool first,
                                         bool last, const Out& out,
                                         int lane) {
  float2* u2 = reinterpret_cast<float2*>(out.units + (size_t)n0 * kD) + lane;
  float2 g[16];
  float part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    g[i] = first || i >= rows ? make_float2(0.f, 0.f) : u2[i * (kD / 2)];
    part[i] = 0.f;
  }
  each_weighted(x, w_rows, k0, out, part, lane,
                [&](int r, int, float wk, float2 ax, float2 b) {
#pragma unroll
                  for (int i = 0; i < 16; ++i)
                    if (i == r) {
                      g[i].x = fmaf(wk, b.x - ax.x, g[i].x);
                      g[i].y = fmaf(wk, b.y - ax.y, g[i].y);
                    }
                });
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    if (i >= rows) break;
    const int n = n0 + i;
    float s = part[i];
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
    const float wsum = first ? s : out.wsum[n] + s;
    if (!last) {
      u2[i * (kD / 2)] = g[i];
      if (lane == 0) out.wsum[n] = wsum;
      continue;
    }
    float2 u = make_float2(0.f, 0.f);
    if constexpr (kEpi == kUnit) {
      const float scale = 1.f / wsum;
      u = make_float2(g[i].x * scale, g[i].y * scale);
    } else if (__ldg(out.valid + n) != 0.f) {
      const float scale = __ldg(out.dv + n) / wsum;
      u = make_float2(g[i].x * scale, g[i].y * scale);
      float m = u.x + u.y;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) m += __shfl_xor_sync(0xffffffffu, m, o);
      const float mean = m * (1.f / kD);
      u = make_float2(u.x - mean, u.y - mean);
    }
    u2[i * (kD / 2)] = u;
  }
}

// K9a's part of a tile for a warp's 16 rows (as mix_rows'; n_total rows
// in all, K components): for each nonzero weight (each_weighted), g_k = t
// . (b_k - A_k x) in float32, lane l taking t's entries 2l and 2l + 1
// from the tangent rows in device memory and the warp summing, into dp
// at (k, n) by lane 0; lane i < 16 keeps row i's heaviest weight and its
// g (components come in ascending order and only a larger weight
// replaces it: ties to the lower index), carried from one tile to the
// next in out.ref. A tile before the last writes its weights to p, lane
// (i, h) row i's components of parity h; after the last, a pass over the
// rows by the same lanes turns w and g into p = w / sum w and dp = p (g -
// g_ref - gbar), gbar = sum_k p_k (g_k - g_ref): a row whose weight sits
// on one component gets p = 1 and dp = 0 exactly. The weights of the
// tiles before the last come from p, the last's from w_rows; g is read
// only where w is nonzero, and every entry of p and dp is written (0
// where w is 0).
__device__ __forceinline__ void weigh_rows(const float* x,
                                           const float* w_rows, int n0,
                                           int rows, int k0, int K,
                                           int n_total, bool first,
                                           bool last, const Out& out,
                                           int lane) {
  float w_ref = -1.f, g_ref = 0.f;
  if (!first && lane < rows) {
    w_ref = out.ref[2 * (n0 + lane)];
    g_ref = out.ref[2 * (n0 + lane) + 1];
  }
  const float2* t2 =
      reinterpret_cast<const float2*>(out.tangents + (size_t)n0 * kD) + lane;
  float part[16] = {};
  each_weighted(x, w_rows, k0, out, part, lane,
                [&](int r, int k, float wk, float2 ax, float2 b) {
                  if (wk == 0.f) return;
                  const float2 tv = __ldg(t2 + (size_t)r * (kD / 2));
                  float s = fmaf(tv.x, b.x - ax.x, tv.y * (b.y - ax.y));
#pragma unroll
                  for (int m = 16; m > 0; m >>= 1)
                    s += __shfl_xor_sync(0xffffffffu, s, m);
                  if (lane == 0) out.dp[(size_t)k * n_total + n0 + r] = s;
                  if (lane == r && wk > w_ref) {
                    w_ref = wk;
                    g_ref = s;
                  }
                });
  const int i = lane & 15, half = lane >> 4;
  const bool live = i < rows;
  const size_t n = n0 + i;
  if (!last) {
    if (live)
      for (int c = half; c < kKP && k0 + c < K; c += 2)
        out.p[(size_t)(k0 + c) * n_total + n] = w_rows[i * kKP + c];
    if (lane < rows) {
      out.ref[2 * (n0 + lane)] = w_ref;
      out.ref[2 * (n0 + lane) + 1] = g_ref;
    }
    return;
  }
  __syncwarp();  // lane 0's g in dp
  const float gr = __shfl_sync(0xffffffffu, g_ref, i);
  float w_total = 0.f, gsum = 0.f;
  if (live) {
#pragma unroll 4
    for (int k = half; k < K; k += 2) {
      const size_t e = (size_t)k * n_total + n;
      const float w = k >= k0 ? w_rows[i * kKP + k - k0] : out.p[e];
      w_total += w;
      if (w != 0.f) gsum = fmaf(w, out.dp[e] - gr, gsum);
    }
  }
  w_total += __shfl_xor_sync(0xffffffffu, w_total, 16);
  gsum += __shfl_xor_sync(0xffffffffu, gsum, 16);
  if (!live) return;
  const float inv = 1.f / w_total;
  const float gbar = gsum * inv;  // sum_k p_k g_k - g_ref
#pragma unroll 4
  for (int k = half; k < K; k += 2) {
    const size_t e = (size_t)k * n_total + n;
    const float w = k >= k0 ? w_rows[i * kKP + k - k0] : out.p[e];
    const float pk = w * inv;
    out.p[e] = pk;
    out.dp[e] = w != 0.f ? pk * ((out.dp[e] - gr) - gbar) : 0.f;
  }
}

// Warpgroup wgi's turn to issue products: the two take turns, so that
// one's adds run while the other's products do. Barrier 1 is warpgroup
// 0's turn, 2 warpgroup 1's.
struct Turns {
  int wgi;
  __device__ __forceinline__ void wait() const { wg::bar_sync(1 + wgi, 256); }
  __device__ __forceinline__ void pass() const {
    wg::bar_arrive(2 - wgi, 256);
  }
};

template <bool kImage, int kProd, int kEpi>
__global__ void __launch_bounds__(kThreads, 1)
gmm_score_wg_kernel(Source src, const unsigned char* __restrict__ a_wg,
                    const unsigned char* __restrict__ lin_wg, int K, Out out) {
  using L = Layout<kProd>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* lin = smem + L::kLinOffset;
  float* xbuf = reinterpret_cast<float*>(smem + L::kXOffset);
  uint16_t* pairs = reinterpret_cast<uint16_t*>(smem + L::kPairOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + L::kDepth;
  uint64_t* x_full = empty + L::kDepth;
  uint64_t* x_empty = x_full + 2;
  uint64_t* lin_full = x_empty + 2;
  uint64_t* lin_empty = lin_full + 1;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_tiles = (K + kKP - 1) / kKP;
  const int row_tiles = (src.n_total + kRows - 1) / kRows;
  // the CTA's tiles of rows: blockIdx.x, + gridDim.x, ...
  auto tile = [&](int j) {
    const int rt = blockIdx.x + j * gridDim.x;
    return rt < row_tiles ? rt : -1;
  };

  if (tid == 0) {
    for (int s = 0; s < L::kDepth; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, kConsumerWarps);
    }
    for (int b = 0; b < 2; ++b) {
      wg::mbar_init(x_full + b, kLoaders);
      wg::mbar_init(x_empty + b, kConsumerWarps);
    }
    wg::mbar_init(lin_full, 1);
    wg::mbar_init(lin_empty, kConsumerWarps);
    wg::mbar_fence_init();
  }
  build_pairs(pairs);
  // the first tile's rows by the whole CTA
  if (tid < kRows) load_row<kImage>(xbuf, tid, tile(0) * kRows + tid, src);
  __syncthreads();

  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps) {
      // the producer: a tile's linear terms when the tile of components
      // changes (once for K <= 200), then A's chunks into the ring
      if (lane != 0) return;
      int stage = 0, phase = 0, uses = 0, lin_loads = 0;
      for (int j = 0; tile(j) >= 0; ++j) {
        for (int ct = 0; ct < n_tiles; ++ct) {
          if (lin_loads == 0 || n_tiles > 1) {
            if (lin_loads > 0) wg::mbar_wait(lin_empty, (lin_loads - 1) & 1);
            wg::mbar_arrive_expect_tx(lin_full, kLinBytes);
            wg::bulk_load(lin, lin_wg + (size_t)ct * kLinBytes, kLinBytes,
                          lin_full);
            ++lin_loads;
          }
          for (int c = 0; c < L::kStages; ++c, ++uses) {
            if (uses >= L::kDepth) wg::mbar_wait(empty + stage, phase ^ 1);
            wg::mbar_arrive_expect_tx(full + stage, L::kStage);
            wg::bulk_load(smem + stage * L::kStage,
                          a_wg + ((size_t)ct * L::kStages + c) * L::kRecord,
                          L::kStage, full + stage);
            if (++stage == L::kDepth) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    } else {
      // the loaders: tile j's rows into buffer j % 2 once tile j - 2 is
      // done with it
      const int lt = tid - (kConsumerWarps + 1) * 32;
      for (int j = 1; tile(j) >= 0; ++j) {
        if (j >= 2) wg::mbar_wait(x_empty + (j & 1), ((j - 2) >> 1) & 1);
        float* xs = xbuf + (j & 1) * kXFloats;
        const int n0 = tile(j) * kRows;
        for (int r = lt; r < kRows; r += kLoaders)
          load_row<kImage>(xs, r, n0 + r, src);
        wg::mbar_arrive(x_full + (j & 1));
      }
    }
  } else {
    wg::setmaxnreg_inc<232>();
    // the consumers: warpgroup wgi multiplies rows 64 wgi .. 64 wgi + 63
    const int g = lane >> 2, t = lane & 3, wgi = warp >> 2;
    const int r0 = 64 * wgi + 16 * (warp & 3) + g;
    const Turns turns{wgi};
    if (wgi == 1) turns.pass();  // warpgroup 0 issues first
    int stage = 0, phase = 0, lin_loads = 0;
    for (int j = 0; tile(j) >= 0; ++j) {
      const int n0 = tile(j) * kRows;
      const float* xs = xbuf + (j & 1) * kXFloats;
      if (j >= 1) wg::mbar_wait(x_full + (j & 1), ((j - 1) >> 1) & 1);
      float best[2] = {-CUDART_INF_F, -CUDART_INF_F};
      float best_sum[2] = {0.f, 0.f};
      int best_k[2] = {K, K};
      for (int ct = 0; ct < n_tiles; ++ct) {
        if (lin_loads == 0 || n_tiles > 1)
          wg::mbar_wait(lin_full, lin_loads++ & 1);
        float acc[kRegs], tmp[kRegs];
        // -2 c (in "f32" after the pairs, minus_2c says why), then -2 b .
        // x in four k16 steps (features 0-63)
        if constexpr (L::kF32) {
#pragma unroll
          for (int i = 0; i < kRegs; ++i) acc[i] = 0.f;
        } else {
          minus_2c<true>(acc, lin, t);
        }
        for (int s = 0; s < kD / 16; ++s) {
          uint32_t xp[3][4];
          form_x_parts(xp, xs, s, r0, t);
          turns.wait();
          wg::wgmma_fence();
          issue_six(tmp, xp, [&](int part) {
            return b_desc(lin + part * kLinPart + 256 * s, 1024);
          });
          wg::wgmma_commit();
          turns.pass();
          flush(acc, tmp);
        }
        // the linear terms are free for the next tile of components once
        // every warp is done with them
        auto release_lin = [&] {
          if (n_tiles > 1) {
            __syncwarp();
            if (lane == 0) wg::mbar_arrive(lin_empty);
          }
        };
        if constexpr (!L::kF32) release_lin();
        for (int c = 0; c < L::kStages; ++c) {
          wg::mbar_wait(full + stage, phase);
          const unsigned char* st = smem + stage * L::kStage;
          if constexpr (kProd == 6) {
            // the step's six products into fresh accumulators
            uint32_t up[3][4];
            form_fragment<6>(up, xs, pairs, c, r0, t);
            turns.wait();
            wg::wgmma_fence();
            issue_six(tmp, up, [&](int part) {
              return b_desc(st + part * kPlane3, 256);
            });
            wg::wgmma_commit();
            turns.pass();
            flush(acc, tmp);
            fence_fragment(up);
          } else {
            // the chunk's two k16 steps into fresh accumulators
            uint32_t p0[2][4], p1[2][4];
            form_fragment<kProd>(p0, xs, pairs, 2 * c, r0, t);
            form_fragment<kProd>(p1, xs, pairs, 2 * c + 1, r0, t);
            turns.wait();
            wg::wgmma_fence();
            issue_step<kProd, true>(tmp, p0[0], p0[1], st, 0);
            issue_step<kProd, false>(tmp, p1[0], p1[1], st, 1);
            wg::wgmma_commit();
            turns.pass();
            flush(acc, tmp);
          }
          // the stage is free once every warp is done
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(empty + stage);
          if (++stage == L::kDepth) {
            stage = 0;
            phase ^= 1;
          }
        }
        if constexpr (L::kF32) {
          minus_2c<false>(acc, lin, t);
          release_lin();
        }
        const int k0 = ct * kKP;
        if constexpr (kEpi >= kMix) {
          // the thread's weights into the CTA's scratch (0 for a row past
          // the end and, for K4, an invalid patch), then the warp's 16
          // rows' mixture (K4, K8) or g (K9a)
          float* wts = out.wts + (size_t)blockIdx.x * kRows * kKP;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = r0 + 8 * h, n = n0 + r;
            const bool live = n < src.n_total &&
                              (kEpi != kMix || __ldg(out.valid + n) != 0.f);
            const float l = live ? __ldg(out.lse + n) : CUDART_INF_F;
            float2* w2 = reinterpret_cast<float2*>(wts + (size_t)r * kKP) + t;
#pragma unroll
            for (int n8 = 0; n8 < kKP / 8; ++n8) {
              const int kk = k0 + 8 * n8 + 2 * t;
              w2[4 * n8] = make_float2(
                  kk < K ? expf(-0.5f * acc[4 * n8 + 2 * h] - l) : 0.f,
                  kk + 1 < K ? expf(-0.5f * acc[4 * n8 + 2 * h + 1] - l)
                             : 0.f);
            }
          }
          __syncwarp();
          const int rw = r0 - g, rows = src.n_total - (n0 + rw);
          if (rows > 0) {
            const bool first = ct == 0, last = ct + 1 == n_tiles;
            if constexpr (kEpi == kWeights)
              weigh_rows(xs + rw, wts + (size_t)rw * kKP, n0 + rw,
                         rows < 16 ? rows : 16, k0, K, src.n_total, first,
                         last, out, lane);
            else
              mix_rows<kEpi>(xs + rw, wts + (size_t)rw * kKP, n0 + rw,
                             rows < 16 ? rows : 16, k0, first, last, out,
                             lane);
          }
          __syncwarp();
        } else {
          // the tile's maximum and argmax (and, for kLse, the sum of
          // exp(logit - maximum), rescaled whenever the maximum grows):
          // the thread's components, the quad, then the earlier tiles
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = -CUDART_INF_F, sum = 0.f;
            int k = K;
#pragma unroll
            for (int n8 = 0; n8 < kKP / 8; ++n8)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kk = k0 + 8 * n8 + 2 * t + e;
                const float logit = -0.5f * acc[4 * n8 + 2 * h + e];
                if constexpr (kEpi == kLse) {
                  if (kk < K) {
                    if (logit > v) {
                      sum = fmaf(sum, expf(v - logit), 1.f);
                      v = logit;
                      k = kk;
                    } else {
                      sum += expf(logit - v);
                    }
                  }
                } else if (kk < K && logit > v) {
                  v = logit;
                  k = kk;
                }
              }
#pragma unroll
            for (int m = 1; m < 4; m <<= 1) {
              const float ov = __shfl_xor_sync(0xffffffffu, v, m);
              const int ok = __shfl_xor_sync(0xffffffffu, k, m);
              if constexpr (kEpi == kLse)
                take_lse(v, sum, k, ov, __shfl_xor_sync(0xffffffffu, sum, m),
                         ok);
              else
                take_max(v, k, ov, ok);
            }
            if constexpr (kEpi == kLse)
              take_lse(best[h], best_sum[h], best_k[h], v, sum, k);
            else
              take_max(best[h], best_k[h], v, k);
          }
        }
      }
      if (kEpi <= kLse && t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + r0 + 8 * h;
          if (n < src.n_total) {
            out.values[n] =
                kEpi == kLse ? best[h] + logf(best_sum[h]) : best[h];
            out.argmax[n] = best_k[h] >= K ? 0 : best_k[h];
          }
        }
      }
      // the row buffer is free for tile j + 2
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(x_empty + (j & 1));
    }
    if (wgi == 0) turns.wait();  // warpgroup 1's last pass
  }
}

// K4's second launch: one thread per pixel of the image gradient
// (gmm_patches.cuh's patch_units_at).
__global__ void __launch_bounds__(kAddThreads)
gmm_units_add_kernel(const float* __restrict__ units, int H, int W,
                     int stride, int ny, int nx, float* __restrict__ grad) {
  const int pix = blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= H * W) return;
  const int y = pix / W;
  grad[pix] = gmm::patch_units_at(units, y, pix - y * W, stride, ny, nx);
}

// The persistent launch of an instance: one CTA an SM (as many as fit),
// at most one a tile of rows and at most max_ctas (> 0: the CTAs the
// caller's scratch holds).
template <bool kImage, int kProd, int kEpi>
int launch(const Source& src, const void* a_wg, const void* lin_wg, int K,
           const Out& out, int max_ctas, cudaStream_t stream) {
  auto kernel = gmm_score_wg_kernel<kImage, kProd, kEpi>;
  constexpr int smem = Layout<kProd>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  static int max_blocks = 0;
  if (max_blocks == 0) {
    int device = 0, sms = 0, per_sm = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    max_blocks = sms * per_sm;
  }
  const int row_tiles = (src.n_total + kRows - 1) / kRows;
  int blocks = row_tiles < max_blocks ? row_tiles : max_blocks;
  if (max_ctas > 0 && blocks > max_ctas) blocks = max_ctas;
  kernel<<<blocks, kThreads, smem, stream>>>(
      src, static_cast<const unsigned char*>(a_wg),
      static_cast<const unsigned char*>(lin_wg), K, out);
  return static_cast<int>(cudaGetLastError());
}

Source image_source(const void* img, int H, int W, int stride, int ny,
                    int nx, float sentinel, void* valid, void* xtn) {
  const int groups = (kP / stride) * (kP / stride);
  return Source{static_cast<const float*>(img), H, W, stride, ny, nx,
                sentinel, static_cast<float*>(valid),
                static_cast<float*>(xtn), nullptr, groups * ny * nx};
}

Source row_source(const void* rows, int n) {
  return Source{nullptr, 0, 0, 1, 0, 0, 0.f, nullptr, nullptr,
                static_cast<const float*>(rows), n};
}

// The instance of `products` (6, 3 or 1) of the image or K4 kernels.
template <bool kImage, int kEpi>
int launch_products(int products, const Source& src, const void* a_wg,
                    const void* lin_wg, int K, const Out& out, int max_ctas,
                    cudaStream_t stream) {
  if (products == 6)
    return launch<kImage, 6, kEpi>(src, a_wg, lin_wg, K, out, max_ctas,
                                   stream);
  if (products == 3)
    return launch<kImage, 3, kEpi>(src, a_wg, lin_wg, K, out, max_ctas,
                                   stream);
  return launch<kImage, 1, kEpi>(src, a_wg, lin_wg, K, out, max_ctas,
                                 stream);
}

bool valid_products(int products) {
  return products == 6 || products == 3 || products == 1;
}

Out score_out(void* values, void* argmax) {
  Out out{};
  out.values = static_cast<float*>(values);
  out.argmax = static_cast<int*>(argmax);
  return out;
}

// The mixture instances' scratch and model: the weights (ctas x 128 x
// 200 floats: the kernel runs at most ctas CTAs), a_full (K, 64, 64) and
// b_rows (K, 64).
Out mix_out(const void* lse, const void* a_full, const void* b_rows,
            void* wts) {
  Out out{};
  out.lse = static_cast<const float*>(lse);
  out.a_full = static_cast<const float*>(a_full);
  out.b_rows = static_cast<const float*>(b_rows);
  out.wts = static_cast<float*>(wts);
  return out;
}

}  // namespace

extern "C" {

// K1's MAP forward on image (H, W) float32: values (the maxima), argmax,
// valid and xtn for the G * ny * nx patches (gmm_patches.cuh's
// enumeration); products is 6 ("f32"), 3 ("split") or 1 ("bf16"), and
// a_wg holds ceil(K / 200) tiles of the mode's records: 130 step images
// in three planes for 6 (ops/gmm_fused.py::_wg3_buffer), 65 chunk images
// otherwise (_wg_buffers); lin_wg as many tiles of the linear terms.
// Returns the first CUDA error of the launch (0 = cudaSuccess); 1
// (cudaErrorInvalidValue) for K < 1 or another number of products.
int gmm_score_wg_image(const void* img, int H, int W, int stride, int ny,
                       int nx, float sentinel, const void* a_wg,
                       const void* lin_wg, int K, int products, void* values,
                       void* argmax, void* valid, void* xtn, void* stream) {
  if (K < 1 || !valid_products(products))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_products<true, kMax>(
      products, image_source(img, H, W, stride, ny, nx, sentinel, valid, xtn),
      a_wg, lin_wg, K, score_out(values, argmax), 0,
      static_cast<cudaStream_t>(stream));
}

// K5 on rows (n, 64) float32, already masked and mean-subtracted: values
// (the maxima, or with lse the logsumexp) and argmax (the lowest index
// among equal maxima); the buffers of gmm_score_wg_image, products 3
// ("split") or 1 ("bf16") for the maxima (the "f32" K5 MAP is
// gmm_patch.cu's), 6, 3 or 1 for the logsumexp. Errors as
// gmm_score_wg_image; the wrapper never calls it with n = 0.
int gmm_score_wg_rows(const void* rows, int n, const void* a_wg,
                      const void* lin_wg, int K, int products, int lse,
                      void* values, void* argmax, void* stream) {
  if (K < 1 || !valid_products(products) || (!lse && products == 6))
    return static_cast<int>(cudaErrorInvalidValue);
  const Source src = row_source(rows, n);
  const Out out = score_out(values, argmax);
  auto s = static_cast<cudaStream_t>(stream);
  if (lse)
    return launch_products<false, kLse>(products, src, a_wg, lin_wg, K, out,
                                        0, s);
  return products == 3
             ? launch<false, 3, kMax>(src, a_wg, lin_wg, K, out, 0, s)
             : launch<false, 1, kMax>(src, a_wg, lin_wg, K, out, 0, s);
}

// K1's logsumexp forward on image (H, W) float32: values (the
// logsumexp), argmax (the lowest index among equal maxima), valid and
// xtn; the buffers and products of gmm_score_wg_image. Errors as
// gmm_score_wg_image.
int gmm_score_wg_image_lse(const void* img, int H, int W, int stride, int ny,
                           int nx, float sentinel, const void* a_wg,
                           const void* lin_wg, int K, int products,
                           void* values, void* argmax, void* valid, void* xtn,
                           void* stream) {
  if (K < 1 || !valid_products(products))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_products<true, kLse>(
      products, image_source(img, H, W, stride, ny, nx, sentinel, valid, xtn),
      a_wg, lin_wg, K, score_out(values, argmax), 0,
      static_cast<cudaStream_t>(stream));
}

// K4: the image gradient grad (H, W) from the saved patches xtn (N, 64),
// the logsumexp lse that gmm_score_wg_image_lse computed on them with
// the same buffers and products (the weights are exp(logit - lse) of the
// same logits), valid and the cotangents dvalues (N,); a_full (K, 64,
// 64), b_rows (K, 64). Scratch: wts (ctas x 128 x 200 floats: the kernel
// runs at most ctas CTAs), wsum (N,) and the u rows units (N, 64).
// Errors as gmm_score_wg_image (1 also for ctas < 1).
int gmm_score_wg_mix(const void* xtn, const void* lse, const void* valid,
                     const void* dvalues, const void* a_wg,
                     const void* lin_wg, const void* a_full,
                     const void* b_rows, int H, int W, int stride, int ny,
                     int nx, int K, int products, void* wts, int ctas,
                     void* wsum, void* units, void* grad, void* stream) {
  if (K < 1 || ctas < 1 || !valid_products(products))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (kP / stride) * (kP / stride);
  Out out = mix_out(lse, a_full, b_rows, wts);
  out.valid = static_cast<const float*>(valid);
  out.dv = static_cast<const float*>(dvalues);
  out.wsum = static_cast<float*>(wsum);
  out.units = static_cast<float*>(units);
  auto s = static_cast<cudaStream_t>(stream);
  const int err = launch_products<false, kMix>(
      products, row_source(xtn, groups * ny * nx), a_wg, lin_wg, K, out,
      ctas, s);
  if (err != 0) return err;
  const int pixel_blocks = (H * W + kAddThreads - 1) / kAddThreads;
  gmm_units_add_kernel<<<pixel_blocks, kAddThreads, 0, s>>>(
      out.units, H, W, stride, ny, nx, static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

// K8: the marginalise unit gradient units (n, 64) = sum_k w_k (b_k - A_k
// x) / sum_k w_k, w_k = exp(logit_k - lse), of rows (n, 64) with the
// logsumexp lse that gmm_score_wg_rows computed on them with the same
// buffers and products (the weights of the same logits); scratch wts
// (mix_out) and wsum (n,). Errors as gmm_score_wg_mix.
int gmm_score_wg_unit(const void* rows, const void* lse, int n,
                      const void* a_wg, const void* lin_wg,
                      const void* a_full, const void* b_rows, int K,
                      int products, void* wts, int ctas, void* wsum,
                      void* units, void* stream) {
  if (K < 1 || ctas < 1 || !valid_products(products))
    return static_cast<int>(cudaErrorInvalidValue);
  Out out = mix_out(lse, a_full, b_rows, wts);
  out.wsum = static_cast<float*>(wsum);
  out.units = static_cast<float*>(units);
  return launch_products<false, kUnit>(products, row_source(rows, n), a_wg,
                                       lin_wg, K, out, ctas,
                                       static_cast<cudaStream_t>(stream));
}

// K9a: the first stage of the marginalise Hessian action of rows (n, 64)
// along tangents (n, 64), with lse as gmm_score_wg_unit: p and dp (K, n),
// p = w / sum w, dp_k = p_k (g_k - sum_j p_j g_j), g_k = t . (b_k - A_k
// x); scratch wts (mix_out) and ref (2n floats). Errors as
// gmm_score_wg_mix.
int gmm_score_wg_weights(const void* rows, const void* tangents,
                         const void* lse, int n, const void* a_wg,
                         const void* lin_wg, const void* a_full,
                         const void* b_rows, int K, int products, void* wts,
                         int ctas, void* ref, void* p, void* dp,
                         void* stream) {
  if (K < 1 || ctas < 1 || !valid_products(products))
    return static_cast<int>(cudaErrorInvalidValue);
  Out out = mix_out(lse, a_full, b_rows, wts);
  out.tangents = static_cast<const float*>(tangents);
  out.ref = static_cast<float*>(ref);
  out.p = static_cast<float*>(p);
  out.dp = static_cast<float*>(dp);
  return launch_products<false, kWeights>(products, row_source(rows, n),
                                          a_wg, lin_wg, K, out, ctas,
                                          static_cast<cudaStream_t>(stream));
}

const char* gmm_score_wg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
