// The GMM MAP scorer on Hopper's warpgroup instructions (sm_90a), in the
// precision dial's "split" and "bf16" modes: K1's MAP forward on an image
// (gmm_score_wg_image) and K5's MAP scorer on rows (gmm_score_wg_rows).
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (jolideco_torch/utils/cuda_build.py); the wrappers are
// gmm_fused_fwd_tc_cuda and gmm_fused_fwd_bf16_cuda in
// jolideco_torch/ops/gmm_fused.py, gmm_score_rows_tc_cuda and
// gmm_score_rows_bf16_cuda in jolideco_torch/ops/gmm_pallas.py, whose
// plain versions (score_split_plain, score_bf16_plain) the card holds
// them to.
//
// What it replaces: the JAX package's ops/gmm_fused.py::_fwd_kernel (MAP
// branch) and ops/gmm_pallas.py::_score_kernel (MAP) under precision HIGH
// ("split3", kProd = 3: hi.hi + hi.lo + lo.hi of the bf16 hi/lo parts)
// and DEFAULT (kProd = 1: hi.hi), and in this port gmm_fused_tc.cu's
// <false, kProd> instances of gmm_fwd_tc_kernel and
// gmm_score_rows_tc_kernel (mma.sync), which no wrapper launches any
// more. Per row x (a masked, mean-subtracted 8x8 patch),
//     logit_k = -1/2 x^T A_k x + b_k . x + c_k,
// the quadratic form as the product of the 2,080 pair products u = x_a
// x_b (a <= b) with the pair-major A (off-diagonals doubled), then the
// maximum and the lowest index among equal maxima. The logsumexp
// instances stay on gmm_fused_tc.cu's tile_logits, whose logits K4, K8
// and K9a recompute bit for bit (its header says why).
//
// What bounds it on the H100: operations. At 1024^2 (65,536 patches),
// K = 200: 3 x 2 x 65,536 x 200 x 2,144 flop = 0.17 ms at the bf16 peak
// of 989 TFLOP/s (one product: 0.057 ms); bytes are 4 MB in and 17 MB out
// (0.006 ms). Beside the products, the CUDA cores form u, add each group
// of products to the running sums and reduce, and A's 1.7 MB a tile of
// components flows from L2 into every CTA once for each of its tiles of
// rows (0.89 GB at 1024^2).
//
// The design:
// - one CTA of three warpgroups on each SM, persistent, walking over tiles
//   of 128 rows (blockIdx.x, + gridDim.x, ...);
// - warpgroups 0 and 1 multiply, 64 rows each, by wgmma.mma_async
//   m64n200k16 (bf16 in, float32 out): A is u, formed by each thread from
//   the rows in shared memory (stored transposed, [feature][row], so that
//   the fragment loads fall on distinct banks) straight into the m16n8k16
//   fragment registers and split into bf16 hi and lo (tc_frag.cuh's
//   put_operand); B is A's chunk of 32 pairs x 200 components in shared
//   memory, K-major 8 x 8 core matrices (no swizzle);
// - a chunk's two k16 steps, kProd products each, go into fresh
//   accumulators (the first with scale-d = 0), which after
//   wgmma.wait_group are added to the running float32 sums on the CUDA
//   cores: the tensor cores carry no sum across chunks (gmm_fused_tc.cu's
//   add_split records the bias of sums they carry across all 130 steps;
//   chip_smoke.py phase 2 holds this one to the same bars). The two
//   warpgroups take turns to issue (two named barriers), so that one's
//   adds and fragments run while the other's products do;
// - b . x + c off the CUDA cores' loop: the accumulators start at -2 c,
//   then -2 b . x runs as four k16 steps of six products, x and -2 b each
//   split into three bf16 parts (float32's 24 bits) and the products of
//   parts i + j <= 4 summed, as the JAX package's HIGHEST, into fresh
//   accumulators added as the pairs' are; -2 b's parts (77 KB with c)
//   stay in shared memory while the tile of components does (for K <= 200
//   the whole run);
// - warpgroup 2 is cut to 40 registers by setmaxnreg (the multiplying
//   warpgroups get 232): one thread keeps A's chunks in flight in a ring
//   of shared-memory stages (3 for "split", 6 for "bf16"), each a bulk
//   copy of the chunk's image (ops/gmm_fused.py::_wg_buffers lays the
//   device buffer out as the stages' bytes) completing on the stage's
//   mbarrier; its other three warps load the next tile's rows (K1: the
//   patches, masked and mean-subtracted as gmm_patches.cuh's load_patch,
//   also written to xtn and valid) into the second of two row buffers
//   while the current tile is multiplied;
// - the maximum over each thread's 50 components, then over the four
//   threads of a quad (shuffles), then over the tiles of components (in
//   registers), ties to the lower index.
// Any K: tiles of 200 components one after another (the last padded with
// zero components, masked out of the maximum).
//
// A first version, with a k16 step a flush, b . x by FMAs interleaved
// with the chunks (its loads waited one at a time on the few registers
// left) and a cluster of two CTAs sharing each chunk by a multicast bulk
// copy (whose handshake a chunk cost more than the halved L2 reads saved),
// was no faster than the mma.sync kernel on the H100; those three went.
// chip_smoke.py phase 2 times this kernel beside the mma.sync instances
// it replaces, scripts/torch_wg_variants.py variants of it.
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
constexpr int kRows = 128;                 // rows a CTA tile
constexpr int kThreads = 384;              // three warpgroups
constexpr int kXLd = kRows + 4;            // transposed row buffer stride
constexpr int kXFloats = kD * kXLd;
constexpr int kPlaneBytes = kKP * kKC * 2;  // 12,800: a bf16 plane
constexpr int kLinPart = kKP * kD * 2;      // 25,600: a bf16 part of -2 b
constexpr int kCQuads = 13;                 // float4s of c a thread
constexpr int kLinBytes = 3 * kLinPart + 4 * 16 * kCQuads;  // 77,632
constexpr int kLoaders = 96;                // warps 9-11
constexpr int kConsumerWarps = 8;
static_assert(kPairs % kKC == 0 && kKC == 32, "two k16 steps a chunk");

// Shared memory: the ring of A's chunks (kProd bf16 planes a stage), the
// linear terms (b's three parts, c), two row buffers, the pair table and
// the barriers.
template <int kProd>
struct Layout {
  static constexpr int kStage = kProd == 3 ? 2 * kPlaneBytes : kPlaneBytes;
  static constexpr int kDepth = kProd == 3 ? 3 : 6;
  static constexpr int kLinOffset = kDepth * kStage;
  static constexpr int kXOffset = kLinOffset + kLinBytes;
  static constexpr int kPairOffset = kXOffset + 2 * kXFloats * 4;
  static constexpr int kBarOffset = kPairOffset + kPairs * 2;
  static constexpr int kSmem = kBarOffset + (2 * kDepth + 6) * 8;
  static_assert(kStage % 128 == 0 && kLinBytes % 16 == 0, "aligned");
  static_assert(kBarOffset % 8 == 0, "aligned barriers");
  static_assert(kSmem <= 232448, "shared memory of a CTA");
};

// Where a CTA reads its rows: an image's patches (K1) or rows (K5).
struct Source {
  const float* img;
  int H, W, stride, ny, nx;
  float sentinel;
  float* valid;
  float* xtn;
  const float* rows;
  int n_total;
};

// Row r of a CTA's tile (row n of the whole) into the transposed buffer
// xs. K1: patch n, masked and mean-subtracted as load_patch (the same
// sums in the same order), written to xtn and valid too, read twice to
// spare registers; K5: row n. Past the end: zeros, nothing written.
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

// u's fragment of k16 step `step` for rows r0 and r0 + 8 of the tile:
// registers q = 0..3 hold (row r0 + 8 (q & 1), pairs 16 step + 2t + 8
// (q >> 1) and + 1), split into bf16 hi and lo (hi alone for one
// product) by put_operand.
template <int kProd>
__device__ __forceinline__ void form_fragment(uint32_t (&hi)[4],
                                              uint32_t (&lo)[4],
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
      __nv_bfloat162 vh, vl;
      tc::put_operand<kProd>(reinterpret_cast<bf16*>(&vh),
                             reinterpret_cast<bf16*>(&vl), 0, v);
      hi[2 * half + h] = bits(vh);
      if constexpr (kProd == 3) lo[2 * half + h] = bits(vl);
    }
  }
}

// x's fragment of k16 step `step` of b . x (features 16 step ..) for rows
// r0 and r0 + 8, split into three bf16 parts p[0] + p[1] + p[2] (each the
// rounding of what the earlier ones leave, as put_split's hi and lo):
// float32's 24 bits.
__device__ __forceinline__ void form_x_parts(uint32_t (&p)[3][4],
                                             const float* xs, int step,
                                             int r0, int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int d = 16 * step + 2 * t + 8 * half, r = r0 + 8 * h;
      float2 v = make_float2(xs[d * kXLd + r], xs[(d + 1) * kXLd + r]);
#pragma unroll
      for (int part = 0; part < 3; ++part) {
        const __nv_bfloat162 b = __float22bfloat162_rn(v);
        const float2 f = __bfloat1622float2(b);
        p[part][2 * half + h] = bits(b);
        v = make_float2(v.x - f.x, v.y - f.y);
      }
    }
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

// One k16 step of -2 b . x in six products of the parts, x_i (-2 b)_j
// for i + j <= 4 (parts from 0), the smallest first, into fresh
// accumulators: float32's accuracy, as the JAX package's HIGHEST.
__device__ __forceinline__ void issue_linear(float (&t)[kRegs],
                                             const uint32_t (&x)[3][4],
                                             const unsigned char* lin,
                                             int s) {
  auto part = [&](int j) {
    return b_desc(lin + j * kLinPart + 256 * s, 1024);
  };
  wg::wgmma_n200_zero(t, x[2], part(0));
  wg::wgmma_n200_acc(t, x[1], part(1));
  wg::wgmma_n200_acc(t, x[0], part(2));
  wg::wgmma_n200_acc(t, x[1], part(0));
  wg::wgmma_n200_acc(t, x[0], part(1));
  wg::wgmma_n200_acc(t, x[0], part(0));
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

// The larger of (v, k) and (ov, ok), ties to the lower index.
__device__ __forceinline__ void take_max(float& v, int& k, float ov, int ok) {
  if (ov > v || (ov == v && ok < k)) {
    v = ov;
    k = ok;
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

template <bool kImage, int kProd>
__global__ void __launch_bounds__(kThreads, 1)
gmm_score_wg_kernel(Source src, const unsigned char* __restrict__ a_wg,
                    const unsigned char* __restrict__ lin_wg, int K,
                    float* __restrict__ values, int* __restrict__ argmax) {
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
          for (int c = 0; c < kChunks; ++c, ++uses) {
            if (uses >= L::kDepth) wg::mbar_wait(empty + stage, phase ^ 1);
            wg::mbar_arrive_expect_tx(full + stage, L::kStage);
            wg::bulk_load(smem + stage * L::kStage,
                          a_wg + ((size_t)ct * kChunks + c) * 2 * kPlaneBytes,
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
      int best_k[2] = {K, K};
      for (int ct = 0; ct < n_tiles; ++ct) {
        if (lin_loads == 0 || n_tiles > 1)
          wg::mbar_wait(lin_full, lin_loads++ & 1);
        float acc[kRegs], tmp[kRegs];
        // -2 c, then -2 b . x in four k16 steps (features 0-63)
        {
          const float4* c4 =
              reinterpret_cast<const float4*>(lin + 3 * kLinPart) +
              kCQuads * t;
#pragma unroll
          for (int q = 0; q < kCQuads; ++q) {
            const float4 c = c4[q];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int n8 = 2 * q + h;
              if (n8 < kKP / 8) {
                acc[4 * n8] = acc[4 * n8 + 2] = -2.f * (h ? c.z : c.x);
                acc[4 * n8 + 1] = acc[4 * n8 + 3] = -2.f * (h ? c.w : c.y);
              }
            }
          }
        }
        for (int s = 0; s < kD / 16; ++s) {
          uint32_t xp[3][4];
          form_x_parts(xp, xs, s, r0, t);
          turns.wait();
          wg::wgmma_fence();
          issue_linear(tmp, xp, lin, s);
          wg::wgmma_commit();
          turns.pass();
          flush(acc, tmp);
        }
        if (n_tiles > 1) {
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(lin_empty);
        }
        for (int c = 0; c < kChunks; ++c) {
          wg::mbar_wait(full + stage, phase);
          const unsigned char* st = smem + stage * L::kStage;
          // the chunk's two k16 steps into fresh accumulators
          uint32_t hi0[4], lo0[4], hi1[4], lo1[4];
          form_fragment<kProd>(hi0, lo0, xs, pairs, 2 * c, r0, t);
          form_fragment<kProd>(hi1, lo1, xs, pairs, 2 * c + 1, r0, t);
          turns.wait();
          wg::wgmma_fence();
          issue_step<kProd, true>(tmp, hi0, lo0, st, 0);
          issue_step<kProd, false>(tmp, hi1, lo1, st, 1);
          wg::wgmma_commit();
          turns.pass();
          flush(acc, tmp);
          // the stage is free once every warp is done
          __syncwarp();
          if (lane == 0) wg::mbar_arrive(empty + stage);
          if (++stage == L::kDepth) {
            stage = 0;
            phase ^= 1;
          }
        }
        // the tile's maximum and argmax: the thread's components, the
        // quad, then the earlier tiles
        const int k0 = ct * kKP;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v = -CUDART_INF_F;
          int k = K;
#pragma unroll
          for (int n8 = 0; n8 < kKP / 8; ++n8)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kk = k0 + 8 * n8 + 2 * t + e;
              const float logit = -0.5f * acc[4 * n8 + 2 * h + e];
              if (kk < K && logit > v) {
                v = logit;
                k = kk;
              }
            }
#pragma unroll
          for (int m = 1; m < 4; m <<= 1)
            take_max(v, k, __shfl_xor_sync(0xffffffffu, v, m),
                     __shfl_xor_sync(0xffffffffu, k, m));
          take_max(best[h], best_k[h], v, k);
        }
      }
      if (t == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + r0 + 8 * h;
          if (n < src.n_total) {
            values[n] = best[h];
            argmax[n] = best_k[h] >= K ? 0 : best_k[h];
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

// The persistent launch of an instance: one CTA an SM (as many as fit),
// at most one a tile of rows.
template <bool kImage, int kProd>
int launch(const Source& src, const void* a_wg, const void* lin_wg, int K,
           float* values, int* argmax, cudaStream_t stream) {
  auto kernel = gmm_score_wg_kernel<kImage, kProd>;
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
  const int blocks = row_tiles < max_blocks ? row_tiles : max_blocks;
  kernel<<<blocks, kThreads, smem, stream>>>(
      src, static_cast<const unsigned char*>(a_wg),
      static_cast<const unsigned char*>(lin_wg), K, values, argmax);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K1's MAP forward on image (H, W) float32: values (the maxima), argmax,
// valid and xtn for the G * ny * nx patches (gmm_patches.cuh's
// enumeration); a_wg holds ceil(K / 200) tiles of 65 chunk images, lin_wg
// as many tiles of the linear terms (ops/gmm_fused.py::_wg_buffers);
// products is 3 ("split") or 1 ("bf16"). Returns the first CUDA error of
// the launch (0 = cudaSuccess); 1 (cudaErrorInvalidValue) for K < 1 or
// another number of products.
int gmm_score_wg_image(const void* img, int H, int W, int stride, int ny,
                       int nx, float sentinel, const void* a_wg,
                       const void* lin_wg, int K, int products, void* values,
                       void* argmax, void* valid, void* xtn, void* stream) {
  if (K < 1 || (products != 1 && products != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (gmm::kP / stride) * (gmm::kP / stride);
  Source src{static_cast<const float*>(img), H, W, stride, ny, nx, sentinel,
             static_cast<float*>(valid), static_cast<float*>(xtn), nullptr,
             groups * ny * nx};
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<float*>(values);
  auto k = static_cast<int*>(argmax);
  return products == 3 ? launch<true, 3>(src, a_wg, lin_wg, K, v, k, s)
                       : launch<true, 1>(src, a_wg, lin_wg, K, v, k, s);
}

// K5's MAP scorer on rows (n, 64) float32, already masked and
// mean-subtracted: values and argmax; the buffers and products of
// gmm_score_wg_image. Errors as gmm_score_wg_image; the wrapper never
// calls it with n = 0.
int gmm_score_wg_rows(const void* rows, int n, const void* a_wg,
                      const void* lin_wg, int K, int products, void* values,
                      void* argmax, void* stream) {
  if (K < 1 || (products != 1 && products != 3))
    return static_cast<int>(cudaErrorInvalidValue);
  Source src{nullptr, 0, 0, 1, 0, 0, 0.f, nullptr, nullptr,
             static_cast<const float*>(rows), n};
  auto s = static_cast<cudaStream_t>(stream);
  auto v = static_cast<float*>(values);
  auto k = static_cast<int*>(argmax);
  return products == 3 ? launch<false, 3>(src, a_wg, lin_wg, K, v, k, s)
                       : launch<false, 1>(src, a_wg, lin_wg, K, v, k, s);
}

const char* gmm_score_wg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
