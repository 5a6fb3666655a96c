// Passes 2 and 3 of the pair-packed matrix-DFT convolution on Hopper's
// warpgroup instructions (sm_90a), in the precision dial's "split" and
// "bf16" modes. Built by nvcc into a shared library with a plain C
// interface and loaded with ctypes (jolideco_torch/utils/cuda_build.py);
// the wrappers (pfft_rows_combine_tc_cuda, pfft_rows_combine_bf16_cuda,
// pfft_cols_inv_tc_cuda, pfft_cols_inv_bf16_cuda) and their plain
// versions (rows_combine_plain, cols_inv_plain with mode="split" or
// "bf16", the CPU path's own) are in jolideco_torch/ops/pallas_fft.py.
// Pass 1 stays on pfft_conv_tc.cu. The modes: kProd bf16 products a k16
// step, 3 for "split" (hi.hi + hi.lo + lo.hi of the operands' bf16 hi
// and lo parts), 1 for "bf16" (hi.hi).
//
// What it replaces: the JAX package's ops/pallas_fft.py::_k2_body (pass
// 2: per row the lane forward, the spectrum combine, the lane inverse and
// the permuted forward, cropped to W columns) and ::_k3_body (pass 3: the
// axis-0 inverse plus permuted forward, cropped to H rows) under
// precision HIGH and DEFAULT, and in this port pfft_conv_tc.cu's
// pfft_rows_tc_kernel and pfft_cols_inv_tc_kernel (mma.sync), which no
// wrapper launches any more.
//
// The roundings are the plain version's, and the JAX package's: each
// product rounds its data operand (S_k2, A . Z or conj(B2) . Z,
// V1 +- conj V2) and the stage matrix of its k2, mf[k2] or mi[k2], whose
// entries carry the twiddles. So the k2 of a strip each take their own
// table; the products of a k2 are m64n8k16 (pass 2's lane forward, the
// strip's eight rows) and m64n16k16 (the two signs' eight rows each).
//
// A table is a complex 128 x 128 matrix M[k1][b] (input k1, output b),
// held as its real and imaginary planes, transposed: the products' A
// operand, the real parts Re M^T, then Im M^T. The operand rows hold a
// complex row as its 128 real parts followed by its 128 imaginary ones
// (K = 256). With wgmma's sign on A, a warpgroup's two accumulator tiles
// are the real and the imaginary parts of its 64 outputs b:
//     Re z = x_re Re M - x_im Im M,   Im z = x_re Im M + x_im Re M,
// four products a k16 step and a table plane read once, half the bytes
// of the interleaved real form (pfft_conv_tc.cu's header). Each thread's
// accumulator rows lane / 4 and lane / 4 + 8 of both tiles are outputs b
// and b + 8, complete.
//
// pfft_rows_wg_kernel, per strip of kR = 8 rows of U (of one pair), per
// round of up to kRound = 9 k2 (one round for m <= 9), k2 by k2:
//   stage A  X = sum_n2 wf[n2][k2] U[r, 128 n2 + .], U read from device
//            memory for the first k2 and from L2 for the others;
//   product  Z_k2 = X mf[k2] (N = 8, the strip's rows);
//   combine  Y1 = A . Z, Y2 = conj(B2) . Z, the spectra read once (their
//            loads issued before the product);
//   product  P_k2 = [Y1; Y2] mi[k2] (N = 16);
//   then the epilogue
//            V1[r, 128 a + b] = sum_k2 wi[a][k2] P1_k2[r][b], V2 the
//            conjugate of the same sum of P2, a < W / 128.
// pfft_cols_inv_wg_kernel, per strip of kR = 8 columns of V1, V2, per
// round, k2 by k2:
//   stage A  X+- = (V1 +- conj V2)[128 k2 + ., c], V read once (the next
//            k2's loads issued before this k2's product);
//   product  P_k2 = [X+; X-] mi[k2] (N = 16);
//   then the epilogue
//            y0[128 a + b, c] = Re sum_k2 wi[a][k2] P+_k2[c][b], y1 the
//            same Im of P-, a < H / 128.
// A thread's accumulator columns 2 (lane % 4) + e of each k2 are rows
// (columns) 2 (lane % 4) + e of the strip, so the k2 sum of an output is
// one thread's: the first kRegK2 = 5 products of a round stay in its
// registers, the other four in its slots of shared memory (all nine in
// registers spill). For m <= 9, V1, V2, y0 and y1 are written once a
// call and never read; a larger m takes ceil(m / 9) rounds, each after
// the first adding to the sums the one before stored (the same thread's
// addresses). The strip is 8 rows: every k2's table is read once a
// strip, so fewer rows would read the tables more often, and more would
// not fit a round's sums on chip.
//
// The design:
// - one persistent CTA of three warpgroups on each SM, walking over the
//   strips (blockIdx.x, + gridDim.x, ...);
// - warpgroups 0 and 1 multiply by wgmma.mma_async (bf16 in, float32
//   out), both operands shared-memory descriptors: A is a 64-row tile of
//   a table plane, the warpgroup's outputs; B is the operand rows, K-major
//   8 x 8 core matrices (no swizzle; 128 B between the two of a k16
//   step, 4 KB between groups of eight rows), written by the CUDA cores
//   in bf16 (hi and lo planes for "split") and made visible to the
//   tensor cores by a proxy fence;
// - each product's K sum of 256 runs in one accumulator set started
//   fresh (scale-d 0), as the plain version's one matmul; the sums over
//   k2 run in float32 on the CUDA cores;
// - warpgroup 2 is cut to 40 registers by setmaxnreg (the multiplying
//   warpgroups get 232): one thread keeps the tables' chunks of 32
//   inputs k1 in flight in a ring of shared-memory stages (32 KB for
//   "split", hi and lo; 16 KB for "bf16", hi), each a bulk copy
//   completing on the stage's mbarrier; a stage is freed by its eight
//   consumer warps once their products on it are done;
// - stage A, the combine and the epilogues run on the two multiplying
//   warpgroups between their products (one named barrier of 256 threads
//   orders the operand rows' writes and reads: two a k2 in pass 2; pass
//   3 alternates two operand buffers, so one a k2 does).
//
// What bounds it on the H100: device-memory bytes set the bound
// (chip_smoke.py::pfft_bounds: at 5 pairs of 1024^2, n = 1152, pass 2
// moves 250 MB, 0.075 ms at 3.35 TB/s, pass 3 137.5 MB, 0.041 ms). The
// kernels also read every k2's table once a strip from L2 (pass 2 m x
// 256 KB a strip of 8 rows under "split", 1.66 GB a call at m = 9, half
// under "bf16"; pass 3 half of pass 2's), issue nine times the wgmma
// instructions one table for all k2 would (N = 8 and 16), each reading
// its 2 KB A tile from shared memory, and run a strip's loads, combines
// and epilogue between them with nothing to overlap them; PERF.md
// section 6 has the times (chip_smoke.py phase 2) and what the
// variants of scripts/torch_k3_variants.py --source wg take off them.
//
// Budgets (a CTA): shared memory, the operand rows (pass 2: 3 groups of
// eight rows of 512 B in each bf16 plane, 24 KB "split", 12 KB "bf16";
// pass 3: 4 groups, 32 and 16 KB), four products' slots (64 KB), then as
// many ring stages as fit the 227 KB (4 of 32 KB "split", 9 of 16 KB
// "bf16"); registers: 168 at entry, 232 in the multiplying warpgroups
// after setmaxnreg, 40 in the producer's, no spills; a multiplying
// thread holds 2 x 40 accumulators of a round's first five N = 16
// products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_frag.cuh"
#include "wg_hopper.cuh"
#include "wg_mma_ss.cuh"

namespace {

using tc::bf16;

constexpr int kLane = 128;
constexpr int kThreads = 384;            // three warpgroups
constexpr int kConsumers = 256;          // warpgroups 0 and 1
constexpr int kConsumerWarps = 8;
constexpr int kR = 8;                    // rows (pass 2), columns (pass 3)
constexpr int kRound = 9;                // k2 a round
constexpr int kChunkK = 32;              // a table's inputs k1 a stage
constexpr int kChunks = kLane / kChunkK; // stages a table
constexpr int kHalf = kLane * kChunkK * 2;        // 8 KB: Re or Im, a plane
constexpr int kPlane = 2 * kHalf;                 // 16 KB: a bf16 plane
constexpr int kGroupBytes = 2 * kLane / 8 * 128;  // 4 KB: eight rows
constexpr int kImK = kLane / 8 * 128;             // the imaginary parts
constexpr int kSmemMax = 232448;                  // 227 KB a CTA
// A round's N = 16 products: slots 0 .. kRegK2 - 1 stay in registers,
// the others in shared memory (registers for all nine spill)
constexpr int kRegK2 = 5;
constexpr int kStoreBytes = (kRound - kRegK2) * kConsumers * 64;  // 64 KB

// Shared memory: the ring, then kGroups groups of eight operand rows in
// each bf16 plane (hi, then lo for "split"; pass 2: X, then [Y1; Y2];
// pass 3: [X+; X-] twice, a buffer for each parity of the k2 count), the
// products kept in shared memory, then the barriers; the ring takes as
// many stages as fit.
template <int kProd, int kGroups>
struct Layout {
  static constexpr int kStage = kProd == 3 ? 2 * kPlane : kPlane;
  static constexpr int kOperandPlane = kGroups * kGroupBytes;
  static constexpr int kOperands = (kProd == 3 ? 2 : 1) * kOperandPlane;
  static constexpr int kDepth =
      (kSmemMax - kOperands - kStoreBytes - 1024) / kStage;
  static constexpr int kOperandOffset = kDepth * kStage;
  static constexpr int kStoreOffset = kOperandOffset + kOperands;
  static constexpr int kBarOffset = kStoreOffset + kStoreBytes;
  static constexpr int kSmem = kBarOffset + 2 * kDepth * 8;
  static_assert(kSmem <= kSmemMax, "shared memory of a CTA");
};
constexpr int kRowsGroups = 3;  // pass 2
constexpr int kColsGroups = 4;  // pass 3

// A thread's 16 accumulators of slot j >= kRegK2 as four float4,
// [slot][quarter][thread] (consecutive threads, consecutive 16 bytes).
__device__ __forceinline__ void store_product(float4* kept, int j,
                                              const float* re,
                                              const float* im) {
  float4* at = kept + (j - kRegK2) * 4 * kConsumers + threadIdx.x;
  at[0] = make_float4(re[0], re[1], re[2], re[3]);
  at[kConsumers] = make_float4(re[4], re[5], re[6], re[7]);
  at[2 * kConsumers] = make_float4(im[0], im[1], im[2], im[3]);
  at[3 * kConsumers] = make_float4(im[4], im[5], im[6], im[7]);
}

__device__ __forceinline__ void load_product(const float4* kept, int j,
                                             float* re, float* im) {
  const float4* at = kept + (j - kRegK2) * 4 * kConsumers + threadIdx.x;
  const float4 a = at[0], b = at[kConsumers], c = at[2 * kConsumers],
               d = at[3 * kConsumers];
  re[0] = a.x; re[1] = a.y; re[2] = a.z; re[3] = a.w;
  re[4] = b.x; re[5] = b.y; re[6] = b.z; re[7] = b.w;
  im[0] = c.x; im[1] = c.y; im[2] = c.z; im[3] = c.w;
  im[4] = d.x; im[5] = d.y; im[6] = d.z; im[7] = d.w;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ void cfma(float2& s, float2 a, float2 b) {
  s.x = fmaf(a.x, b.x, fmaf(-a.y, b.y, s.x));
  s.y = fmaf(a.x, b.y, fmaf(a.y, b.x, s.y));
}

// The complex value z into operand row n, input k (real part at K = k,
// imaginary part at K = 128 + k) of the bf16 planes: split into hi =
// bf16(x) and lo = bf16(x - hi), or rounded into hi alone (round to
// nearest even, as ops/linalg.py::bf16_split).
template <int kProd>
__device__ __forceinline__ void put(unsigned char* hi, unsigned char* lo,
                                    int n, int k, float2 z) {
  const int off = (n >> 3) * kGroupBytes + (k >> 3) * 128 + (n & 7) * 16 +
                  (k & 7) * 2;
  const bf16 hr = __float2bfloat16_rn(z.x), hm = __float2bfloat16_rn(z.y);
  *reinterpret_cast<bf16*>(hi + off) = hr;
  *reinterpret_cast<bf16*>(hi + off + kImK) = hm;
  if constexpr (kProd == 3) {
    *reinterpret_cast<bf16*>(lo + off) =
        __float2bfloat16_rn(z.x - __bfloat162float(hr));
    *reinterpret_cast<bf16*>(lo + off + kImK) =
        __float2bfloat16_rn(z.y - __bfloat162float(hm));
  }
}

template <int kN, int kSign>
__device__ __forceinline__ void issue(float* d, uint64_t a, uint64_t b,
                                      int scale_d) {
  if constexpr (kN == 8)
    wg::wgmma_ss_n8<kSign>(d, a, b, scale_d);
  else
    wg::wgmma_ss_n16<kSign>(d, a, b, scale_d);
}

// d (+)= kSign A B for one k16 step: A the warpgroup's 64 rows of plane
// `part` (0 Re M^T, 1 Im M^T) of the stage, its k16 step s; B the operand
// rows at b_hi, b_lo, their k16 step kstep (0-7 real parts, 8-15
// imaginary); kProd products, the small ones first.
template <int kN, int kSign, int kProd>
__device__ __forceinline__ void mac(float* d, const unsigned char* stage,
                                    int part, int wgi, int s,
                                    const unsigned char* b_hi,
                                    const unsigned char* b_lo, int kstep,
                                    int scale_d) {
  const int a_off = part * kHalf + wgi * 4096 + 256 * s;
  const uint64_t ah = wg::smem_desc(stage + a_off, 128, 512);
  const uint64_t bh = wg::smem_desc(b_hi + 256 * kstep, 128, kGroupBytes);
  if constexpr (kProd == 3) {
    const uint64_t al = wg::smem_desc(stage + kPlane + a_off, 128, 512);
    const uint64_t bl =
        wg::smem_desc(b_lo + 256 * kstep, 128, kGroupBytes);
    issue<kN, kSign>(d, al, bh, scale_d);
    issue<kN, kSign>(d, ah, bl, 1);
    issue<kN, kSign>(d, ah, bh, 1);
  } else {
    issue<kN, kSign>(d, ah, bh, scale_d);
  }
}

// A stage's eight consumer warps are done with it.
__device__ __forceinline__ void release(uint64_t* empty, int stage) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) wg::mbar_arrive(empty + stage);
}

// The ring position of the consumers: stage and phase parity.
struct Ring {
  int stage = 0, phase = 0;
  template <int kDepth>
  __device__ __forceinline__ void next() {
    if (++stage == kDepth) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// One k2's product: re[0 .. kN / 2) and im[0 .. kN / 2), the real and
// imaginary parts of the warpgroup's 64 outputs, = the kN operand rows at
// b_hi, b_lo times the next table in the ring, over its kChunks stages,
// into accumulators started fresh.
template <int kN, class L, int kProd>
__device__ __forceinline__ void product(float* re, float* im,
                                        const unsigned char* ring,
                                        const unsigned char* b_hi,
                                        const unsigned char* b_lo, int wgi,
                                        uint64_t* full, uint64_t* empty,
                                        Ring& ring_pos) {
  constexpr int kAcc = kN / 2;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    re[i] = 0.f;
    im[i] = 0.f;
  }
  int prev = -1;
  for (int c = 0; c < kChunks; ++c) {
    wg::mbar_wait(full + ring_pos.stage, ring_pos.phase);
    const unsigned char* st = ring + ring_pos.stage * L::kStage;
    wg::wgmma_fence();
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int ks = 2 * c + s;
      const int scale = (c > 0 || s > 0) ? 1 : 0;
      // Re z = x_re Re M - x_im Im M;  Im z = x_re Im M + x_im Re M
      mac<kN, 1, kProd>(re, st, 0, wgi, s, b_hi, b_lo, ks, scale);
      mac<kN, -1, kProd>(re, st, 1, wgi, s, b_hi, b_lo, 8 + ks, 1);
      mac<kN, 1, kProd>(im, st, 1, wgi, s, b_hi, b_lo, ks, scale);
      mac<kN, 1, kProd>(im, st, 0, wgi, s, b_hi, b_lo, 8 + ks, 1);
    }
    wg::wgmma_commit();
    // the products of the stage before are done: free it
    wg::wgmma_wait<1>();
    if (prev >= 0) release(empty, prev);
    prev = ring_pos.stage;
    ring_pos.template next<L::kDepth>();
  }
  wg::wgmma_wait<0>();
  release(empty, prev);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    wg::fence_operand(re[i]);
    wg::fence_operand(im[i]);
  }
}

// One k2 slot's N = 16 product (slot j of the round): into pr, pi + 8 j
// for j < kRegK2, else into the shared-memory store.
template <class L, int kProd>
__device__ __forceinline__ void kept_product(
    int j, float* pr, float* pi, float4* kept, const unsigned char* ring,
    const unsigned char* b_hi, const unsigned char* b_lo, int wgi,
    uint64_t* full, uint64_t* empty, Ring& ring_pos) {
  if (j < kRegK2) {
    product<16, L, kProd>(pr + 8 * j, pi + 8 * j, ring, b_hi, b_lo, wgi,
                          full, empty, ring_pos);
  } else {
    float tr[8], ti[8];
    product<16, L, kProd>(tr, ti, ring, b_hi, b_lo, wgi, full, empty,
                          ring_pos);
    store_product(kept, j, tr, ti);
  }
}

// Slot j's 16 accumulators: from pr, pi + 8 j or the store.
__device__ __forceinline__ void slot_values(int j, const float* pr,
                                            const float* pi,
                                            const float4* kept, float* re,
                                            float* im) {
  if (j < kRegK2) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      re[i] = pr[8 * j + i];
      im[i] = pi[8 * j + i];
    }
  } else {
    load_product(kept, j, re, im);
  }
}

// The producer: for each of the CTA's strips and each k2, the chunks of
// the tables t0 .. 1 (0: mf[k2], 1: mi[k2]) into the ring, in the order
// the products take them. Table (t, k2) is kChunks stages of 2 kPlane
// bytes (hi, then lo) from tables + (t m + k2) 4 x 32 KB.
template <class L>
__device__ __forceinline__ void produce(unsigned char* ring,
                                        const unsigned char* tables,
                                        int strips, int m, int t0,
                                        uint64_t* full, uint64_t* empty) {
  int stage = 0, phase = 0, uses = 0;
  for (int st = blockIdx.x; st < strips; st += gridDim.x)
    for (int k2 = 0; k2 < m; ++k2)
      for (int t = t0; t < 2; ++t)
        for (int c = 0; c < kChunks; ++c, ++uses) {
          if (uses >= L::kDepth) wg::mbar_wait(empty + stage, phase ^ 1);
          wg::mbar_arrive_expect_tx(full + stage, L::kStage);
          wg::bulk_load(
              ring + stage * L::kStage,
              tables + (((size_t)t * m + k2) * kChunks + c) * 2 * kPlane,
              L::kStage, full + stage);
          if (++stage == L::kDepth) {
            stage = 0;
            phase ^= 1;
          }
        }
}

template <class L>
__device__ __forceinline__ void init_barriers(uint64_t* full,
                                              uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kDepth; ++s) {
      wg::mbar_init(full + s, 1);
      wg::mbar_init(empty + s, kConsumerWarps);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------
// pass 2

template <int kProd>
__global__ void __launch_bounds__(kThreads, 1)
pfft_rows_wg_kernel(const float2* __restrict__ u,
                    const float* __restrict__ a_re,
                    const float* __restrict__ a_im,
                    const float* __restrict__ b_re,
                    const float* __restrict__ b_im, int P, int W, int m,
                    float asign, const unsigned char* __restrict__ tables,
                    const float2* __restrict__ wf,
                    const float2* __restrict__ wi, float2* __restrict__ v1,
                    float2* __restrict__ v2) {
  using L = Layout<kProd, kRowsGroups>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  // X in row group 0, [Y1; Y2] in groups 1 and 2
  unsigned char* x_hi = smem + L::kOperandOffset;
  unsigned char* x_lo = x_hi + L::kOperandPlane;  // "split" only
  unsigned char* y_hi = x_hi + kGroupBytes;
  unsigned char* y_lo = x_lo + kGroupBytes;
  float4* kept = reinterpret_cast<float4*>(smem + L::kStoreOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + L::kDepth;

  const int n = kLane * m;
  const int row_strips = n / kR;
  const int strips = P * row_strips;
  const int wb = W / kLane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  init_barriers<L>(full, empty);

  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0)
      produce<L>(ring, tables, strips, m, 0, full, empty);
    return;
  }
  wg::setmaxnreg_inc<232>();
  const int wgi = warp >> 2, g = lane >> 2, q = lane & 3;
  // this thread's outputs b_h = b0 + 8 h of each product
  const int b0 = 64 * wgi + 16 * (warp & 3) + g;
  Ring ring_pos;
  for (int st = blockIdx.x; st < strips; st += gridDim.x) {
    const int p = st / row_strips, row0 = (st % row_strips) * kR;
    const size_t rows = (size_t)p * n + row0;
    const float2* urow = u + (rows + g) * W;
    for (int k0 = 0; k0 < m; k0 += kRound) {
      const int nk = m - k0 < kRound ? m - k0 : kRound;
      // per k2 (slot j): stage A, Z = X mf[k2]; Y1 = A . Z, Y2 = conj(B2)
      // . Z; P = [Y1; Y2] mi[k2]
      float pr[8 * kRegK2], pi[8 * kRegK2];
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        if (j >= nk) break;
        const int k2 = k0 + j;
        // stage A: X = sum_n2 wf[n2][k2] U[g, 128 n2 + k1], row g of the
        // strip (U from L2 after the first k2), inputs k1 = 4 (warp + 8
        // it) + lane % 4, into X, which the products of the k2 before
        // are done with
        {
          float2 s[4];
#pragma unroll
          for (int it = 0; it < 4; ++it) s[it] = make_float2(0.f, 0.f);
          for (int n0 = 0; n0 < wb; n0 += 4) {
            float2 x[4][4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
#pragma unroll
              for (int it = 0; it < 4; ++it)
                x[it][jj] =
                    n0 + jj < wb
                        ? urow[kLane * (n0 + jj) + 4 * (warp + 8 * it) + q]
                        : make_float2(0.f, 0.f);
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              if (n0 + jj >= wb) break;
              const float2 w = __ldg(wf + (n0 + jj) * m + k2);
#pragma unroll
              for (int it = 0; it < 4; ++it) cfma(s[it], w, x[it][jj]);
            }
          }
#pragma unroll
          for (int it = 0; it < 4; ++it)
            put<kProd>(x_hi, x_lo, g, 4 * (warp + 8 * it) + q, s[it]);
        }
        wg::fence_proxy_async();
        wg::bar_sync(1, kConsumers);

        // the spectra, loaded while the product runs
        float4 sp[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const size_t at =
                (rows + 2 * q + e) * n + kLane * k2 + b0 + 8 * h;
            sp[h][e] = make_float4(__ldg(a_re + at), __ldg(a_im + at),
                                   __ldg(b_re + at), __ldg(b_im + at));
          }
        float zr[4], zi[4];
        product<8, L, kProd>(zr, zi, ring, x_hi, x_lo, wgi, full, empty,
                             ring_pos);
        // Y is free: both warpgroups passed this k2's barrier after their
        // products of the k2 before
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float2 zz = make_float2(zr[2 * h + e], zi[2 * h + e]);
            const float4 c = sp[h][e];
            const float2 y1 = cmul(make_float2(c.x, asign * c.y), zz);
            const float2 y2 = cmul(make_float2(c.z, -asign * c.w), zz);
            put<kProd>(y_hi, y_lo, 2 * q + e, b0 + 8 * h, y1);
            put<kProd>(y_hi, y_lo, 8 + 2 * q + e, b0 + 8 * h, y2);
          }
        wg::fence_proxy_async();
        wg::bar_sync(1, kConsumers);
        kept_product<L, kProd>(j, pr, pi, kept, ring, y_hi, y_lo, wgi, full,
                               empty, ring_pos);
      }

      // V1 = sum_k2 wi P1, V2 = conj(sum_k2 wi P2)
      for (int a = 0; a < wb; ++a) {
        float2 s1[2][2], s2[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            s1[h][e] = make_float2(0.f, 0.f);
            s2[h][e] = make_float2(0.f, 0.f);
          }
#pragma unroll
        for (int j = 0; j < kRound; ++j) {
          if (j >= nk) break;
          const float2 w = __ldg(wi + a * m + k0 + j);
          float re[8], im[8];
          slot_values(j, pr, pi, kept, re, im);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * h + e;
              cfma(s1[h][e], w, make_float2(re[i], im[i]));
              cfma(s2[h][e], w, make_float2(re[i + 4], im[i + 4]));
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float2 o1 = s1[h][e];
            float2 o2 = make_float2(s2[h][e].x, -s2[h][e].y);
            const size_t at = (rows + 2 * q + e) * W + kLane * a + b0 + 8 * h;
            if (k0 > 0) {
              const float2 r1 = v1[at], r2 = v2[at];
              o1 = make_float2(o1.x + r1.x, o1.y + r1.y);
              o2 = make_float2(o2.x + r2.x, o2.y + r2.y);
            }
            v1[at] = o1;
            v2[at] = o2;
          }
      }
    }
  }
}

// ---------------------------------------------------------------------
// pass 3

template <int kProd>
__global__ void __launch_bounds__(kThreads, 1)
pfft_cols_inv_wg_kernel(const float2* __restrict__ v1,
                        const float2* __restrict__ v2, int P, int H, int W,
                        int m, const unsigned char* __restrict__ tables,
                        const float2* __restrict__ wi,
                        float* __restrict__ y0, float* __restrict__ y1) {
  using L = Layout<kProd, kColsGroups>;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* op_hi = smem + L::kOperandOffset;
  unsigned char* op_lo = op_hi + L::kOperandPlane;
  float4* kept = reinterpret_cast<float4*>(smem + L::kStoreOffset);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + L::kDepth;

  const int n = kLane * m;
  const int col_strips = W / kR;
  const int strips = P * col_strips;
  const int hb = H / kLane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  init_barriers<L>(full, empty);

  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0)
      produce<L>(ring, tables, strips, m, 1, full, empty);
    return;
  }
  wg::setmaxnreg_inc<232>();
  const int wgi = warp >> 2, g = lane >> 2, q = lane & 3;
  const int b0 = 64 * wgi + 16 * (warp & 3) + g;
  Ring ring_pos;
  int parity = 0;  // the operand buffer of the next k2
  for (int st = blockIdx.x; st < strips; st += gridDim.x) {
    const int p = st / col_strips, c0 = (st % col_strips) * kR;
    const float2* in1 = v1 + (size_t)p * n * W + c0 + g;
    const float2* in2 = v2 + (size_t)p * n * W + c0 + g;
    for (int k0 = 0; k0 < m; k0 += kRound) {
      const int nk = m - k0 < kRound ? m - k0 : kRound;
      // P = [X+; X-] mi[k2] of the round's k2 (slot j); stage A: column g
      // of the strip, rows k1 = 4 (warp + 8 it) + lane % 4 of block k2,
      // the next k2's loaded while the product runs
      float pr[8 * kRegK2], pi[8 * kRegK2];
      float2 a[4], b[4];
#pragma unroll
      for (int it = 0; it < 4; ++it) {
        const size_t at = (size_t)(kLane * k0 + 4 * (warp + 8 * it) + q) * W;
        a[it] = in1[at];
        b[it] = in2[at];
      }
#pragma unroll
      for (int j = 0; j < kRound; ++j) {
        if (j >= nk) break;
        // X+ into operand row g, X- into row 8 + g of the buffer, which
        // the products of the k2 before last have freed
        unsigned char* b_hi = op_hi + parity * 2 * kGroupBytes;
        unsigned char* b_lo = op_lo + parity * 2 * kGroupBytes;
#pragma unroll
        for (int it = 0; it < 4; ++it) {
          const int k1 = 4 * (warp + 8 * it) + q;
          put<kProd>(b_hi, b_lo, g, k1,
                     make_float2(a[it].x + b[it].x, a[it].y - b[it].y));
          put<kProd>(b_hi, b_lo, 8 + g, k1,
                     make_float2(a[it].x - b[it].x, a[it].y + b[it].y));
        }
        wg::fence_proxy_async();
        wg::bar_sync(1, kConsumers);
        if (j + 1 < nk) {
#pragma unroll
          for (int it = 0; it < 4; ++it) {
            const size_t at =
                (size_t)(kLane * (k0 + j + 1) + 4 * (warp + 8 * it) + q) * W;
            a[it] = in1[at];
            b[it] = in2[at];
          }
        }
        kept_product<L, kProd>(j, pr, pi, kept, ring, b_hi, b_lo, wgi, full,
                               empty, ring_pos);
        parity ^= 1;
      }

      // y0 = Re sum_k2 wi P+, y1 = Im sum_k2 wi P-
      for (int a = 0; a < hb; ++a) {
        float re[2][2], im[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            re[h][e] = 0.f;
            im[h][e] = 0.f;
          }
#pragma unroll
        for (int j = 0; j < kRound; ++j) {
          if (j >= nk) break;
          const float2 w = __ldg(wi + a * m + k0 + j);
          float vr[8], vi[8];
          slot_values(j, pr, pi, kept, vr, vi);
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 2 * h + e;
              re[h][e] = fmaf(w.x, vr[i], fmaf(-w.y, vi[i], re[h][e]));
              im[h][e] =
                  fmaf(w.x, vi[i + 4], fmaf(w.y, vr[i + 4], im[h][e]));
            }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const size_t at =
              ((size_t)p * H + kLane * a + b0 + 8 * h) * W + c0 + 2 * q;
          float2 r0 = make_float2(re[h][0], re[h][1]);
          float2 r1 = make_float2(im[h][0], im[h][1]);
          if (k0 > 0) {
            const float2 o0 = *reinterpret_cast<const float2*>(y0 + at);
            const float2 o1 = *reinterpret_cast<const float2*>(y1 + at);
            r0 = make_float2(r0.x + o0.x, r0.y + o0.y);
            r1 = make_float2(r1.x + o1.x, r1.y + o1.y);
          }
          *reinterpret_cast<float2*>(y0 + at) = r0;
          *reinterpret_cast<float2*>(y1 + at) = r1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------
// launches

int sms_per_device() {
  static int sms = 0;
  if (sms == 0) {
    int device = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      sms = 0;
  }
  return sms;
}

// One CTA an SM (at most one a strip); the first CUDA error of setting
// the shared-memory size and the launch.
template <class Kernel, class... Args>
int launch(Kernel kernel, int smem, int strips, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sms_per_device();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const int blocks = strips < sms ? strips : sms;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int kProd>
int rows_wg(const float2* u, const float* a_re, const float* a_im,
            const float* b_re, const float* b_im, int P, int W, int m,
            float asign, const void* tables, const float2* wf,
            const float2* wi, float2* v1, float2* v2, cudaStream_t stream) {
  return launch(pfft_rows_wg_kernel<kProd>,
                Layout<kProd, kRowsGroups>::kSmem,
                P * (kLane * m / kR), stream, u, a_re, a_im, b_re, b_im, P,
                W, m, asign, static_cast<const unsigned char*>(tables), wf,
                wi, v1, v2);
}

template <int kProd>
int cols_inv_wg(const float2* v1, const float2* v2, int P, int H, int W,
                int m, const void* tables, const float2* wi, float* y0,
                float* y1, cudaStream_t stream) {
  return launch(pfft_cols_inv_wg_kernel<kProd>,
                Layout<kProd, kColsGroups>::kSmem,
                P * (W / kR), stream, v1, v2, P, H, W, m,
                static_cast<const unsigned char*>(tables), wi, y0, y1);
}

bool valid(int m, int products) {
  return m >= 1 && (products == 1 || products == 3);
}

}  // namespace

extern "C" {

// Pass 2 on U (P, 128 m, W) complex and the spectra (P, 128 m, 128 m);
// tables are ops/pallas_fft.py::wg_stage_tables(m) on the device; wf, wi
// (m, m) complex. products is 3 ("split") or 1 ("bf16"). Returns the
// first CUDA error of setting the shared-memory size and the launch (0 =
// cudaSuccess); 1 (cudaErrorInvalidValue) for m < 1 or another number of
// products.
int pfft_rows_wg(const float2* u, const float* a_re, const float* a_im,
                 const float* b_re, const float* b_im, int P, int W, int m,
                 int conj_spec, const void* tables, const float2* wf,
                 const float2* wi, float2* v1, float2* v2, int products,
                 cudaStream_t stream) {
  if (!valid(m, products)) return static_cast<int>(cudaErrorInvalidValue);
  const float asign = conj_spec ? -1.f : 1.f;
  if (products == 3)
    return rows_wg<3>(u, a_re, a_im, b_re, b_im, P, W, m, asign, tables, wf,
                      wi, v1, v2, stream);
  return rows_wg<1>(u, a_re, a_im, b_re, b_im, P, W, m, asign, tables, wf,
                    wi, v1, v2, stream);
}

// Pass 3 on V1, V2 (P, 128 m, W) complex into y0, y1 (P, H, W); tables,
// wi and products as pfft_rows_wg; the same errors.
int pfft_cols_inv_wg(const float2* v1, const float2* v2, int P, int H,
                     int W, int m, const void* tables, const float2* wi,
                     float* y0, float* y1, int products,
                     cudaStream_t stream) {
  if (!valid(m, products)) return static_cast<int>(cudaErrorInvalidValue);
  if (products == 3)
    return cols_inv_wg<3>(v1, v2, P, H, W, m, tables, wi, y0, y1, stream);
  return cols_inv_wg<1>(v1, v2, P, H, W, m, tables, wi, y0, y1, stream);
}

const char* pfft_conv_wg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
