// K3's matrix-DFT passes on Hopper's warpgroup instructions (sm_90a):
// the three passes in every mode of the precision dial ("f32", the
// "highest" setting; "split", the default; "bf16", the "default"
// setting). Built by nvcc into a shared library with a plain C interface
// and loaded with ctypes (jolideco_torch/utils/cuda_build.py); the
// wrappers (pfft_cols_fwd_cuda, pfft_cols_fwd_tc_cuda,
// pfft_cols_fwd_bf16_cuda; pfft_rows_combine_cuda,
// pfft_rows_combine_tc_cuda, pfft_rows_combine_bf16_cuda;
// pfft_cols_inv_cuda, pfft_cols_inv_tc_cuda, pfft_cols_inv_bf16_cuda)
// and their plain versions (cols_fwd_plain, rows_combine_plain,
// cols_inv_plain with mode "f32", "split" or "bf16"; in "f32" the CPU
// path's own) are in jolideco_torch/ops/pallas_fft.py. The modes: kProd
// bf16 products a k16 step, 3 for "split" (hi.hi + hi.lo + lo.hi of the
// operands' bf16 hi and lo parts), 1 for "bf16" (hi.hi), and kF32 for
// "f32", six products of three-way splits (described after pass 3 of the
// bf16 modes, below).
//
// The algorithm: for P pairs of real (H, W) images (H, W multiples of
// 128) and a transform size n = 128 m, the three passes compute y0 = x0 *
// k0 and y1 = x1 * k1, cropped to (H, W), through one complex transform
// of z = x0 + i x1:
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
// What it replaces: the JAX package's ops/pallas_fft.py::_k1_body (pass
// 1: the axis-0 forward into permuted rows), ::_k2_body (pass 2: per row
// the lane forward, the spectrum combine, the lane inverse and the
// permuted forward, cropped to W columns) and ::_k3_body (pass 3: the
// axis-0 inverse plus permuted forward, cropped to H rows) under every
// precision. In this port they replace the earlier mma.sync kernels of
// the bf16 modes and the float32 FFMA kernels of the CUDA cores, which
// are gone.
//
// Pass 1 of the bf16 modes has its own section below (one table for
// every k2). In passes 2 and 3, and in pass 1 of "f32", the roundings
// are the plain version's, and the JAX package's: each product rounds
// its data operand (S_k2, A . Z or conj(B2) . Z, V1 +- conj V2) and the
// stage matrix of its k2, mf[k2] or mi[k2], whose entries carry the
// twiddles. So the k2 of a strip each take their own table; the
// products of a k2 are m64n8k16 (pass 2's lane forward, the strip's
// eight rows) and m64n16k16 (the two signs' eight rows each).
//
// A table is a complex 128 x 128 matrix M[k1][b] (input k1, output b),
// held as its real and imaginary planes, transposed: the products' A
// operand, the real parts Re M^T, then Im M^T. The operand rows hold a
// complex row as its 128 real parts followed by its 128 imaginary ones
// (K = 256). With wgmma's sign on A, a warpgroup's two accumulator tiles
// are the real and the imaginary parts of its 64 outputs b:
//     Re z = x_re Re M - x_im Im M,   Im z = x_re Im M + x_im Re M,
// four products a k16 step and a table plane read once, half the bytes
// of the interleaved real form (R, 256 x 256: the plain version's,
// ops/pallas_fft.py::interleaved_stage_matrices). Each thread's
// accumulator rows lane / 4 and lane / 4 + 8 of both tiles are outputs b
// and b + 8, complete.
//
// pfft_rows_wg_kernel (the bf16 modes) and pfft_rows_f32_kernel ("f32"),
// one body, per strip of kR = 8 rows of U (of one pair), per round of up
// to kRound = 9 k2 (one round for m <= 9), k2 by k2:
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
// registers, the others in its slots of shared memory (all nine in
// registers spill). For m <= 9, V1,
// V2, y0 and y1 are written once a call and never read; a larger m takes
// ceil(m / 9) rounds, each after the first adding to the sums the one
// before stored (the same thread's addresses). The strip is 8 rows:
// every k2's table is read once a strip, so fewer rows would read the
// tables more often, and more would not fit a round's sums on chip.
//
// The design:
// - one persistent CTA of three warpgroups on each SM, walking over the
//   strips (blockIdx.x, + gridDim.x, ...);
// - warpgroups 0 and 1 multiply by wgmma.mma_async (bf16 in, float32
//   out), B the operand rows, K-major 8 x 8 core matrices (no swizzle;
//   128 B between the two of a k16 step, 4 KB between groups of eight
//   rows), written by the CUDA cores in bf16 (the mode's planes: hi; hi
//   and lo; hi, mid and lo) and made visible to the tensor cores by a
//   proxy fence; A is a 64-row tile of a table plane, the warpgroup's
//   outputs, a shared-memory descriptor in the bf16 modes, from
//   registers in "f32" (below);
// - each product's K sum of 256 runs in accumulators started fresh, as
//   the plain version's one matmul; the sums over k2 run in float32 on
//   the CUDA cores;
// - warpgroup 2 is cut to 40 registers by setmaxnreg (the multiplying
//   warpgroups get 232): one thread keeps the tables' chunks in flight
//   in a ring of shared-memory stages (the bf16 modes: 32 inputs k1 a
//   stage, 32 KB for "split", hi and lo, 16 KB for "bf16", hi; "f32": 16
//   inputs, 24 KB, three parts), each a bulk copy completing on the
//   stage's mbarrier; a stage is freed by its eight consumer warps once
//   their products on it are done;
// - stage A, the combine and the epilogues run on the two multiplying
//   warpgroups between their products (one named barrier of 256 threads
//   orders the operand rows' writes and reads: two a k2 in pass 2; pass
//   3 alternates two operand buffers, so one a k2 does).
//
// What bounds it on the H100: device-memory bytes set the bound of the
// bf16 modes, operations that of "f32" (chip_smoke.py::pfft_bounds: at
// 5 pairs of 1024^2, n = 1152, pass 2 moves 250 MB, 0.075 ms at 3.35
// TB/s, pass 3 137.5 MB, 0.041 ms; pass 2 in "f32" 0.093 ms of six bf16
// products). The kernels also read every k2's table once a strip from
// L2 (pass 2 m x 256 KB a strip of 8 rows under "split", 1.66 GB a call
// at m = 9, half under "bf16", 384 KB and 2.49 GB under "f32"; pass 3
// half of pass 2's), issue nine times the wgmma instructions one table
// for all k2 would (N = 8 and 16), and run a strip's loads, combines and
// epilogue between them with nothing to overlap them; PERF.md section 6
// has the times (chip_smoke.py phase 2) and what the variants of
// scripts/torch_k3_variants.py take off them.
//
// Budgets (a CTA): shared memory, the operand rows (pass 2: 3 groups of
// eight rows of 512 B in each bf16 plane, 24 KB "split", 12 KB "bf16",
// 36 KB "f32"; pass 3: 4 groups, 32 and 16 KB), the products kept in
// shared memory (16 KB each: 64 KB in the bf16 modes), then as many ring
// stages as fit the 227 KB (4 of 32 KB "split", 9 of 16 KB "bf16");
// registers: 168 at entry, 232 in the multiplying warpgroups after
// setmaxnreg, 40 in the producer's, no spills; a multiplying thread
// holds 2 x 8 accumulators of each of a round's first five N = 16
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
// the others in shared memory (registers for all nine spill; in pass 2
// of "f32" 3, 4, 6 or 7 in registers ran slower, scripts/
// torch_k3_variants.py --source f32, rows_reg*)
constexpr int kRegK2 = 5;
constexpr int kStoreBytes = (kRound - kRegK2) * kConsumers * 64;  // 64 KB

// "f32": six bf16 products of three-way splits (kF32 in place of kProd);
// its tables' stages, a chunk of 16 inputs k1 in three parts
constexpr int kF32 = 6;
constexpr int kParts = 3;                          // hi, mid, lo
constexpr int kChunk3 = 16;                        // inputs k1 a stage
constexpr int kChunks3 = kLane / kChunk3;          // 8 stages a table
constexpr int kPlane3 = kLane * kChunk3 * 2;       // 4 KB: Re or Im of a part
constexpr int kStage3 = kParts * 2 * kPlane3;      // 24 KB

// Shared memory: the ring of kStageBytes stages, the operand rows
// (kOperandBytes), kExtraBytes of the kernel's own, then the barriers;
// the ring takes as many stages as fit. A table is kTableStages stages,
// kStrideBytes apart in device memory.
template <int kStageBytes, int kTableStagesN, int kStrideBytes,
          int kOperandBytes, int kExtraBytes>
struct RingLayout {
  static constexpr int kStage = kStageBytes;
  static constexpr int kTableStages = kTableStagesN;
  static constexpr int kStride = kStrideBytes;
  static constexpr int kDepth =
      (kSmemMax - kOperandBytes - kExtraBytes - 1024) / kStage;
  static constexpr int kOperandOffset = kDepth * kStage;
  static constexpr int kExtraOffset = kOperandOffset + kOperandBytes;
  static constexpr int kBarOffset = kExtraOffset + kExtraBytes;
  static constexpr int kSmem = kBarOffset + 2 * kDepth * 8;
  static_assert(kSmem <= kSmemMax, "shared memory of a CTA");
};

// The bf16 modes' passes 2 and 3: a stage the hi plane (then the lo plane
// for "split") of 32 inputs; kGroups groups of eight operand rows in each
// plane (pass 2: X, then [Y1; Y2]; pass 3: [X+; X-] twice, a buffer for
// each parity of the k2 count); then the products kept in shared memory.
template <int kProd, int kGroups>
struct Layout
    : RingLayout<kProd == 3 ? 2 * kPlane : kPlane, kChunks, 2 * kPlane,
                 (kProd == 3 ? 2 : 1) * kGroups * kGroupBytes, kStoreBytes> {
  static constexpr int kOperandPlane = kGroups * kGroupBytes;
};
constexpr int kRowsGroups = 3;  // pass 2
constexpr int kColsGroups = 4;  // pass 3

// Pass 2 of mode kProd: Layout<kProd, kRowsGroups>; in "f32" (kF32) a
// stage a chunk's three parts, and three operand planes of its groups
template <int kProd>
struct RowsLayout : Layout<kProd, kRowsGroups> {};
template <>
struct RowsLayout<kF32>
    : RingLayout<kStage3, kChunks3, kStage3,
                 kParts * kRowsGroups * kGroupBytes, kStoreBytes> {
  static constexpr int kOperandPlane = kRowsGroups * kGroupBytes;
};

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

// The byte of operand row n, input k (its real part; the imaginary part
// is kImK further) in a bf16 plane of 8 x 8 core matrices.
__device__ __forceinline__ int operand_offset(int n, int k) {
  return (n >> 3) * kGroupBytes + (k >> 3) * 128 + (n & 7) * 16 +
         (k & 7) * 2;
}

// The complex value z into operand row n, input k (real part at K = k,
// imaginary part at K = 128 + k) of the bf16 planes: split into hi =
// bf16(x) and lo = bf16(x - hi), or rounded into hi alone (round to
// nearest even, as ops/linalg.py::bf16_split).
template <int kProd>
__device__ __forceinline__ void put(unsigned char* hi, unsigned char* lo,
                                    int n, int k, float2 z) {
  const int off = operand_offset(n, k);
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

// x in three bf16 parts, round to nearest even (ops/linalg.py::
// bf16_split3): hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid);
// both differences are exact in float32
__device__ __forceinline__ void split3(float x, bf16 (&part)[kParts]) {
  part[0] = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(part[0]);
  part[1] = __float2bfloat16_rn(r);
  part[2] = __float2bfloat16_rn(r - __bfloat162float(part[1]));
}

// The complex value z into operand row n, input k of the three parts'
// planes (`plane` bytes apart), split three ways.
__device__ __forceinline__ void put3(unsigned char* op, int plane, int n,
                                     int k, float2 z) {
  const int off = operand_offset(n, k);
  bf16 re[kParts], im[kParts];
  split3(z.x, re);
  split3(z.y, im);
#pragma unroll
  for (int p = 0; p < kParts; ++p) {
    *reinterpret_cast<bf16*>(op + p * plane + off) = re[p];
    *reinterpret_cast<bf16*>(op + p * plane + off + kImK) = im[p];
  }
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The complex inputs k0 .. k0 + 7 (k0 a multiple of 8) of operand row n,
// split three ways: per part (op_part bytes apart), one 16-byte row of a
// core matrix for the real parts and one for the imaginary parts (eight
// threads of consecutive rows n write 128 bytes on distinct banks).
__device__ __forceinline__ void put_row8(unsigned char* op, int op_part,
                                         int n, int k0,
                                         const float2 (&z)[8]) {
  const int off = operand_offset(n, k0);
  uint32_t re[kParts][4], im[kParts][4];
#pragma unroll
  for (int r = 0; r < 8; r += 2) {
    bf16 a[kParts], b[kParts], c[kParts], d[kParts];
    split3(z[r].x, a);
    split3(z[r + 1].x, b);
    split3(z[r].y, c);
    split3(z[r + 1].y, d);
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      re[q][r / 2] = pack2(a[q], b[q]);
      im[q][r / 2] = pack2(c[q], d[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    unsigned char* at = op + q * op_part + off;
    *reinterpret_cast<uint4*>(at) =
        make_uint4(re[q][0], re[q][1], re[q][2], re[q][3]);
    *reinterpret_cast<uint4*>(at + kImK) =
        make_uint4(im[q][0], im[q][1], im[q][2], im[q][3]);
  }
}

// The complex value z into operand row n, input k of the planes of mode
// kProd (L::kOperandPlane bytes apart).
template <int kProd, class L>
__device__ __forceinline__ void put_op(unsigned char* op, int n, int k,
                                       float2 z) {
  if constexpr (kProd == kF32)
    put3(op, L::kOperandPlane, n, k, z);
  else
    put<kProd>(op, op + L::kOperandPlane, n, k, z);
}

template <int kN, int kSign>
__device__ __forceinline__ void issue(float* d, uint64_t a, uint64_t b,
                                      int scale_d) {
  static_assert(kN == 8 || kN == 16 || kN == 32 || kN == 48, "wgmma N");
  if constexpr (kN == 8)
    wg::wgmma_ss_n8<kSign>(d, a, b, scale_d);
  else if constexpr (kN == 16)
    wg::wgmma_ss_n16<kSign>(d, a, b, scale_d);
  else if constexpr (kN == 32)
    wg::wgmma_ss_n32<kSign>(d, a, b, scale_d);
  else
    wg::wgmma_ss_n48<kSign>(d, a, b, scale_d);
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

// The consumers' walk over the next table in the ring: for each of its
// L::kTableStages stages, wait for it to be full, issue its products
// (step(c, stage) fences, issues them and returns; the walk commits
// them) and free it once they are done. kPending groups of products
// stay in flight past a commit: 1 where both operands are in shared
// memory, 0 where A is in registers that the next step loads anew. The
// loop is unrolled kUnroll stages at a time: 1 for the bf16 modes'
// products (fully unrolled, the "split" instances spill; ptxas' own
// choice ran "split" pass 2 at 0.697 ms against 0.487 with 1); for the
// float32 ones kColsUnroll and kRowsUnroll say (an NVIDIA H100 80GB HBM3
// at 700 W, scripts/torch_k3_variants.py's walk_* variants).
template <class L, int kPending, int kUnroll, class Step>
__device__ __forceinline__ void walk_table(const unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           Ring& ring_pos, Step&& step) {
  static_assert(kPending == 0 || kPending == 1, "groups in flight");
  int prev = -1;
#pragma unroll(kUnroll)
  for (int c = 0; c < L::kTableStages; ++c) {
    wg::mbar_wait(full + ring_pos.stage, ring_pos.phase);
    step(c, ring + ring_pos.stage * L::kStage);
    wg::wgmma_commit();
    wg::wgmma_wait<kPending>();
    // the products of this stage (kPending 0) or the one before are done
    if constexpr (kPending == 0) {
      release(empty, ring_pos.stage);
    } else {
      if (prev >= 0) release(empty, prev);
      prev = ring_pos.stage;
    }
    ring_pos.template next<L::kDepth>();
  }
  if constexpr (kPending > 0) {
    wg::wgmma_wait<0>();
    release(empty, prev);
  }
}

// One k2's product in a bf16 mode: re[0 .. kN / 2) and im[0 .. kN / 2),
// the real and imaginary parts of the warpgroup's 64 outputs, = the kN
// operand rows at b_hi, b_lo times the next table in the ring, over its
// kChunks stages, into accumulators started fresh.
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
  walk_table<L, 1, 1>(ring, full, empty, ring_pos,
                   [&](int c, const unsigned char* st) {
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
  });
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    wg::fence_operand(re[i]);
    wg::fence_operand(im[i]);
  }
}

// The A fragments of this warp's 16 rows (outputs b) of its
// warpgroup's 64, for each part and plane (0 Re M^T, 1 Im M^T) of a
// float32 stage: ldmatrix of the core matrices (rows 0-7, k 0-7), (8-15,
// 0-7), (0-7, 8-15), (8-15, 8-15), 256 bytes between row groups.
__device__ __forceinline__ void load_a(uint32_t (&a)[kParts][2][4],
                                       const unsigned char* stage, int wgi) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  const int off = (8 * wgi + 2 * ((threadIdx.x >> 5) & 3) + (i & 1)) * 256 +
                  (i >> 1) * 128 + (lane & 7) * 16;
#pragma unroll
  for (int p = 0; p < kParts; ++p)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      tc::ldsm_x4(a[p][r], reinterpret_cast<const bf16*>(
                               stage + (2 * p + r) * kPlane3 + off));
}

// Keeps a step's fragments in their registers until the products that
// read them are done (called after the wait that covers them): an
// asynchronous product reads its A registers after the instruction.
__device__ __forceinline__ void fence_a(uint32_t (&a)[kParts][2][4]) {
#pragma unroll
  for (int p = 0; p < kParts; ++p)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[p][r][i])::"memory");
}

// The accumulators of a k2's product over kN operand rows (kN / 2 a
// thread in each): hi.hi, and the five smaller products, apart. The
// tensor cores' float32 sums truncate, so each instruction may lose up
// to a unit of the last place of its accumulator; hi.hi alone takes 16
// instructions an output, the others 80 at 2^-8 of its size (in one set:
// 96 at the full size, 1.7e-6 of the max-abs of random data, where the
// float32 plain version reaches 3.6e-7 on an H100).
template <int kN>
struct Acc6 {
  float re[kN / 2], im[kN / 2];      // hi.hi
  float re_s[kN / 2], im_s[kN / 2];  // the other five
};

template <int kSign>
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t b) {
  wg::wgmma_rs_n32<kSign>(d, a, b, 1);
}

template <int kSign>
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t b) {
  wg::wgmma_rs_n16<kSign>(d, a, b, 1);
}

template <int kSign>
__device__ __forceinline__ void mma_rs(float (&d)[4], const uint32_t (&a)[4],
                                       uint64_t b) {
  wg::wgmma_rs_n8<kSign>(d, a, b, 1);
}

// One product of k16 step t: A part a (its Re M^T and Im M^T fragments)
// by operand part b, B the operand rows' real parts at k16 step t and
// imaginary ones at 8 + t:
//     Re z += x_re Re M - x_im Im M,   Im z += x_re Im M + x_im Re M.
template <int kAcc>
__device__ __forceinline__ void mac(float (&re)[kAcc], float (&im)[kAcc],
                                    const uint32_t (&a)[2][4],
                                    const unsigned char* b, int t) {
  const uint64_t br = wg::smem_desc(b + 256 * t, 128, kGroupBytes);
  const uint64_t bi = wg::smem_desc(b + 256 * (8 + t), 128, kGroupBytes);
  mma_rs<1>(re, a[0], br);
  mma_rs<-1>(re, a[1], bi);
  mma_rs<1>(im, a[1], br);
  mma_rs<1>(im, a[0], bi);
}

// k16 step t of a k2's product: the six products (A part, B part) whose
// orders sum below three, the small ones first; the operand's parts are
// `part` bytes apart.
template <int kN>
__device__ __forceinline__ void mac6(Acc6<kN>& d,
                                     const uint32_t (&a)[kParts][2][4],
                                     const unsigned char* op, int part,
                                     int t) {
  mac(d.re_s, d.im_s, a[2], op, t);             // lo . hi
  mac(d.re_s, d.im_s, a[1], op + part, t);      // mid . mid
  mac(d.re_s, d.im_s, a[0], op + 2 * part, t);  // hi . lo
  mac(d.re_s, d.im_s, a[1], op, t);             // mid . hi
  mac(d.re_s, d.im_s, a[0], op + part, t);      // hi . mid
  mac(d.re, d.im, a[0], op, t);                 // hi . hi
}

// One k2's product in "f32": re, im (the warpgroup's 64 outputs b by the
// kN operand rows) = the operand rows (three parts, `part` bytes apart)
// times the next table in the ring, over its kChunks3 stages (the walk
// unrolled kUnroll at a time), into accumulators started at zero, the
// two sets of Acc6 added at the end. A step's fragments are loaded once
// the step before is done (loading them while it multiplies, in a second
// set, was no faster).
template <class L, int kN, int kUnroll>
__device__ __forceinline__ void product6(float* re, float* im,
                                         const unsigned char* ring,
                                         const unsigned char* op, int part,
                                         int wgi, uint64_t* full,
                                         uint64_t* empty, Ring& ring_pos) {
  constexpr int kAcc = kN / 2;
  // the zeros are written before the first product (left to itself, the
  // compiler writes each set's between products, and ptxas then waits
  // for those in flight: its C7517)
  Acc6<kN> d;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    d.re[i] = 0.f;
    d.im[i] = 0.f;
    d.re_s[i] = 0.f;
    d.im_s[i] = 0.f;
    wg::fence_operand(d.re[i]);
    wg::fence_operand(d.im[i]);
    wg::fence_operand(d.re_s[i]);
    wg::fence_operand(d.im_s[i]);
  }
  uint32_t a[kParts][2][4];
  walk_table<L, 0, kUnroll>(ring, full, empty, ring_pos,
                            [&](int t, const unsigned char* stage) {
    // the step before is done: its fragments are free
    if (t > 0) fence_a(a);
    load_a(a, stage, wgi);
    wg::wgmma_fence();
    mac6(d, a, op, part, t);
  });
  fence_a(a);
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    wg::fence_operand(d.re[i]);
    wg::fence_operand(d.im[i]);
    wg::fence_operand(d.re_s[i]);
    wg::fence_operand(d.im_s[i]);
    re[i] = d.re_s[i] + d.re[i];
    im[i] = d.im_s[i] + d.im[i];
  }
}

// One k2 slot's N = 16 product (slot j of the round): prod(re, im) into
// pr, pi + 8 j for j < kRegK2, else into the shared-memory store.
template <class Prod>
__device__ __forceinline__ void kept_product(int j, float* pr, float* pi,
                                             float4* kept, Prod&& prod) {
  if (j < kRegK2) {
    prod(pr + 8 * j, pi + 8 * j);
  } else {
    float tr[8], ti[8];
    prod(tr, ti);
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

// The producer: for each of the CTA's items, each of its k2 and each of
// the tables t0 .. t1 - 1 (0: mf[k2], 1: mi[k2]), table (t, k2)'s stages
// into the ring, in the order the products take them: stage c is L::kStage
// bytes from tables + ((t m + k2) L::kTableStages + c) L::kStride (the
// bf16 modes: hi, then lo for "split"; the float32 passes: a chunk's three
// parts). An item takes every k2 in turn, or (one_k2) k2 = item % m alone.
template <class L>
__device__ __forceinline__ void produce(unsigned char* ring,
                                        const unsigned char* tables,
                                        int items, int m, int t0, int t1,
                                        bool one_k2, uint64_t* full,
                                        uint64_t* empty) {
  int stage = 0, phase = 0, uses = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int k_first = one_k2 ? it % m : 0;
    const int k_end = one_k2 ? k_first + 1 : m;
    for (int k2 = k_first; k2 < k_end; ++k2)
      for (int t = t0; t < t1; ++t)
        for (int c = 0; c < L::kTableStages; ++c, ++uses) {
          if (uses >= L::kDepth) wg::mbar_wait(empty + stage, phase ^ 1);
          wg::mbar_arrive_expect_tx(full + stage, L::kStage);
          wg::bulk_load(ring + stage * L::kStage,
                        tables + (((size_t)t * m + k2) * L::kTableStages +
                                  c) * L::kStride,
                        L::kStage, full + stage);
          if (++stage == L::kDepth) {
            stage = 0;
            phase ^= 1;
          }
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
// pass 1 of the bf16 modes
//
// pfft_cols_fwd_wg_kernel<kProd, kCols> computes the plain version's
// pass 1 (ops/pallas_fft.py::cols_fwd_plain, mode "split" or "bf16"):
// since mf[k2][n1][k1] = W128^(n1 k1) Wn^(n1 k2), stage A ends with the
// twiddle tw[k2][n1] = Wn^(n1 k2) in float32,
//     S'[n1][c] = tw[k2][n1] sum_n2 wf[n2][k2] z[128 n2 + n1][c]
// (z = x0 + i x1), and every k2 multiplies the one matrix F = mf[0]:
//     U[128 k2 + k1][c] = (S'^T F)[c][k1].
// The roundings are the plain version's: the operand S' split (or
// rounded) once as it is written, F's bf16 planes (wg_stage_tables(m)[0,
// 0], the table of passes 2 and 3, its first k2). The JAX package's
// _k1_body rounds mf[k2] itself for each k2 instead; both lie within
// split's error of float64 (tests/test_torch_pfft_split.py).
//
// An item is (pair, kCols columns), a unit an item's kG = kN1 / kCols
// consecutive k2 (kN1 = 32 operand rows; the last unit of an item may
// run past m: zero rows, nothing stored). Items of 16 columns where the
// image has up to 1024 rows, of 8 up to 2048 (the x2 path's m = 17);
// taller images read the blocks past the 16th from L2 each unit. The CTA
// (one an SM) walks its units (UnitWalk: in rounds of neighbouring
// items, so that the CTAs read and write the same rows at about the
// same time; at 5 pairs of 1024^2, n = 1152, 1600 units: two rounds of
// 132 items, then the last 56 items' 280 units, 12 or 13 a CTA) with its
// three warpgroups in two roles:
//   warpgroup 0 (setmaxnreg 120): copies F into shared memory once (4
//            bulk copies on an mbarrier: chunks of 32 inputs n1, the hi
//            and lo planes of Re F^T and Im F^T under "split", 128 KB,
//            the hi planes under "bf16", 64 KB); then, unit by unit, waits
//            for a full operand buffer, multiplies both tiles of 64
//            outputs k1 (A = F's planes by descriptor, B = the operand
//            rows, m64n32k16, four real products a k16 step with wgmma's
//            sign on A, kProd bf16 products each), frees the buffer and
//            stores U[128 k2 + k1][c] from its accumulators (16 bytes a
//            thread, 64 contiguous bytes a row of four threads);
//   warpgroups 1 and 2 (setmaxnreg 192): stage A into the other
//            buffer. A thread's points are column c = tid % kCols and
//            kPts = kCols / 2 consecutive n1; their x of the item's row
//            blocks (up to 128 / kCols) is read from device memory once
//            an item into its registers (128 of them); the sums of a
//            unit's k2 run in one pass over the blocks, in float32, then
//            the twiddle, then the split into the mode's planes as the
//            operand rows are written (16- or 8-byte pieces of core-matrix
//            rows), fenced to the async proxy, the buffer marked full.
// Two operand buffers (full and empty mbarriers each) let stage A run a
// unit ahead of the products.
//
// What bounds it on the H100: bytes, x read once and U written once (at
// 5 pairs of 1024^2, n = 1152: 90 MB, 0.027 ms at 3.35 TB/s;
// chip_smoke.py::pfft_bounds). The tensor cores' work is 4 real products
// a complex one (9.1 G bf16 multiply-adds in "split", 0.018 ms at the
// bf16 peak), their A tile read from shared memory by each instruction.
// What holds it above that is the stage-A warpgroups' path, x's loads at
// each new item and the float32 sums on eight warps (scripts/
// torch_k3_variants.py, fwd_*); PERF.md section 6 has the times
// (chip_smoke.py phase 2, scripts/torch_k3_times.py in turns with the
// earlier kernel).
//
// Budgets (a CTA): shared memory F (128 or 64 KB) and two operand
// buffers (32 rows in each plane: 32 or 16 KB each); registers 168 at
// entry, 120 in warpgroup 0 (64 accumulators), 192 in warpgroups 1 and
// 2 (128 of x), no spills (ptxas, chip_smoke.py phase 1).

constexpr int kFwdThreads = 384;    // three warpgroups
constexpr int kStageThreads = 256;  // warpgroups 1 and 2: stage A
constexpr int kN1 = 32;             // operand rows of a product
constexpr int kFwdBufs = 2;         // operand buffers
// registers a thread after setmaxnreg: the multiplying warpgroup's (two
// tiles of accumulators) and the stage-A warpgroups' (x's rows)
constexpr int kMmaRegs = 120, kStageRegs = 192;
static_assert(128 * kMmaRegs + kStageThreads * kStageRegs <= 65536,
              "the SM's registers");

template <int kProd>
struct FwdLayout {
  static constexpr int kFChunk = (kProd == 3 ? 2 : 1) * kPlane;
  static constexpr int kF = kChunks * kFChunk;
  static constexpr int kOpPlane = kN1 / 8 * kGroupBytes;
  static constexpr int kBuf = (kProd == 3 ? 2 : 1) * kOpPlane;
  static constexpr int kBarOffset = kF + kFwdBufs * kBuf;
  // F's barrier, then full and empty of each operand buffer
  static constexpr int kSmem = kBarOffset + (1 + 2 * kFwdBufs) * 8;
  static_assert(kSmem <= kSmemMax, "shared memory of a CTA");
};

// kW 32-bit words at `at` (16- or 8-byte aligned)
template <int kW>
__device__ __forceinline__ void store_words(unsigned char* at,
                                            const uint32_t (&w)[kW]) {
  if constexpr (kW == 4)
    *reinterpret_cast<uint4*>(at) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(at) = make_uint2(w[0], w[1]);
}

// The complex values s[0 .. kPts) into operand row n, inputs k0 .. k0 +
// kPts - 1 (k0 a multiple of kPts, kPts 8 or 4) of the planes of mode
// kProd (`plane` bytes apart): hi = bf16(x), and for "split" lo = bf16(x
// - hi), round to nearest even; the real parts, then the imaginary ones
// kImK further.
template <int kProd, int kPts>
__device__ __forceinline__ void put_rows(unsigned char* op, int plane, int n,
                                         int k0, const float2 (&s)[kPts]) {
  constexpr int kW = kPts / 2;
  uint32_t hr[kW], hm[kW], lr[kW], lm[kW];
#pragma unroll
  for (int r = 0; r < kW; ++r) {
    const float2 a = s[2 * r], b = s[2 * r + 1];
    const bf16 ar = __float2bfloat16_rn(a.x), br = __float2bfloat16_rn(b.x);
    const bf16 am = __float2bfloat16_rn(a.y), bm = __float2bfloat16_rn(b.y);
    hr[r] = pack2(ar, br);
    hm[r] = pack2(am, bm);
    if constexpr (kProd == 3) {
      lr[r] = pack2(__float2bfloat16_rn(a.x - __bfloat162float(ar)),
                    __float2bfloat16_rn(b.x - __bfloat162float(br)));
      lm[r] = pack2(__float2bfloat16_rn(a.y - __bfloat162float(am)),
                    __float2bfloat16_rn(b.y - __bfloat162float(bm)));
    }
  }
  unsigned char* at = op + operand_offset(n, k0);
  store_words(at, hr);
  store_words(at + kImK, hm);
  if constexpr (kProd == 3) {
    store_words(at + plane, lr);
    store_words(at + plane + kImK, lm);
  }
}

// Chunk c of a product: re, im (the 64 outputs k1 of tile t by the kN1
// operand rows at b_hi, b_lo) += the rows' inputs 32 c .. 32 c + 31 times
// F's (its chunk resident at st), issued, not waited for; chunk 0 starts
// the sums.
template <int kProd>
__device__ __forceinline__ void fwd_chunk(float* re, float* im,
                                          const unsigned char* st,
                                          const unsigned char* b_hi,
                                          const unsigned char* b_lo, int t,
                                          int c) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const int ks = 2 * c + s;
    const int scale = (c > 0 || s > 0) ? 1 : 0;
    // Re U = s_re Re F - s_im Im F;  Im U = s_re Im F + s_im Re F
    mac<kN1, 1, kProd>(re, st, 0, t, s, b_hi, b_lo, ks, scale);
    mac<kN1, -1, kProd>(re, st, 1, t, s, b_hi, b_lo, 8 + ks, 1);
    mac<kN1, 1, kProd>(im, st, 1, t, s, b_hi, b_lo, ks, scale);
    mac<kN1, 1, kProd>(im, st, 0, t, s, b_hi, b_lo, 8 + ks, 1);
  }
}

// A CTA's units: in round r (while every CTA has a whole item) item r
// gridDim.x + blockIdx.x, all its units; then the units of the items
// left, a contiguous run a CTA. So the CTAs work on neighbouring items,
// the same rows of x and of U, at about the same time, and no CTA has
// more than one unit above the mean.
struct UnitWalk {
  int groups, rounds, rem0, rem1;
  __device__ UnitWalk(int items, int groups_) : groups(groups_) {
    rounds = items / gridDim.x;
    const long long rem = (long long)(items - rounds * gridDim.x) * groups;
    rem0 = (int)(rem * blockIdx.x / gridDim.x);
    rem1 = (int)(rem * (blockIdx.x + 1) / gridDim.x);
  }
  __device__ int count() const { return rounds * groups + rem1 - rem0; }
  // the CTA's unit s: its item and its group of k2
  __device__ void at(int s, int& item, int& group) const {
    if (s < rounds * groups) {
      item = s / groups * gridDim.x + blockIdx.x;
      group = s % groups;
    } else {
      const int r = rem0 + s - rounds * groups;
      item = rounds * gridDim.x + r / groups;
      group = r % groups;
    }
  }
};

template <int kProd, int kCols>
__global__ void __launch_bounds__(kFwdThreads, 1)
pfft_cols_fwd_wg_kernel(const float* __restrict__ x0,
                        const float* __restrict__ x1, int P, int H, int W,
                        int m, const unsigned char* __restrict__ tables,
                        const float2* __restrict__ wf,
                        const float2* __restrict__ tw,
                        float2* __restrict__ u) {
  using L = FwdLayout<kProd>;
  constexpr int kG = kN1 / kCols;                      // k2 a unit
  constexpr int kPts = kLane * kCols / kStageThreads;  // n1 a thread
  constexpr int kRes = kLane / kCols;                  // row blocks kept
  static_assert(kN1 % kCols == 0 && (kPts == 8 || kPts == 4), "shapes");
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* f = smem;
  unsigned char* op = smem + L::kF;
  uint64_t* fbar = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* full = fbar + 1;
  uint64_t* empty = full + kFwdBufs;

  const int n = kLane * m, hb = H / kLane;
  const int tiles = W / kCols, groups = (m + kG - 1) / kG;
  const UnitWalk walk(P * tiles, groups);
  const int units = walk.count();
  if (units == 0) return;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    wg::mbar_init(fbar, 1);
    for (int b = 0; b < kFwdBufs; ++b) {
      wg::mbar_init(full + b, kStageThreads);
      wg::mbar_init(empty + b, 4);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();

  if (warp >= 4) {
    // stage A: S' of each unit's k2 into operand rows j kCols + c of
    // buffer i % kFwdBufs (i the unit's place in the CTA's walk), once
    // the products of unit i - kFwdBufs are done with it
    wg::setmaxnreg_inc<kStageRegs>();
    const int ta = tid - 128;
    const int cs = ta % kCols, n1s = (ta / kCols) * kPts;
    float2 z[kRes][kPts];
    int item = -1;
    for (int i = 0; i < units; ++i) {
      const int b = i % kFwdBufs;
      unsigned char* buf = op + b * L::kBuf;
      int it, group;
      walk.at(i, it, group);
      const int k2_0 = group * kG;
      // this thread's x of the item: rows 128 n2 + n1s + r, column cs
      const size_t base =
          ((size_t)(it / tiles) * H + n1s) * W + (it % tiles) * kCols + cs;
      if (it != item) {
        item = it;
#pragma unroll
        for (int n2 = 0; n2 < kRes; ++n2) {
          if (n2 >= hb) break;
#pragma unroll
          for (int r = 0; r < kPts; ++r) {
            const size_t at = base + ((size_t)kLane * n2 + r) * W;
            z[n2][r] = make_float2(__ldg(x0 + at), __ldg(x1 + at));
          }
        }
      }
      if (i >= kFwdBufs)
        wg::mbar_wait(empty + b, ((i / kFwdBufs) & 1) ^ 1);
      // the sums over n2 of the unit's k2 at once (a k2 past m weighs 0)
      float2 s[kG][kPts];
#pragma unroll
      for (int j = 0; j < kG; ++j)
#pragma unroll
        for (int r = 0; r < kPts; ++r) s[j][r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int n2 = 0; n2 < kRes; ++n2) {
        if (n2 >= hb) break;
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          const float2 w = k2_0 + j < m ? __ldg(wf + n2 * m + k2_0 + j)
                                        : make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < kPts; ++r) cfma(s[j][r], w, z[n2][r]);
        }
      }
      for (int n2 = kRes; n2 < hb; ++n2) {
        float2 x[kPts];
#pragma unroll
        for (int r = 0; r < kPts; ++r) {
          const size_t at = base + ((size_t)kLane * n2 + r) * W;
          x[r] = make_float2(__ldg(x0 + at), __ldg(x1 + at));
        }
#pragma unroll
        for (int j = 0; j < kG; ++j) {
          const float2 w = k2_0 + j < m ? __ldg(wf + n2 * m + k2_0 + j)
                                        : make_float2(0.f, 0.f);
#pragma unroll
          for (int r = 0; r < kPts; ++r) cfma(s[j][r], w, x[r]);
        }
      }
#pragma unroll
      for (int j = 0; j < kG; ++j) {
        const int k2 = k2_0 + j;
        if (k2 < m) {
          // the twiddle tw[k2][n1]
          const float4* t4 =
              reinterpret_cast<const float4*>(tw + k2 * kLane + n1s);
#pragma unroll
          for (int r = 0; r < kPts; r += 2) {
            const float4 w = __ldg(t4 + r / 2);
            s[j][r] = cmul(make_float2(w.x, w.y), s[j][r]);
            s[j][r + 1] = cmul(make_float2(w.z, w.w), s[j][r + 1]);
          }
        }
        put_rows<kProd>(buf, L::kOpPlane, j * kCols + cs, n1s, s[j]);
      }
      wg::fence_proxy_async();
      wg::mbar_arrive(full + b);
    }
    return;
  }

  // warpgroup 0: F into shared memory, then each unit's products, both
  // tiles of 64 outputs k1, and U's stores
  wg::setmaxnreg_dec<kMmaRegs>();
  if (tid == 0) {
    wg::mbar_arrive_expect_tx(fbar, L::kF);
    for (int c = 0; c < kChunks; ++c)
      wg::bulk_load(f + c * L::kFChunk, tables + c * 2 * kPlane, L::kFChunk,
                    fbar);
  }
  wg::mbar_wait(fbar, 0);
  const int g = lane >> 2, q = lane & 3;
  for (int i = 0; i < units; ++i) {
    const int b = i % kFwdBufs;
    wg::mbar_wait(full + b, (i / kFwdBufs) & 1);
    const unsigned char* buf = op + b * L::kBuf;
    float re[2][kN1 / 2], im[2][kN1 / 2];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < kN1 / 2; ++r) {
        re[t][r] = 0.f;
        im[t][r] = 0.f;
      }
    wg::wgmma_fence();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll 1
      for (int c = 0; c < kChunks; ++c)
        fwd_chunk<kProd>(re[t], im[t], f + c * L::kFChunk, buf,
                         buf + L::kOpPlane, t, c);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int r = 0; r < kN1 / 2; ++r) {
        wg::fence_operand(re[t][r]);
        wg::fence_operand(im[t][r]);
      }
    release(empty, b);  // the buffer is free for stage A
    // U[128 k2 + k1][c0 + c]: accumulator 4 j + 2 h + e of tile t is k1 =
    // 64 t + 16 warp + g + 8 h, operand row 8 j + 2 q + e, so k2 = k2_0 +
    // 8 j / kCols, c = 8 j % kCols + 2 q + e
    int it, group;
    walk.at(i, it, group);
    const int k2_0 = group * kG;
    float2* out = u + ((size_t)(it / tiles) * n + 16 * warp + g) * W +
                  (it % tiles) * kCols + 2 * q;
#pragma unroll
    for (int j = 0; j < kN1 / 8; ++j) {
      const int k2 = k2_0 + 8 * j / kCols;
      if (k2 >= m) break;
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 4 * j + 2 * h;
          *reinterpret_cast<float4*>(
              out + ((size_t)kLane * k2 + 64 * t + 8 * h) * W +
              8 * j % kCols) =
              make_float4(re[t][r], im[t][r], re[t][r + 1], im[t][r + 1]);
        }
    }
  }
}

// ---------------------------------------------------------------------
// pass 2

// the float32 pass 2's walk over a table's stages: one stage at a time
// (scripts/torch_k3_variants.py --source f32, rows_walk_full)
constexpr int kRowsUnroll = 1;

// One k2's product of pass 2 in mode kProd: the kN operand rows at op
// (the mode's planes L::kOperandPlane bytes apart) times the next table.
template <int kN, class L, int kProd>
__device__ __forceinline__ void rows_product(float* re, float* im,
                                             const unsigned char* ring,
                                             const unsigned char* op,
                                             int wgi, uint64_t* full,
                                             uint64_t* empty,
                                             Ring& ring_pos) {
  if constexpr (kProd == kF32)
    product6<L, kN, kRowsUnroll>(re, im, ring, op, L::kOperandPlane, wgi,
                                 full, empty, ring_pos);
  else
    product<kN, L, kProd>(re, im, ring, op, op + L::kOperandPlane, wgi,
                          full, empty, ring_pos);
}

// Pass 2 in mode kProd (1, 3 or kF32), the body of its kernels
template <int kProd>
__device__ __forceinline__ void rows_body(
    unsigned char* smem, const float2* __restrict__ u,
    const float* __restrict__ a_re, const float* __restrict__ a_im,
    const float* __restrict__ b_re, const float* __restrict__ b_im, int P,
    int W, int m, float asign, const unsigned char* __restrict__ tables,
    const float2* __restrict__ wf, const float2* __restrict__ wi,
    float2* __restrict__ v1, float2* __restrict__ v2) {
  using L = RowsLayout<kProd>;
  unsigned char* ring = smem;
  // X in row group 0, [Y1; Y2] in groups 1 and 2 of each plane
  unsigned char* x_op = smem + L::kOperandOffset;
  unsigned char* y_op = x_op + kGroupBytes;
  float4* kept = reinterpret_cast<float4*>(smem + L::kExtraOffset);
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
      produce<L>(ring, tables, strips, m, 0, 2, false, full, empty);
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
            put_op<kProd, L>(x_op, g, 4 * (warp + 8 * it) + q, s[it]);
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
        rows_product<8, L, kProd>(zr, zi, ring, x_op, wgi, full, empty,
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
            put_op<kProd, L>(y_op, 2 * q + e, b0 + 8 * h, y1);
            put_op<kProd, L>(y_op, 8 + 2 * q + e, b0 + 8 * h, y2);
          }
        wg::fence_proxy_async();
        wg::bar_sync(1, kConsumers);
        kept_product(j, pr, pi, kept, [&](float* re, float* im) {
          rows_product<16, L, kProd>(re, im, ring, y_op, wgi, full, empty,
                                     ring_pos);
        });
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

// the bf16 modes' pass 2 (kProd 3 or 1)
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
  extern __shared__ __align__(1024) unsigned char smem[];
  rows_body<kProd>(smem, u, a_re, a_im, b_re, b_im, P, W, m, asign, tables,
                   wf, wi, v1, v2);
}

// "f32"'s pass 2: the same body, six products a step (below)
__global__ void __launch_bounds__(kThreads, 1)
pfft_rows_f32_kernel(const float2* __restrict__ u,
                     const float* __restrict__ a_re,
                     const float* __restrict__ a_im,
                     const float* __restrict__ b_re,
                     const float* __restrict__ b_im, int P, int W, int m,
                     float asign, const unsigned char* __restrict__ tables,
                     const float2* __restrict__ wf,
                     const float2* __restrict__ wi, float2* __restrict__ v1,
                     float2* __restrict__ v2) {
  extern __shared__ __align__(1024) unsigned char smem[];
  rows_body<kF32>(smem, u, a_re, a_im, b_re, b_im, P, W, m, asign, tables,
                  wf, wi, v1, v2);
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
  float4* kept = reinterpret_cast<float4*>(smem + L::kExtraOffset);
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
      produce<L>(ring, tables, strips, m, 1, 2, false, full, empty);
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
        kept_product(j, pr, pi, kept, [&](float* re, float* im) {
          product<16, L, kProd>(re, im, ring, b_hi, b_lo, wgi, full, empty,
                                ring_pos);
        });
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
// the float32 ("highest") passes: six bf16 products a step
//
// The rounding is the TPU's Precision.HIGHEST (the JAX package's "f32"
// mode): both operands of each stage-B product split three ways, hi =
// bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), and the six
// products whose orders sum below three (lo.hi, mid.mid, hi.lo, mid.hi,
// hi.mid, hi.hi) summed in float32, 2^-24 of each operand left out. The
// operands are those of the bf16 modes: each k2's own table, mf[k2] or
// mi[k2] (ops/pallas_fft.py::wg_f32_tables: the three planes of Re M^T
// and Im M^T, per chunk of 16 inputs k1 one 24 KB stage), and the data
// operand, S_k2 (pass 1), X, A . Z and conj(B2) . Z (pass 2) or V1 +-
// conj V2 (pass 3), formed in float32 and split once as it is written.
//
// pfft_cols_fwd_f32_kernel, an item per (pair, 32 columns, k2), no sum
// over k2 (1440 items at 5 pairs of 1024^2, n = 1152: 11 a CTA at most,
// 10.9 on average):
//   stage A  S[k1][c] = sum_n2 wf[n2][k2] z[128 n2 + k1][c] (z = x0 +
//            i x1), a warp reading a row of 32 columns per load from L2,
//            kInFlight = 2 row blocks in flight;
//   product  U[128 k2 + k1][c] = (S^T mf[k2])[c][k1], N = 32 columns;
//   stores   U written once.
// pfft_rows_f32_kernel, pass 2's body above (a strip of 8 rows, a round
//   of up to 9 k2, the products N = 8 and 16), its operand rows in three
//   planes.
// pfft_cols_inv_f32_kernel, an item per (pair, 8 columns, group of up
// to kYBlocks = 8 output blocks a) (640 items: 5 a CTA at most, 4.85 on
// average; 16 columns made 320, 3 against 2.42), k2 by k2:
//   stage A  X+- = (V1 +- conj V2)[128 k2 + ., c] into operand rows c and
//            8 + c (N = 16), V copied into shared memory by cp.async a
//            k2 ahead (two staging buffers);
//   product  P = [X+; X-] mi[k2];
//   sums     y0_a += Re(wi[a][k2] P+), y1_a += Im(wi[a][k2] P-): one
//            float32 chain an output over every k2, all eight blocks in
//            the thread's registers;
//   stores   y written once an item, never read. Taller images (H > 1024:
//            more than eight blocks a) take one item per group, each
//            running the products again.
//
// The products: wgmma m64n32k16 (pass 1), m64n8k16 and m64n16k16 (pass
// 2) or m64n16k16 (pass 3) with A from registers (the table, the
// warpgroup's 64 outputs, ldmatrix from the stage) and B the operand
// rows (a descriptor), 24 instructions a k16 step (six products, four
// real ones each). The tensor cores' float32 sums truncate: hi.hi keeps
// its own accumulators, so an output's large sum takes 16 instructions
// and the five small products' 80 at 2^-8 of its size (Acc6); in one set
// pass 3 reached 5x the float32 plain version's error from float64 on
// random V (an NVIDIA H100 80GB HBM3 at 700 W). The CTA is the bf16
// modes' passes': one persistent CTA an SM, the producer thread streaming
// each item's tables through a ring of stages, two warpgroups
// multiplying and forming the operands; the operand rows are
// single-buffered (a barrier before their writes, one after).
//
// What bounds them on the H100 (chip_smoke.py::pfft_bounds, 5 pairs of
// 1024^2, n = 1152): counted as the TPU counts the work (3 real
// products per complex one) at six bf16 products, pass 1 0.0275 ms of
// operations (its bytes 0.027), pass 2 0.093 of operations (bytes
// 0.075), pass 3 0.055 of operations (bytes 0.041); in float32 on the
// CUDA cores 0.068, 0.228 and 0.135. These kernels do four real products
// per complex one and read each k2's 192 KB table from L2 once an item
// (pass 2: both tables a strip): 276 MB a call in pass 1, 2.49 GB in
// pass 2, 1.1 GB in pass 3, and x from L2 once an item in pass 1 (377
// MB). On an NVIDIA H100 80GB HBM3 (700 W limit; scripts/
// torch_k3_variants.py --source f32): pass 1 0.138 ms, 0.097 without x's
// loads, 0.114 without products; pass 3 0.211 ms, 0.114 without products
// (its tables' stream then), 0.207 without the tables' copies. PERF.md
// section 6 has their times (chip_smoke.py phase 2) beside the parent's.
//
// Budgets (a CTA): shared memory, the ring (pass 1 seven 24 KB stages,
// pass 2 five, pass 3 seven), the operand rows (pass 1 48 KB, pass 2 36
// KB, pass 3 24 KB), pass 2's kept products (64 KB), pass 3's staging
// (32 KB); registers 168 at entry (ptxas' limit at 384 threads), 232 in
// the multiplying warpgroups after setmaxnreg, no spills.

constexpr int kCols1 = 32;  // pass 1: columns a tile, the operand rows
constexpr int kCols3 = 8;   // pass 3: columns a strip (16 rows: X+, X-)
// pass 3's sums y_a of a strip, all in registers (8 floats a thread
// each); an item takes up to kYBlocks output blocks a
constexpr int kYBlocks = 8;
// passes 1 and 3: the walk over a table's stages fully unrolled (pass 3
// 0.2175 ms against 0.2294 one stage at a time; walk_by_1)
constexpr int kColsUnroll = kChunks3;

// pass 1: the 128-row blocks of x a thread's loads keep in flight
constexpr int kInFlight = 2;
// the staging buffers of pass 3's stage A (two, copied a k2 ahead by
// cp.async): the 128 rows of a k2 of 8 columns of V1 and of V2
constexpr int kStaging3 = 2 * kLane * kCols3 * 8;  // 16 KB

// The float32 passes 1 and 3: a stage a chunk's three parts; the operand
// rows, three parts of kN rows; then two staging buffers of kStaging
// bytes.
template <int kN, int kStaging>
struct Layout3 : RingLayout<kStage3, kChunks3, kStage3,
                            kParts * (kN / 8 * kGroupBytes), 2 * kStaging> {
  static constexpr int kOpPart = kN / 8 * kGroupBytes;  // a part
};
using Layout1 = Layout3<kCols1, 0>;
using Layout3i = Layout3<2 * kCols3, kStaging3>;

// pass 1 in float32: an item per (pair, 32 columns, k2)
__global__ void __launch_bounds__(kThreads, 1)
pfft_cols_fwd_f32_kernel(const float* __restrict__ x0,
                         const float* __restrict__ x1, int P, int H, int W,
                         int m, const unsigned char* __restrict__ tables,
                         const float2* __restrict__ wf,
                         float2* __restrict__ u) {
  using L = Layout1;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* op = smem + L::kOperandOffset;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + L::kDepth;

  const int n = kLane * m;
  const int tiles = W / kCols1;
  const int items = P * tiles * m;
  const int hb = H / kLane;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  init_barriers<L>(full, empty);

  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0)
      produce<L>(ring, tables, items, m, 0, 1, true, full, empty);
    return;
  }
  wg::setmaxnreg_inc<232>();
  const int wgi = warp >> 2, g = lane >> 2, q = lane & 3;
  const int b0 = 64 * wgi + 16 * (warp & 3) + g;  // this thread's k1
  const int k1s = 16 * warp;  // stage A: inputs k1s .. k1s + 15, column lane
  Ring ring_pos;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int k2 = it % m, tile = (it / m) % tiles, p = it / (m * tiles);
    const int c0 = tile * kCols1;
    // stage A: S[k1][c] = sum_n2 wf[n2][k2] z[128 n2 + k1][c], a warp a
    // row of 32 columns per load, kInFlight blocks' loads at a time
    const size_t col = (size_t)p * H * W + c0 + lane;
    float2 s[2][8];
#pragma unroll
    for (int r = 0; r < 16; ++r) s[r / 8][r % 8] = make_float2(0.f, 0.f);
    for (int n0 = 0; n0 < hb; n0 += kInFlight) {
      float xr[kInFlight][16], xi[kInFlight][16];
#pragma unroll
      for (int b = 0; b < kInFlight; ++b) {
        if (n0 + b >= hb) break;
        const size_t row = col + (size_t)(kLane * (n0 + b) + k1s) * W;
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          xr[b][r] = __ldg(x0 + row + (size_t)r * W);
          xi[b][r] = __ldg(x1 + row + (size_t)r * W);
        }
      }
#pragma unroll
      for (int b = 0; b < kInFlight; ++b) {
        if (n0 + b >= hb) break;
        const float2 w = __ldg(wf + (n0 + b) * m + k2);
#pragma unroll
        for (int r = 0; r < 16; ++r) {
          float2& a = s[r / 8][r % 8];
          a.x = fmaf(w.x, xr[b][r], fmaf(-w.y, xi[b][r], a.x));
          a.y = fmaf(w.x, xi[b][r], fmaf(w.y, xr[b][r], a.y));
        }
      }
    }
    // the operand rows are free once both warpgroups' products are done
    wg::bar_sync(1, kConsumers);
    put_row8(op, L::kOpPart, lane, k1s, s[0]);
    put_row8(op, L::kOpPart, lane, k1s + 8, s[1]);
    wg::fence_proxy_async();
    wg::bar_sync(1, kConsumers);

    // U[128 k2 + k1][c0 + c] = (S^T mf[k2])[c][k1]: accumulator 4 j + 2 h
    // + e is k1 = b0 + 8 h, column c = 8 j + 2 q + e
    float re[16], im[16];
    product6<L, kCols1, kColsUnroll>(re, im, ring, op, L::kOpPart, wgi,
                                     full, empty, ring_pos);
    float2* out = u + ((size_t)p * n + kLane * k2 + b0) * W + c0 + 2 * q;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * j + 2 * h;
        *reinterpret_cast<float4*>(out + (size_t)8 * h * W + 8 * j) =
            make_float4(re[i], im[i], re[i + 1], im[i + 1]);
      }
  }
}

// pass 3 in float32: an item per (pair, 8 columns, group of kYBlocks
// output blocks a)
__global__ void __launch_bounds__(kThreads, 1)
pfft_cols_inv_f32_kernel(const float2* __restrict__ v1,
                         const float2* __restrict__ v2, int P, int H, int W,
                         int m, const unsigned char* __restrict__ tables,
                         const float2* __restrict__ wi,
                         float* __restrict__ y0, float* __restrict__ y1) {
  using L = Layout3i;
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* ring = smem;
  unsigned char* op = smem + L::kOperandOffset;
  unsigned char* staging = smem + L::kExtraOffset;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOffset);
  uint64_t* empty = full + L::kDepth;

  const int n = kLane * m;
  const int strips = W / kCols3;
  const int hb = H / kLane;
  const int groups = (hb + kYBlocks - 1) / kYBlocks;
  const int items = P * strips * groups;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  init_barriers<L>(full, empty);

  if (warp >= kConsumerWarps) {
    wg::setmaxnreg_dec<40>();
    if (warp == kConsumerWarps && lane == 0)
      produce<L>(ring, tables, items, m, 1, 2, false, full, empty);
    return;
  }
  wg::setmaxnreg_inc<232>();
  const int wgi = warp >> 2, g = lane >> 2, q = lane & 3;
  const int b0 = 64 * wgi + 16 * (warp & 3) + g;
  // stage A: warpgroup 0 forms X+, 1 X-, each thread column cs of the
  // strip, inputs k1s .. k1s + 7 of each k2
  const int cs = tid & 7, k1s = 8 * ((tid >> 3) & 15);
  const float xsign = wgi == 0 ? 1.f : -1.f;
  // the staging copies, 16 bytes each: copy tid + 256 i (i < 4) is row
  // (copy / 4) % 128 of V1 (copies below 512) or V2, its 16 bytes copy % 4
  // (a warp eight whole rows)
  auto stage = [&](int item, int k2, int buf) {
    const int st = item / groups;
    const int p = st / strips, c0 = (st % strips) * kCols3;
#pragma unroll
    for (int i = 0; i < 2 * kLane * kCols3 / 2 / kConsumers; ++i) {
      const int c = tid + kConsumers * i, row = (c >> 2) & (kLane - 1);
      const float2* from = (c < kLane * 4 ? v1 : v2) +
                           ((size_t)p * n + kLane * k2 + row) * W + c0 +
                           2 * (c & 3);
      tc::cp_async16(staging + buf * kStaging3 + 16 * c, from);
    }
    tc::cp_async_commit();
  };
  int kv = 0;  // the CTA's k2 blocks so far: the staging buffer's parity
  if (blockIdx.x < items) stage(blockIdx.x, 0, 0);
  Ring ring_pos;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int a0 = (it % groups) * kYBlocks, st = it / groups;
    const int na = hb - a0 < kYBlocks ? hb - a0 : kYBlocks;
    const int p = st / strips, c0 = (st % strips) * kCols3;
    // y_a, a = a0 + j: accumulator 4 e + 2 h + f of the product is row b0
    // + 8 h, column 2 q + f of X+ (e = 0: y0) or X- (e = 1: y1)
    float y[kYBlocks][8];
#pragma unroll
    for (int j = 0; j < kYBlocks; ++j)
#pragma unroll
      for (int i = 0; i < 8; ++i) y[j][i] = 0.f;

    for (int k2 = 0; k2 < m; ++k2, ++kv) {
      // V of this k2 is in; both warpgroups' products on the operand rows
      // are done, and every thread with the buffer of the k2 before
      tc::cp_async_wait<0>();
      wg::bar_sync(1, kConsumers);
      if (k2 + 1 < m)
        stage(it, k2 + 1, (kv + 1) & 1);
      else if (it + gridDim.x < items)
        stage(it + gridDim.x, 0, (kv + 1) & 1);
      // X+- = V1 +- conj V2 into operand row 8 wgi + cs
      const float2* vs =
          reinterpret_cast<const float2*>(staging + (kv & 1) * kStaging3);
      float2 z[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float2 a = vs[(k1s + r) * kCols3 + cs];
        const float2 b = vs[kLane * kCols3 + (k1s + r) * kCols3 + cs];
        z[r] = make_float2(a.x + xsign * b.x, a.y - xsign * b.y);
      }
      put_row8(op, L::kOpPart, 8 * wgi + cs, k1s, z);
      wg::fence_proxy_async();
      wg::bar_sync(1, kConsumers);
      float re[8], im[8];
      product6<L, 2 * kCols3, kColsUnroll>(re, im, ring, op, L::kOpPart,
                                           wgi, full, empty, ring_pos);
      // y_a += wi[a][k2] P: y0 the real parts of the X+ columns
      // (accumulators 0-3), y1 the imaginary parts of the X- ones (4-7)
      float2 w[kYBlocks];
#pragma unroll
      for (int j = 0; j < kYBlocks; ++j)
        w[j] = __ldg(wi + (a0 + (j < na ? j : 0)) * m + k2);
#pragma unroll
      for (int j = 0; j < kYBlocks; ++j) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          y[j][i] += i < 4 ? fmaf(w[j].x, re[i], -w[j].y * im[i])
                           : fmaf(w[j].x, im[i], w[j].y * re[i]);
      }
    }

    // y written once: row b0 + 8 h of block a, columns 2 q, 2 q + 1
#pragma unroll
    for (int j = 0; j < kYBlocks; ++j) {
      if (j >= na) break;
      const size_t row0 = (size_t)p * H + kLane * (a0 + j) + b0;
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* out = e == 0 ? y0 : y1;
          const size_t at = (row0 + 8 * h) * W + c0 + 2 * q;
          *reinterpret_cast<float2*>(out + at) =
              make_float2(y[j][4 * e + 2 * h], y[j][4 * e + 2 * h + 1]);
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

// One CTA of kBlock threads an SM (at most one a strip); the first CUDA
// error of setting the shared-memory size and the launch.
template <int kBlock = kThreads, class Kernel, class... Args>
int launch(Kernel kernel, int smem, int strips, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int sms = sms_per_device();
  if (sms < 1) return static_cast<int>(cudaErrorInvalidDevice);
  const int blocks = strips < sms ? strips : sms;
  kernel<<<blocks, kBlock, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// pass 1 of mode kProd, items of kCols columns
template <int kProd, int kCols>
int cols_fwd_items(const float* x0, const float* x1, int P, int H, int W,
                   int m, const void* tables, const float2* wf,
                   const float2* tw, float2* u, cudaStream_t stream) {
  constexpr int kG = kN1 / kCols;
  return launch<kFwdThreads>(pfft_cols_fwd_wg_kernel<kProd, kCols>,
                             FwdLayout<kProd>::kSmem,
                             P * (W / kCols) * ((m + kG - 1) / kG), stream,
                             x0, x1, P, H, W, m,
                             static_cast<const unsigned char*>(tables), wf,
                             tw, u);
}

// Items of 16 columns keep up to 8 row blocks of x in registers, items of
// 8 columns up to 16: the wider where the image's rows all fit.
template <int kProd>
int cols_fwd_wg(const float* x0, const float* x1, int P, int H, int W,
                int m, const void* tables, const float2* wf,
                const float2* tw, float2* u, cudaStream_t stream) {
  if (H <= kLane * (kLane / 16))
    return cols_fwd_items<kProd, 16>(x0, x1, P, H, W, m, tables, wf, tw, u,
                                     stream);
  return cols_fwd_items<kProd, 8>(x0, x1, P, H, W, m, tables, wf, tw, u,
                                  stream);
}

// pass 2 of mode kProd by its kernel
template <int kProd, class Kernel>
int launch_rows(Kernel kernel, const float2* u, const float* a_re,
                const float* a_im, const float* b_re, const float* b_im,
                int P, int W, int m, int conj_spec, const void* tables,
                const float2* wf, const float2* wi, float2* v1, float2* v2,
                cudaStream_t stream) {
  return launch(kernel, RowsLayout<kProd>::kSmem, P * (kLane * m / kR),
                stream, u, a_re, a_im, b_re, b_im, P, W, m,
                conj_spec ? -1.f : 1.f,
                static_cast<const unsigned char*>(tables), wf, wi, v1, v2);
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

int cols_fwd_f32(const float* x0, const float* x1, int P, int H, int W,
                 int m, const void* tables, const float2* wf, float2* u,
                 cudaStream_t stream) {
  return launch(pfft_cols_fwd_f32_kernel, Layout1::kSmem,
                P * (W / kCols1) * m, stream, x0, x1, P, H, W, m,
                static_cast<const unsigned char*>(tables), wf, u);
}

int cols_inv_f32(const float2* v1, const float2* v2, int P, int H, int W,
                 int m, const void* tables, const float2* wi, float* y0,
                 float* y1, cudaStream_t stream) {
  const int groups = (H / kLane + kYBlocks - 1) / kYBlocks;
  return launch(pfft_cols_inv_f32_kernel, Layout3i::kSmem,
                P * (W / kCols3) * groups, stream, v1, v2, P, H, W, m,
                static_cast<const unsigned char*>(tables), wi, y0, y1);
}

bool valid(int m, int products) {
  return m >= 1 && (products == 1 || products == 3);
}

}  // namespace

extern "C" {

// Pass 1 on x0, x1 (P, H, W) into U (P, 128 m, W) complex; tables are
// ops/pallas_fft.py::wg_stage_tables(m) on the device (the kernel reads
// its first k2's mf, F = mf[0]), wf (m, m) complex, tw (m, 128) complex,
// tw[k2][n1] = mf[k2][n1][0]. products is 3 ("split") or 1 ("bf16").
// Returns the first CUDA error of setting the shared-memory size and the
// launch (0 = cudaSuccess); 1 (cudaErrorInvalidValue) for m < 1 or
// another number of products.
int pfft_cols_fwd_wg(const float* x0, const float* x1, int P, int H, int W,
                     int m, const void* tables, const float2* wf,
                     const float2* tw, float2* u, int products,
                     cudaStream_t stream) {
  if (!valid(m, products)) return static_cast<int>(cudaErrorInvalidValue);
  if (products == 3)
    return cols_fwd_wg<3>(x0, x1, P, H, W, m, tables, wf, tw, u, stream);
  return cols_fwd_wg<1>(x0, x1, P, H, W, m, tables, wf, tw, u, stream);
}

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
  if (products == 3)
    return launch_rows<3>(pfft_rows_wg_kernel<3>, u, a_re, a_im, b_re, b_im,
                          P, W, m, conj_spec, tables, wf, wi, v1, v2, stream);
  return launch_rows<1>(pfft_rows_wg_kernel<1>, u, a_re, a_im, b_re, b_im, P,
                        W, m, conj_spec, tables, wf, wi, v1, v2, stream);
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

// Pass 1 in float32 ("highest") on x0, x1 (P, H, W) into U (P, 128 m,
// W) complex; tables are ops/pallas_fft.py::wg_f32_tables(m) on the
// device, wf (m, m) complex. Returns the first CUDA error of setting the
// shared-memory size and the launch (0 = cudaSuccess); 1
// (cudaErrorInvalidValue) for m < 1.
int pfft_cols_fwd_f32(const float* x0, const float* x1, int P, int H,
                      int W, int m, const void* tables, const float2* wf,
                      float2* u, cudaStream_t stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  return cols_fwd_f32(x0, x1, P, H, W, m, tables, wf, u, stream);
}

// Pass 2 in float32 on U and the spectra as pfft_rows_wg; tables as
// pfft_cols_fwd_f32, wf, wi (m, m) complex; the same errors.
int pfft_rows_f32(const float2* u, const float* a_re, const float* a_im,
                  const float* b_re, const float* b_im, int P, int W, int m,
                  int conj_spec, const void* tables, const float2* wf,
                  const float2* wi, float2* v1, float2* v2,
                  cudaStream_t stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  return launch_rows<kF32>(pfft_rows_f32_kernel, u, a_re, a_im, b_re, b_im,
                           P, W, m, conj_spec, tables, wf, wi, v1, v2,
                           stream);
}

// Pass 3 in float32 on V1, V2 (P, 128 m, W) complex into y0, y1 (P, H,
// W); tables as pfft_cols_fwd_f32, wi (m, m) complex; the same errors.
int pfft_cols_inv_f32(const float2* v1, const float2* v2, int P, int H,
                      int W, int m, const void* tables, const float2* wi,
                      float* y0, float* y1, cudaStream_t stream) {
  if (m < 1) return static_cast<int>(cudaErrorInvalidValue);
  return cols_inv_f32(v1, v2, P, H, W, m, tables, wi, y0, y1, stream);
}

const char* pfft_conv_wg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
