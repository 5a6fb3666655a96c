// GMM logits of 8x8 patches held in registers, for the float32
// patch-level MAP scorer (gmm_patch.cu::gmm_score_rows_kernel).
//
// A component record is the row-padded upper triangle of the symmetric
// A_k (kSym floats), then b_k (kD floats), then c_k and three pad floats.
// Row r of the triangle holds columns (r & ~3) .. 63: zero left of the
// diagonal, A_rr on it and A_rc + A_cr right of it (doubled on the host,
// jolideco_torch/ops/gmm_fused.py::_sym_rows), so that
//     x^T A x = sum_r x_r sum_{c >= r & ~3} U_rc x_c
// takes 2,176 multiply-adds instead of 4,096, and every row starts on a
// float4 boundary. Every thread of a warp reads the same record address:
// a shared-memory broadcast, no bank conflicts; each float4 feeds
// 4 * PPT multiply-adds (PPT patches per thread).

#pragma once

#include <cuda_runtime.h>

namespace gmm {

constexpr int kD = 64;                 // features per patch (8x8)
constexpr int kSym = 2176;             // floats of the row-padded triangle
constexpr int kRec = kSym + kD + 4;    // A_sym, b, c and 3 pad floats

// Offset of row r in the row-padded upper triangle: rows come in groups
// of four of equal length 64 - 4m, m = r / 4.
__host__ __device__ constexpr int sym_row_offset(int r) {
  return 4 * (64 * (r / 4) - 2 * (r / 4) * (r / 4 - 1)) +
         (r % 4) * (64 - 4 * (r / 4));
}
static_assert(sym_row_offset(64) == kSym, "triangle size");
static_assert(kRec % 4 == 0, "records are read as float4");

// Loads row n of a contiguous (n_total, kD) array into x; a row past the
// end gives x = 0.
__device__ __forceinline__ void load_row(const float* __restrict__ src, int n,
                                         int n_total, float (&x)[kD]) {
  if (n >= n_total) {
#pragma unroll
    for (int c = 0; c < kD; ++c) x[c] = 0.f;
    return;
  }
  const float4* s4 = reinterpret_cast<const float4*>(src + (size_t)n * kD);
#pragma unroll
  for (int c = 0; c < kD; c += 4) {
    const float4 v = __ldg(s4 + c / 4);
    x[c] = v.x;
    x[c + 1] = v.y;
    x[c + 2] = v.z;
    x[c + 3] = v.w;
  }
}

// Copies component record k into shared memory (all threads of the block).
__device__ __forceinline__ void load_record(float* dst,
                                            const float* __restrict__ rec,
                                            int k) {
  const float4* src = reinterpret_cast<const float4*>(rec + (size_t)k * kRec);
  float4* d4 = reinterpret_cast<float4*>(dst);
  for (int t = threadIdx.x; t < kRec / 4; t += blockDim.x) d4[t] = __ldg(src + t);
}

// logit[p] = -1/2 x_p^T A x_p + b . x_p + c for the record at cur (shared
// memory). Four partial sums per row and patch give the FMA pipe
// independent chains.
template <int PPT>
__device__ __forceinline__ void component_logits(const float* cur,
                                                 const float (&x)[PPT][kD],
                                                 float (&logit)[PPT]) {
  float q[PPT];
#pragma unroll
  for (int p = 0; p < PPT; ++p) q[p] = 0.f;
#pragma unroll
  for (int r = 0; r < kD; ++r) {
    const int c0 = r & ~3;
    const float4* row = reinterpret_cast<const float4*>(cur + sym_row_offset(r));
    float t[PPT][4];
#pragma unroll
    for (int p = 0; p < PPT; ++p) t[p][0] = t[p][1] = t[p][2] = t[p][3] = 0.f;
#pragma unroll
    for (int c = c0; c < kD; c += 4) {
      const float4 u = row[(c - c0) / 4];
#pragma unroll
      for (int p = 0; p < PPT; ++p) {
        t[p][0] = fmaf(u.x, x[p][c], t[p][0]);
        t[p][1] = fmaf(u.y, x[p][c + 1], t[p][1]);
        t[p][2] = fmaf(u.z, x[p][c + 2], t[p][2]);
        t[p][3] = fmaf(u.w, x[p][c + 3], t[p][3]);
      }
    }
#pragma unroll
    for (int p = 0; p < PPT; ++p)
      q[p] = fmaf(x[p][r], (t[p][0] + t[p][1]) + (t[p][2] + t[p][3]), q[p]);
  }

  const float4* bv = reinterpret_cast<const float4*>(cur + kSym);
  float s[PPT][4];
#pragma unroll
  for (int p = 0; p < PPT; ++p) s[p][0] = s[p][1] = s[p][2] = s[p][3] = 0.f;
#pragma unroll
  for (int c = 0; c < kD; c += 4) {
    const float4 u = bv[c / 4];
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      s[p][0] = fmaf(u.x, x[p][c], s[p][0]);
      s[p][1] = fmaf(u.y, x[p][c + 1], s[p][1]);
      s[p][2] = fmaf(u.z, x[p][c + 2], s[p][2]);
      s[p][3] = fmaf(u.w, x[p][c + 3], s[p][3]);
    }
  }
  const float c_k = cur[kSym + kD];
#pragma unroll
  for (int p = 0; p < PPT; ++p)
    logit[p] = fmaf(-0.5f, q[p], ((s[p][0] + s[p][1]) + (s[p][2] + s[p][3])) + c_k);
}

}  // namespace gmm
