// Shared constants and helpers of the fused kernels: the stationary kinds,
// the canonical FMA order of squared distances (gram_matvec.cu and
// gram_matvec_bwd.cu), and the KSPLIT tiling of rff_bwd.cu.
//
// The KSPLIT tiling: one CTA of NTHREADS = BM * KSPLIT threads owns BM output
// rows. Thread t works on row t % BM and on every KSPLIT-th column of each
// column tile, starting at t / BM; since BM is a multiple of 32, all lanes of
// a warp share the same column, so the column-side operands are
// shared-memory broadcasts. The KSPLIT partials of a row are added in shared
// memory at the end (reduce_rows).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int BM = 64;                 // output rows per CTA
constexpr int BN = 64;                 // columns of M per tile
constexpr int KSPLIT = 4;              // threads per output row
constexpr int NTHREADS = BM * KSPLIT;  // 256
constexpr int kMaxDim = 128;           // largest feature dimension d

static_assert(BM % 32 == 0, "a warp must share its column index");
static_assert(BN % KSPLIT == 0, "KSPLIT must divide the column tile");

// Stationary kernel kinds, in the order of the wrappers' CUDA_KINDS.
enum Kind : int { kSE = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

// ||a||^2 of a d-vector: fmaf over k from 0. The Gram kernel and its
// backward build every norm and inner product x.z in this one FMA order and
// the raw squared distance as fmaf(-2, x.z, ||x||^2 + ||z||^2), so for a
// point paired with itself the norms and the dot agree bit for bit and the
// raw distance is exactly 0.
__device__ __forceinline__ float sq_norm(const float* __restrict__ a, int d) {
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) acc = fmaf(a[k], a[k], acc);
  return acc;
}

// Row stride of the reduction buffer: odd, so the lanes of a warp (one row
// each) hit distinct banks.
template <int SC>
__host__ __device__ constexpr int reduce_stride() { return SC | 1; }

// Load rows [r0, r0 + rows) of a (total, d) row-major matrix into a tile
// with row stride `stride`, zero-filling rows past the edge.
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int r0, int rows, int total, int d,
                                          int stride) {
  for (int i = threadIdx.x; i < rows * d; i += NTHREADS) {
    const int rr = i / d;
    const int k = i - rr * d;
    const int gr = r0 + rr;
    dst[rr * stride + k] = gr < total ? src[(size_t)gr * d + k] : 0.0f;
  }
}

// Add the KSPLIT partial sums of each row through shared memory. On return the
// threads of group 0 (threadIdx.x < BM) hold their row's totals in acc. `red`
// may alias the tiles: the caller has synchronised after its last read of
// them.
template <int SC>
__device__ __forceinline__ void reduce_rows(float (&acc)[SC],
                                            float* __restrict__ red) {
  constexpr int RS = reduce_stride<SC>();
  const int r = threadIdx.x % BM;
  const int g = threadIdx.x / BM;
  for (int gg = 1; gg < KSPLIT; ++gg) {
    if (g == gg) {
#pragma unroll
      for (int c = 0; c < SC; ++c)
        red[r * RS + c] = (gg == 1 ? 0.0f : red[r * RS + c]) + acc[c];
    }
    __syncthreads();
  }
  if (g == 0) {
#pragma unroll
    for (int c = 0; c < SC; ++c) acc[c] += red[r * RS + c];
  }
}

}  // namespace repro_torch
