// Shared tiling, distances and dispatch for the fused kernels
// (gram_matvec_bwd.cu and the RFF kernels; gram_matvec.cu, which has its own
// tile, keeps the FMA order of sq_norm and raw_sqdist).
//
// These kernels compute out(n, s) = M(x, y) @ w with M built tile by tile from
// the rows of x and y and never written to device memory. One CTA of
// NTHREADS = BM * KSPLIT threads owns BM output rows. Thread t works on row
// t % BM and on every KSPLIT-th column of each column tile, starting at
// t / BM. KSPLIT is the number of threads that share one output row; since BM
// is a multiple of 32, all lanes of a warp share the same column, so the
// column-side operands are shared-memory broadcasts. Each thread keeps SC
// partial sums in registers across the whole column loop; the KSPLIT partials
// of a row are added in shared memory at the end.
//
// SC (the columns of w held per CTA) is a template parameter, so the
// accumulators are registers; pick_sc rounds the runtime s up to the next
// instantiated width, and s > kMaxSC runs as several CTAs along grid.y.
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int BM = 64;                 // output rows per CTA
constexpr int BN = 64;                 // columns of M per tile
constexpr int KSPLIT = 4;              // threads per output row
constexpr int NTHREADS = BM * KSPLIT;  // 256
constexpr int kMaxDim = 128;           // largest feature dimension d
constexpr int kMaxSC = 128;            // widest accumulator

static_assert(BM % 32 == 0, "a warp must share its column index");
static_assert(BN % KSPLIT == 0, "KSPLIT must divide the column tile");

// Stationary kernel kinds, in the order of the wrappers' CUDA_KINDS.
enum Kind : int { kSE = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

// ||a||^2 of a d-vector. The Gram kernels and their backward build every
// norm and inner product with this one FMA order, so for a point paired with
// itself ||x||^2 == ||z||^2 == x.z bit for bit and raw_sqdist is exactly 0.
__device__ __forceinline__ float sq_norm(const float* __restrict__ a, int d) {
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) acc = fmaf(a[k], a[k], acc);
  return acc;
}

__device__ __forceinline__ float dot(const float* __restrict__ a,
                                     const float* __restrict__ b, int d) {
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) acc = fmaf(a[k], b[k], acc);
  return acc;
}

// ||x||^2 + ||z||^2 - 2 x.z before any clamp: slightly negative where the
// identity cancels, exactly 0 for coincident points (see sq_norm). The FMA is
// written out so that no kernel's contraction choice can differ.
__device__ __forceinline__ float raw_sqdist(const float* __restrict__ xr,
                                            float xn,
                                            const float* __restrict__ zr,
                                            float zn, int d) {
  return fmaf(-2.0f, dot(xr, zr, d), xn + zn);
}

// Instantiated accumulator widths. A width above s costs masked FMAs on
// zero-filled w columns, so the list is dense where the main path lands:
// s = 1 (posterior mean), 17 (16 samples + mean), 64 and 65 (predict).
__host__ inline int pick_sc(int s) {
  const int widths[] = {1, 2, 4, 8, 16, 24, 32, 48, 64, 72, 96, kMaxSC};
  for (int w : widths)
    if (s <= w) return w;
  return kMaxSC;
}

// Row stride of a w tile in shared memory: a multiple of 4 so each row can
// be read as float4.
template <int SC>
__host__ __device__ constexpr int padded_width() { return (SC + 3) & ~3; }

// Row stride of the reduction buffer: odd, so the lanes of a warp (one row
// each) hit distinct banks.
template <int SC>
__host__ __device__ constexpr int reduce_stride() { return SC | 1; }

// acc[c] += a * row[c] for the SC columns of one w row in shared memory.
template <int SC>
__device__ __forceinline__ void axpy_row(float (&acc)[SC], float a,
                                         const float* __restrict__ row) {
  if constexpr (SC % 4 == 0) {
#pragma unroll
    for (int c = 0; c < SC; c += 4) {
      const float4 w4 = *reinterpret_cast<const float4*>(row + c);
      acc[c] = fmaf(a, w4.x, acc[c]);
      acc[c + 1] = fmaf(a, w4.y, acc[c + 1]);
      acc[c + 2] = fmaf(a, w4.z, acc[c + 2]);
      acc[c + 3] = fmaf(a, w4.w, acc[c + 3]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < SC; ++c) acc[c] = fmaf(a, row[c], acc[c]);
  }
}

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

// Load the w tile rows [j0, j0 + BN) and columns [c0, c0 + live) of a
// (total, s) row-major matrix, zero-filling past either edge.
template <int SC>
__device__ __forceinline__ void load_w_tile(float* __restrict__ dst,
                                            const float* __restrict__ w,
                                            int j0, int total, int s, int c0,
                                            int live) {
  constexpr int SCP = padded_width<SC>();
  for (int i = threadIdx.x; i < BN * SCP; i += NTHREADS) {
    const int jj = i / SCP;
    const int c = i - jj * SCP;
    const int gj = j0 + jj;
    dst[i] = (gj < total && c < live) ? w[(size_t)gj * s + c0 + c] : 0.0f;
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

// reduce_rows, then out[row0 + r, c0 : c0 + live] = scale * total.
template <int SC>
__device__ __forceinline__ void reduce_and_store(float (&acc)[SC],
                                                 float* __restrict__ red,
                                                 float* __restrict__ out,
                                                 int row0, int n, int s,
                                                 int c0, int live,
                                                 float scale) {
  reduce_rows<SC>(acc, red);
  const int r = threadIdx.x % BM;
  if (threadIdx.x < BM && row0 + r < n) {
    float* o = out + (size_t)(row0 + r) * s + c0;
#pragma unroll
    for (int c = 0; c < SC; ++c)
      if (c < live) o[c] = scale * acc[c];
  }
}

}  // namespace repro_torch
