// Backward of the fused Gram matvec: the input cotangent of v -> K~(x, z) @ v,
//
//   dx(n, d) = 2 (x * sum_j W - W @ z),
//   W_ij = k'(d2_ij) * mask_ij * (rowv_i . colv_j),
//
// with rowv = g-bar (n, s) and colv = v (m, s); called with (z, x, colv, rowv)
// it gives dz. k' is dk/d(d2) at the unit-signal, already lengthscale-scaled
// inputs, and the mask, built from the raw d2 before its clamp, is the
// reference's: Matern-1/2 drops coincident pairs (k' ~ 1/r there), the other
// kinds weigh them 1/2 (autodiff's convention for max(d2, 0) at 0).
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_matvec_bwd_pallas
// (_gram_matvec_bwd_kernel), reached through the VJP of gram_matvec_fused.
//
// What bounds it on an H100: operations. Each of the n*m pairs costs 2d
// flops for the distance, 2s for rowv . colv and 2d for W z, plus a
// transcendental or two for k', against 4(2nd + md + ns + ms) bytes: at the
// protein shape (n = m = 45,730, d = 9, s = 8) that is ~1.1e11 flops for
// 0.006 GB, so the fp32 FMA rate and the SFU set the pace. No tensor cores:
// the distance identity needs IEEE fp32 (as in the forward), and the W z
// contraction is only d wide.
//
// What the design does about it: W never reaches device memory. One CTA owns
// BM rows and loops over all columns (the sequential column axis of the Pallas
// grid), with the z and colv tiles staged in shared memory and read as
// broadcasts; each thread builds d2 with the forward kernel's FMA order
// (common.cuh), so the diagonal of K(x, x) is exactly 0 and its mask exact,
// then k', the mask and rowv . colv, and accumulates sum_j W (one float) and
// W z (DC floats, d rounded up to a bucket, zero-filled past d) in registers.
// The KSPLIT partials of a row are added through shared memory at the end; no
// atomics. Ragged n and m edges are zero-filled tiles: a zero colv row makes
// its pair's weight 0.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace {

// Widest rowv/colv one launch takes; the wrapper slices wider ones.
constexpr int kMaxS = 128;

// dk/d(d2) of gram_matvec.py:_dcov_map, with the same r = sqrt(d2 + 1e-36).
template <int KIND>
__device__ __forceinline__ float dcov_map(float d2) {
  if constexpr (KIND == kSE) {
    return -0.5f * expf(-0.5f * d2);
  } else {
    const float r = sqrtf(d2 + 1e-36f);
    if constexpr (KIND == kMatern12) {
      return -expf(-r) / (2.0f * r);
    } else if constexpr (KIND == kMatern32) {
      return -1.5f * expf(-kSqrt3 * r);
    } else {
      const float t = kSqrt5 * r;
      return -(5.0f / 6.0f) * (1.0f + t) * expf(-t);
    }
  }
}

// The pair's weight from its raw d2 (gram_matvec.py:221-229).
template <int KIND>
__device__ __forceinline__ float pair_mask(float raw) {
  if constexpr (KIND == kMatern12) {
    return raw > 0.0f ? 1.0f : 0.0f;
  } else {
    return raw > 0.0f ? 1.0f : (raw == 0.0f ? 0.5f : 0.0f);
  }
}

// Instantiated widths of the W z accumulator (multiples of 4: z rows are read
// as float4).
__host__ inline int pick_dc(int d) {
  const int widths[] = {4, 8, 12, 16, 32, 64, kMaxDim};
  for (int w : widths)
    if (d <= w) return w;
  return kMaxDim;
}

// Dynamic shared memory of one CTA: the z (BN, dc), colv (BN, s), x (BM, d|1)
// and rowv (BM, s|1) tiles and both norm vectors. The reduction buffer
// (BM, (dc+1)|1) reuses the z, colv and z-norm tiles, which always hold it.
__host__ inline size_t bwd_smem_bytes(int dc, int d, int s) {
  return sizeof(float) *
         (size_t)(BN * dc + BN * s + BN + BM * (d | 1) + BM + BM * (s | 1));
}

template <int KIND, int DC>
__global__ void __launch_bounds__(NTHREADS)
gram_matvec_bwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ z,
                       const float* __restrict__ rowv,
                       const float* __restrict__ colv,
                       float* __restrict__ out, int n, int m, int d, int s) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  static_assert(DC % 4 == 0, "z rows are read as float4");
  const int dp = d | 1;  // odd strides: each lane reads its own row
  const int sp = s | 1;
  float* zs = smem;            // (BN, DC), first: 16-byte aligned rows
  float* cs = zs + BN * DC;    // (BN, s), read as broadcasts
  float* zn = cs + BN * s;     // (BN,)
  float* xs = zn + BN;         // (BM, dp)
  float* xn = xs + BM * dp;    // (BM,)
  float* rs = xn + BM;         // (BM, sp)

  const int r = threadIdx.x % BM;
  const int g = threadIdx.x / BM;
  const int row0 = blockIdx.x * BM;

  // columns d..DC of the z tile stay 0 for the whole loop: they pad the
  // unrolled W z update
  for (int i = threadIdx.x; i < BN * DC; i += NTHREADS) zs[i] = 0.0f;
  load_rows(xs, x, row0, BM, n, d, dp);
  load_rows(rs, rowv, row0, BM, n, s, sp);
  __syncthreads();
  if (threadIdx.x < BM) xn[r] = sq_norm(xs + r * dp, d);

  float acc[DC + 1];  // W z, then sum_j W
#pragma unroll
  for (int c = 0; c <= DC; ++c) acc[c] = 0.0f;

  const float* xr = xs + r * dp;
  const float* rr = rs + r * sp;
  for (int j0 = 0; j0 < m; j0 += BN) {
    __syncthreads();  // the previous tile is consumed
    load_rows(zs, z, j0, BN, m, d, DC);
    load_rows(cs, colv, j0, BN, m, s, s);
    __syncthreads();
    if (threadIdx.x < BN) zn[threadIdx.x] = sq_norm(zs + threadIdx.x * DC, d);
    __syncthreads();
    const float xr_n = xn[r];
    for (int jj = g; jj < BN; jj += KSPLIT) {
      const float* zr = zs + jj * DC;
      const float raw = raw_sqdist(xr, xr_n, zr, zn[jj], d);
      const float* cr = cs + jj * s;
      float gv = 0.0f;
      for (int c = 0; c < s; ++c) gv = fmaf(rr[c], cr[c], gv);
      const float w =
          dcov_map<KIND>(fmaxf(raw, 0.0f)) * pair_mask<KIND>(raw) * gv;
      acc[DC] += w;
#pragma unroll
      for (int k = 0; k < DC; k += 4) {
        const float4 z4 = *reinterpret_cast<const float4*>(zr + k);
        acc[k] = fmaf(w, z4.x, acc[k]);
        acc[k + 1] = fmaf(w, z4.y, acc[k + 1]);
        acc[k + 2] = fmaf(w, z4.z, acc[k + 2]);
        acc[k + 3] = fmaf(w, z4.w, acc[k + 3]);
      }
    }
  }
  __syncthreads();  // every tile read: the reduction may reuse the buffer
  reduce_rows<DC + 1>(acc, smem);
  if (threadIdx.x < BM && row0 + r < n) {
    // x from shared memory: the reduction buffer ends before the x tile
    float* o = out + (size_t)(row0 + r) * d;
#pragma unroll
    for (int k = 0; k < DC; ++k)
      if (k < d) o[k] = 2.0f * (xr[k] * acc[DC] - acc[k]);
  }
}

template <int KIND, int DC>
cudaError_t launch(const float* x, const float* z, const float* rowv,
                   const float* colv, float* out, int n, int m, int d, int s,
                   cudaStream_t stream) {
  const size_t bytes = bwd_smem_bytes(DC, d, s);
  auto kernel = gram_matvec_bwd_kernel<KIND, DC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BM - 1) / BM);
  kernel<<<grid, NTHREADS, bytes, stream>>>(x, z, rowv, colv, out, n, m, d, s);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch_dim(const float* x, const float* z, const float* rowv,
                         const float* colv, float* out, int n, int m, int d,
                         int s, cudaStream_t st) {
  switch (pick_dc(d)) {
    case 4: return launch<KIND, 4>(x, z, rowv, colv, out, n, m, d, s, st);
    case 8: return launch<KIND, 8>(x, z, rowv, colv, out, n, m, d, s, st);
    case 12: return launch<KIND, 12>(x, z, rowv, colv, out, n, m, d, s, st);
    case 16: return launch<KIND, 16>(x, z, rowv, colv, out, n, m, d, s, st);
    case 32: return launch<KIND, 32>(x, z, rowv, colv, out, n, m, d, s, st);
    case 64: return launch<KIND, 64>(x, z, rowv, colv, out, n, m, d, s, st);
    default:
      return launch<KIND, kMaxDim>(x, z, rowv, colv, out, n, m, d, s, st);
  }
}

}  // namespace
}  // namespace repro_torch

// x (n, d), z (m, d), rowv (n, s), colv (m, s) -> out (n, d); all float32,
// row-major, contiguous, on the current device. kind: 0 se, 1 matern12,
// 2 matern32, 3 matern52. Requires n, m >= 1, 1 <= s <= 128 and
// 1 <= d <= 128. Returns the CUDA error of the launch (0 on success).
extern "C" int repro_gram_matvec_bwd_f32(const float* x, const float* z,
                                         const float* rowv, const float* colv,
                                         float* out, int n, int m, int d, int s,
                                         int kind, void* stream) {
  using namespace repro_torch;
  if (n < 1 || m < 1 || s < 1 || s > kMaxS || d < 1 || d > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kSE:
      return (int)dispatch_dim<kSE>(x, z, rowv, colv, out, n, m, d, s, st);
    case kMatern12:
      return (int)dispatch_dim<kMatern12>(x, z, rowv, colv, out, n, m, d, s, st);
    case kMatern32:
      return (int)dispatch_dim<kMatern32>(x, z, rowv, colv, out, n, m, d, s, st);
    case kMatern52:
      return (int)dispatch_dim<kMatern52>(x, z, rowv, colv, out, n, m, d, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory per CTA of a launch with these d and s, in bytes.
extern "C" int repro_gram_matvec_bwd_smem_bytes(int d, int s) {
  return (int)repro_torch::bwd_smem_bytes(repro_torch::pick_dc(d), d, s);
}
