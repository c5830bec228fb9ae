// Fused Gram matvec: out(n, s) = K~(x, z) @ v(m, s), K~ the unit-signal
// stationary covariance of already lengthscale-scaled inputs, no jitter.
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_matvec_pallas
// (_gram_matvec_kernel), reached through gram_matvec_fused.
//
// What bounds it on an H100: operations. Each of the n*m kernel entries costs
// 2d flops for the distance and 2s for the contraction, against 4(n+m)(d+s)
// bytes of input and output, so at d = 9 and s = 65 it needs ~3e11 flops for
// 0.03 GB: the fp32 FMA rate (67 TFLOP/s outside the tensor cores), and the
// exp/sqrt of the covariance map on the SFU, set the pace. Tensor cores are
// deliberately not used: TF32 would break the cancellation in
// |x|^2 + |z|^2 - 2 x.z, and the reference's "fp32" is IEEE fp32.
//
// What the design does about it: K never reaches device memory. Each entry is
// built in registers and contracted at once into SC per-thread accumulators
// (see common.cuh for the thread layout), so the only traffic per column tile
// is the (BN, d) z tile and the (BN, SC) v tile in shared memory, read as
// broadcasts, with the v rows read as float4. The sequential column axis of
// the Pallas grid becomes the loop inside the CTA; ragged n, m and s edges
// are masked by zero-filled tiles instead of padded copies of x and v.
//
// The same kernel also computes a matvec's column chunks into partial sums
// (repro_gram_matvec_chunked_f32): grid.y then cuts the column loop into
// chunks, so that few output rows still fill the card. gram_rows_pair.cu
// sums the partials; this is the row panel K~(xi, x) @ u of the stochastic
// solvers, where xi holds only a few hundred rows.
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro_torch {
namespace {

// The covariance map of gram_matvec.py:_cov_map, with r = sqrt(d2 + 1e-36)
// exactly as there, so Matern stays finite at coincident points.
template <int KIND>
__device__ __forceinline__ float cov_map(float d2) {
  if constexpr (KIND == kSE) {
    return expf(-0.5f * d2);
  } else {
    const float r = sqrtf(d2 + 1e-36f);
    if constexpr (KIND == kMatern12) {
      return expf(-r);
    } else if constexpr (KIND == kMatern32) {
      const float t = kSqrt3 * r;
      return (1.0f + t) * expf(-t);
    } else {
      const float t = kSqrt5 * r;
      return (1.0f + t + t * t / 3.0f) * expf(-t);
    }
  }
}

// Dynamic shared memory of one CTA: the v, x and z tiles with their norms
// during the column loop, then the reduction buffer, which reuses them.
__host__ inline size_t gram_smem_bytes(int sc, int d) {
  const int tiles = BN * ((sc + 3) & ~3) + BM * (d | 1) + BM + BN * d + BN;
  const int reduce = BM * (sc | 1);
  return sizeof(float) * (size_t)(tiles > reduce ? tiles : reduce);
}

// One CTA: BM output rows, column slice blockIdx.z of SC columns, and the
// column chunk blockIdx.y of `chunk` columns (a multiple of BN), whose partial
// sums go to out + blockIdx.y * n * s. One chunk of m columns is the matvec.
template <int KIND, int SC>
__global__ void __launch_bounds__(NTHREADS)
gram_matvec_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ v, float* __restrict__ out,
                   int n, int m, int d, int s, int chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int SCP = padded_width<SC>();
  const int dp = d | 1;  // odd stride: each lane reads its own x row
  float* vs = smem;                // (BN, SCP), first: 16-byte aligned
  float* xs = vs + BN * SCP;       // (BM, dp)
  float* xn = xs + BM * dp;        // (BM,)
  float* zs = xn + BM;             // (BN, d), read as broadcasts
  float* zn = zs + BN * d;         // (BN,)

  const int r = threadIdx.x % BM;
  const int g = threadIdx.x / BM;
  const int row0 = blockIdx.x * BM;
  const int c0 = blockIdx.z * SC;
  const int live = min(SC, s - c0);
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(m, j_begin + chunk);

  load_rows(xs, x, row0, BM, n, d, dp);
  __syncthreads();
  if (threadIdx.x < BM) xn[r] = sq_norm(xs + r * dp, d);

  float acc[SC];
#pragma unroll
  for (int c = 0; c < SC; ++c) acc[c] = 0.0f;

  const float* xr = xs + r * dp;
  for (int j0 = j_begin; j0 < j_end; j0 += BN) {
    __syncthreads();  // the previous tile is consumed
    load_rows(zs, z, j0, BN, j_end, d, d);
    load_w_tile<SC>(vs, v, j0, j_end, s, c0, live);
    __syncthreads();
    if (threadIdx.x < BN) zn[threadIdx.x] = sq_norm(zs + threadIdx.x * d, d);
    __syncthreads();
    const float xr_n = xn[r];
    for (int jj = g; jj < BN; jj += KSPLIT) {
      // columns past m are zero rows of z and v: a finite entry times 0
      const float d2 = fmaxf(raw_sqdist(xr, xr_n, zs + jj * d, zn[jj], d), 0.0f);
      axpy_row<SC>(acc, cov_map<KIND>(d2), vs + jj * SCP);
    }
  }
  __syncthreads();  // every tile read: the reduction may reuse the buffer
  reduce_and_store<SC>(acc, smem, out + (size_t)blockIdx.y * n * s, row0, n,
                       s, c0, live, 1.0f);
}

template <int KIND, int SC>
cudaError_t launch(const float* x, const float* z, const float* v, float* out,
                   int n, int m, int d, int s, int chunk,
                   cudaStream_t stream) {
  const size_t bytes = gram_smem_bytes(SC, d);
  auto kernel = gram_matvec_kernel<KIND, SC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BM - 1) / BM, (m + chunk - 1) / chunk, (s + SC - 1) / SC);
  kernel<<<grid, NTHREADS, bytes, stream>>>(x, z, v, out, n, m, d, s, chunk);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch_width(const float* x, const float* z, const float* v,
                           float* out, int n, int m, int d, int s, int chunk,
                           cudaStream_t st) {
  switch (pick_sc(s)) {
    case 1: return launch<KIND, 1>(x, z, v, out, n, m, d, s, chunk, st);
    case 2: return launch<KIND, 2>(x, z, v, out, n, m, d, s, chunk, st);
    case 4: return launch<KIND, 4>(x, z, v, out, n, m, d, s, chunk, st);
    case 8: return launch<KIND, 8>(x, z, v, out, n, m, d, s, chunk, st);
    case 16: return launch<KIND, 16>(x, z, v, out, n, m, d, s, chunk, st);
    case 24: return launch<KIND, 24>(x, z, v, out, n, m, d, s, chunk, st);
    case 32: return launch<KIND, 32>(x, z, v, out, n, m, d, s, chunk, st);
    case 48: return launch<KIND, 48>(x, z, v, out, n, m, d, s, chunk, st);
    case 64: return launch<KIND, 64>(x, z, v, out, n, m, d, s, chunk, st);
    case 72: return launch<KIND, 72>(x, z, v, out, n, m, d, s, chunk, st);
    case 96: return launch<KIND, 96>(x, z, v, out, n, m, d, s, chunk, st);
    default: return launch<KIND, kMaxSC>(x, z, v, out, n, m, d, s, chunk, st);
  }
}

cudaError_t dispatch_kind(const float* x, const float* z, const float* v,
                          float* out, int n, int m, int d, int s, int kind,
                          int chunk, cudaStream_t st) {
  switch (kind) {
    case kSE: return dispatch_width<kSE>(x, z, v, out, n, m, d, s, chunk, st);
    case kMatern12:
      return dispatch_width<kMatern12>(x, z, v, out, n, m, d, s, chunk, st);
    case kMatern32:
      return dispatch_width<kMatern32>(x, z, v, out, n, m, d, s, chunk, st);
    case kMatern52:
      return dispatch_width<kMatern52>(x, z, v, out, n, m, d, s, chunk, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro_torch

// x (n, d), z (m, d), v (m, s) -> out (n, s); all float32, row-major,
// contiguous, on the current device. kind: 0 se, 1 matern12, 2 matern32,
// 3 matern52. Requires n, m, s >= 1 and 1 <= d <= 128. Returns the CUDA error
// of the launch (0 on success).
extern "C" int repro_gram_matvec_f32(const float* x, const float* z,
                                     const float* v, float* out, int n, int m,
                                     int d, int s, int kind, void* stream) {
  using namespace repro_torch;
  if (n < 1 || m < 1 || s < 1 || d < 1 || d > kMaxDim)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_kind(x, z, v, out, n, m, d, s, kind, m,
                            static_cast<cudaStream_t>(stream));
}

// The same matvec in column chunks of `chunk` columns (a multiple of 64):
// partial (ceil(m / chunk), n, s) receives each chunk's K~(x, z_chunk) @
// v_chunk, to be summed by the caller. Same requirements and return value.
extern "C" int repro_gram_matvec_chunked_f32(const float* x, const float* z,
                                             const float* v, float* partial,
                                             int n, int m, int d, int s,
                                             int kind, int chunk,
                                             void* stream) {
  using namespace repro_torch;
  if (n < 1 || m < 1 || s < 1 || d < 1 || d > kMaxDim || chunk < BN ||
      chunk % BN != 0 || (m + chunk - 1) / chunk > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)dispatch_kind(x, z, v, partial, n, m, d, s, kind, chunk,
                            static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per CTA of a launch with these d and s, in bytes.
extern "C" int repro_gram_matvec_smem_bytes(int d, int s) {
  return (int)repro_torch::gram_smem_bytes(repro_torch::pick_sc(s), d);
}

// The text of a CUDA error code returned by an entry point above.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
