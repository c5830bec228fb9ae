// Fused random-Fourier-feature matvec:
//   out(n, s) = sqrt(1/m) [sin(x omega^T) | cos(x omega^T)] @ w(2m, s),
// w holding the m sin rows first and the m cos rows second.
//
// Replaces: src/repro/kernels/rff_matvec.py, rff_matvec_pallas (_rff_kernel),
// reached through rff_matvec_fused.
//
// What bounds it on an H100: operations. Per (row, frequency) pair it costs
// 2d flops for the projection, one sincos and 4s flops for the two
// contractions, against 4(n d + m d + 2 m s + n s) bytes: at n = 45,730,
// m = 1,024, d = 9, s = 64 that is ~1.3e10 flops for 0.02 GB, so the fp32
// FMA rate and the SFU-backed sin/cos set the pace. No tensor cores: the
// reference's "fp32" is IEEE fp32, and sin/cos of a TF32 projection would
// lose about three digits of phase.
//
// What the design does about it: the (n, 2m) feature matrix never reaches
// device memory. Each thread builds its projection in registers, takes
// sincosf once, and contracts both halves into one set of SC accumulators
// (common.cuh), with the omega tile and both w tiles staged in shared memory
// and read as broadcasts. The feature axis of the Pallas grid becomes the loop
// inside the CTA. The feature edge is masked in the kernel: the w rows past m
// are zero-filled, so a zero-padded frequency (whose cos is 1) adds nothing,
// and the sqrt(1/m) scale uses the true m. The signal variance is applied by
// the caller, outside the kernel, as in the reference.
#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

// Dynamic shared memory of one CTA: both w tiles, the x and omega tiles
// during the feature loop, then the reduction buffer, which reuses them.
__host__ inline size_t rff_smem_bytes(int sc, int d) {
  const int tiles = 2 * BN * ((sc + 3) & ~3) + BM * (d | 1) + BN * d;
  const int reduce = BM * (sc | 1);
  return sizeof(float) * (size_t)(tiles > reduce ? tiles : reduce);
}

template <int SC>
__global__ void __launch_bounds__(NTHREADS)
rff_matvec_kernel(const float* __restrict__ x, const float* __restrict__ omega,
                  const float* __restrict__ w, float* __restrict__ out, int n,
                  int m, int d, int s, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int SCP = padded_width<SC>();
  const int dp = d | 1;  // odd stride: each lane reads its own x row
  float* ws = smem;                // (BN, SCP) sin rows of w, first: aligned
  float* wc = ws + BN * SCP;       // (BN, SCP) cos rows of w
  float* xs = wc + BN * SCP;       // (BM, dp)
  float* os = xs + BM * dp;        // (BN, d) frequencies, read as broadcasts

  const int r = threadIdx.x % BM;
  const int g = threadIdx.x / BM;
  const int row0 = blockIdx.x * BM;
  const int c0 = blockIdx.y * SC;
  const int live = min(SC, s - c0);

  load_rows(xs, x, row0, BM, n, d, dp);

  float acc[SC];
#pragma unroll
  for (int c = 0; c < SC; ++c) acc[c] = 0.0f;

  const float* xr = xs + r * dp;
  for (int f0 = 0; f0 < m; f0 += BN) {
    __syncthreads();  // the previous tile is consumed
    load_rows(os, omega, f0, BN, m, d, d);
    // sin rows are w[f], cos rows w[m + f]; both zero past the m edge
    load_w_tile<SC>(ws, w, f0, m, s, c0, live);
    load_w_tile<SC>(wc, w + (size_t)m * s, f0, m, s, c0, live);
    __syncthreads();
    for (int ff = g; ff < BN; ff += KSPLIT) {
      const float* om = os + ff * d;
      float proj = 0.0f;
      for (int k = 0; k < d; ++k) proj = fmaf(xr[k], om[k], proj);
      float sn, cs;
      sincosf(proj, &sn, &cs);
      axpy_row<SC>(acc, sn, ws + ff * SCP);
      axpy_row<SC>(acc, cs, wc + ff * SCP);
    }
  }
  __syncthreads();  // every tile read: the reduction may reuse the buffer
  reduce_and_store<SC>(acc, smem, out, row0, n, s, c0, live, scale);
}

template <int SC>
cudaError_t launch(const float* x, const float* omega, const float* w,
                   float* out, int n, int m, int d, int s, float scale,
                   cudaStream_t stream) {
  const size_t bytes = rff_smem_bytes(SC, d);
  auto kernel = rff_matvec_kernel<SC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + BM - 1) / BM, (s + SC - 1) / SC);
  kernel<<<grid, NTHREADS, bytes, stream>>>(x, omega, w, out, n, m, d, s,
                                            scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// x (n, d), omega (m, d), w (2m, s) -> out (n, s); all float32, row-major,
// contiguous, on the current device. Requires n, m, s >= 1 and
// 1 <= d <= 128. Returns the CUDA error of the launch (0 on success).
extern "C" int repro_rff_matvec_f32(const float* x, const float* omega,
                                    const float* w, float* out, int n, int m,
                                    int d, int s, void* stream) {
  using namespace repro_torch;
  if (n < 1 || m < 1 || s < 1 || d < 1 || d > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale = sqrtf(1.0f / (float)m);
  switch (pick_sc(s)) {
    case 1: return (int)launch<1>(x, omega, w, out, n, m, d, s, scale, st);
    case 2: return (int)launch<2>(x, omega, w, out, n, m, d, s, scale, st);
    case 4: return (int)launch<4>(x, omega, w, out, n, m, d, s, scale, st);
    case 8: return (int)launch<8>(x, omega, w, out, n, m, d, s, scale, st);
    case 16: return (int)launch<16>(x, omega, w, out, n, m, d, s, scale, st);
    case 24: return (int)launch<24>(x, omega, w, out, n, m, d, s, scale, st);
    case 32: return (int)launch<32>(x, omega, w, out, n, m, d, s, scale, st);
    case 48: return (int)launch<48>(x, omega, w, out, n, m, d, s, scale, st);
    case 64: return (int)launch<64>(x, omega, w, out, n, m, d, s, scale, st);
    case 72: return (int)launch<72>(x, omega, w, out, n, m, d, s, scale, st);
    case 96: return (int)launch<96>(x, omega, w, out, n, m, d, s, scale, st);
    default:
      return (int)launch<kMaxSC>(x, omega, w, out, n, m, d, s, scale, st);
  }
}

// Dynamic shared memory per CTA of a launch with these d and s, in bytes.
extern "C" int repro_rff_matvec_smem_bytes(int d, int s) {
  return (int)repro_torch::rff_smem_bytes(repro_torch::pick_sc(s), d);
}
