// Fused Gram matvec with bf16 tiles: out(n, s) = K~(x, z) @ v(m, s), K~ the
// unit-signal stationary covariance of already lengthscale-scaled inputs, no
// jitter, at the reference's tile precision "bf16": the contraction operands
// bf16, every accumulation fp32.
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_matvec_pallas
// (_gram_matvec_kernel) with precision="bf16", reached through
// gram_matvec_fused; and, as both phases of repro_gram_rows_pair_bf16
// (gram_rows_pair.cu), gram_rows_pair_pallas (_gram_rows_pair_kernel) with
// precision="bf16".
//
// The cast points are the reference's (_cast_mxu, _pair_dists):
//   * x and z are rounded to bf16 (to nearest even) as they are read; the
//     norms ||x^||^2, ||z^||^2 and the inner product x^.z^ are fp32 sums of
//     the rounded values (bf16 x bf16 is exact in fp32), in common.cuh's FMA
//     order, and d^2 = max(fmaf(-2, x^.z^, ||x^||^2 + ||z^||^2), 0), so a
//     point paired with itself still gives exactly 0;
//   * the covariance map, its exp and sqrt run in fp32 (cov_map, common.cuh);
//   * the k tile and the v tile are rounded to bf16 before their product,
//     which runs on the tensor cores as mma.sync m16n8k16 bf16 with fp32
//     accumulation. The rows pair's second phase is this kernel on
//     (x, xi, err), so err, accumulated and masked in fp32, is rounded here.
//
// The kernel, its design and its plan are gram_matvec_kernel.cuh's (BF16 =
// true: one bf16 product a 16-deep k-step where the fp32 tiles run three in
// their TF32 split); this source instantiates the bf16 tiles at the n-tile
// counts below, in a source of its own so the two build in parallel.
#include <cuda_runtime.h>

#include "gram_matvec_kernel.cuh"

// The n-tile counts (8 columns each) instantiated per kind, 28 kernels: the
// bf16 paths' widths (s = 1-8, 65) exactly, and 2, 4, 12, 16 for the rest;
// and 24 scaled ones (REPRO_GRAM_SCALED_TILE_BUCKETS) for the scaled entry.
#define REPRO_GRAM_BF16_TILE_BUCKETS 1, 2, 4, 8, 9, 12, 16

// out (n, s) = K~(x, z) @ v - b with bf16 tiles, rows >= rows_true zeroed (b
// may be null; 0 <= rows_true <= n): repro_gram_matvec_f32's contract
// (gram_matvec.cu) and plan (width, chunk, rows_per_cta from gram_plan), its
// column chunks' partials in `workspace` and their fixed-order fp32 sum.
// One or two launches on `stream`; returns the first CUDA error (0 on
// success).
extern "C" int repro_gram_matvec_bf16(const float* x, const float* z,
                                      const float* v, const float* b,
                                      float* workspace, float* out, int n,
                                      int m, int d, int s, int kind,
                                      int rows_true, int width, int chunk,
                                      int rows_per_cta, void* stream) {
  return repro_torch::gram_matvec<true, false, REPRO_GRAM_BF16_TILE_BUCKETS>(
      x, z, v, b, workspace, out, n, m, d, s, kind, rows_true, width, chunk,
      rows_per_cta, static_cast<cudaStream_t>(stream));
}

// (signal K~(x, z) + jitter I) @ v with bf16 tiles, the k tile scaled before
// it is rounded: repro_gram_matvec_scaled_f32's contract (gram_matvec.cu).
extern "C" int repro_gram_matvec_scaled_bf16(const float* x, const float* z,
                                             const float* v, float* workspace,
                                             float* out, int n, int m, int d,
                                             int s, int kind, float signal,
                                             float jitter, int width, int chunk,
                                             int rows_per_cta, void* stream) {
  return repro_torch::gram_matvec<true, true, REPRO_GRAM_SCALED_TILE_BUCKETS>(
      x, z, v, nullptr, workspace, out, n, m, d, s, kind, n, width, chunk,
      rows_per_cta, static_cast<cudaStream_t>(stream), signal, jitter);
}

// Dynamic shared memory per CTA of a bf16 launch with these d, slice width
// and rows_per_cta, in bytes (0 for a width no instance takes).
extern "C" int repro_gram_matvec_smem_bytes_bf16(int d, int width, int rows_per_cta) {
  using namespace repro_torch;
  const int nt = tile_bucket<REPRO_GRAM_BF16_TILE_BUCKETS>((width + 7) / 8);
  return nt == 0 ? 0 : (int)gram_smem_bytes<true>(d, nt, rows_per_cta > 1 ? 2 : 1);
}
