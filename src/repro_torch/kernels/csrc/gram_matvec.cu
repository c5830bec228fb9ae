// Fused Gram matvec with fp32 tiles: out(n, s) = K~(x, z) @ v(m, s), K~ the
// unit-signal stationary covariance of already lengthscale-scaled inputs, no
// jitter; and, by repro_gram_matvec_scaled_f32, (signal K~ + jitter I) @ v.
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_matvec_pallas
// (_gram_matvec_kernel), reached through gram_matvec_fused.
//
// The kernel, its design and its plan are gram_matvec_kernel.cuh's; this
// source instantiates its fp32 tiles (BF16 = false) at the n-tile counts
// below, and holds their entry points.
#include <cuda_runtime.h>

#include "gram_matvec_kernel.cuh"

// The n-tile counts (8 columns each) instantiated per kind, 44 kernels of 64:
// the path's widths (s = 1-8, 9, 65, 100) exactly, and each count whose
// rounding up cost more than 5% on the card (10, 11, 14, 15; scripts/
// gram_variants.py). The rest round up at no measured loss: 3 to 4
// (s = 17), 5-7 to 8, 12 to 13. The scaled entry below runs 24 more
// (REPRO_GRAM_SCALED_TILE_BUCKETS, gram_matvec_kernel.cuh).
#define REPRO_GRAM_TILE_BUCKETS 1, 2, 4, 8, 9, 10, 11, 13, 14, 15, 16

// x (n, d), z (m, d), v (m, s), b (n, s) -> out (n, s) = K~(x, z) @ v - b,
// rows >= rows_true zeroed (b may be null; 0 <= rows_true <= n). All float32,
// row-major, contiguous, on the current device. kind: 0 se, 1 matern12,
// 2 matern32, 3 matern52. The plan, from gram_plan: v in slices of `width`
// columns (a multiple of 8, at most 128), columns in chunks of `chunk` (a
// multiple of 64), rows_per_cta row blocks of 64 rows per CTA. Requires n,
// m, s, rows_per_cta >= 1 and 1 <= d <= 128. With one chunk (chunk >= m),
// no b and rows_true = n, one launch writes out; with one chunk otherwise,
// the chunk sum subtracts b and masks rows in place; with several, the
// kernel writes the (chunks, n, s) partials to `workspace` and the chunk sum
// adds them in a fixed order into out. One or two launches on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int repro_gram_matvec_f32(const float* x, const float* z,
                                     const float* v, const float* b,
                                     float* workspace, float* out, int n,
                                     int m, int d, int s, int kind,
                                     int rows_true, int width, int chunk,
                                     int rows_per_cta, void* stream) {
  return repro_torch::gram_matvec<false, false, REPRO_GRAM_TILE_BUCKETS>(
      x, z, v, b, workspace, out, n, m, d, s, kind, rows_true, width, chunk,
      rows_per_cta, static_cast<cudaStream_t>(stream));
}

// out (n, s) = (signal K~(x, z) + jitter I) @ v with both inside the kernel,
// gram_matvec_pallas's signal and jitter: the k tile scaled by signal before
// its product, jitter v[r] added to row r (jitter != 0 needs z = x, m = n,
// else cudaErrorInvalidValue). repro_gram_matvec_f32's contract and plan
// otherwise, with no b and no masked rows. One or two launches on `stream`;
// returns the first CUDA error (0 on success).
extern "C" int repro_gram_matvec_scaled_f32(const float* x, const float* z,
                                            const float* v, float* workspace,
                                            float* out, int n, int m, int d,
                                            int s, int kind, float signal,
                                            float jitter, int width, int chunk,
                                            int rows_per_cta, void* stream) {
  return repro_torch::gram_matvec<false, true, REPRO_GRAM_SCALED_TILE_BUCKETS>(
      x, z, v, nullptr, workspace, out, n, m, d, s, kind, n, width, chunk,
      rows_per_cta, static_cast<cudaStream_t>(stream), signal, jitter);
}

// Dynamic shared memory per CTA of a launch with these d, slice width and
// rows_per_cta, in bytes (0 for a width no instance takes).
extern "C" int repro_gram_matvec_smem_bytes(int d, int width, int rows_per_cta) {
  using namespace repro_torch;
  const int nt = tile_bucket<REPRO_GRAM_TILE_BUCKETS>((width + 7) / 8);
  return nt == 0 ? 0 : (int)gram_smem_bytes<false>(d, nt, rows_per_cta > 1 ? 2 : 1);
}

// The text of a CUDA error code returned by an entry point above.
extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
