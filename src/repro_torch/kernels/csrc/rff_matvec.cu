// Fused random-Fourier-feature matvecs with fp32 tiles, Phi~ = sqrt(1/m)
// [sin(x omega^T) | cos(x omega^T)] (n, 2m), sin features first:
//
//   repro_rff_matvec_f32:    out(n, s) = Phi~ @ w(2m, s);
//   repro_rff_t_matvec_f32:  t(2m, s) = Phi~^T @ u(n, s), the rows of
//                            frequencies >= m_true zeroed;
//   repro_rff_pair_f32:      out(n, s) = Phi~ (M Phi~^T u), M that mask: the
//                            first followed by the second on t.
//
// Replaces: src/repro/kernels/rff_matvec.py, rff_matvec_pallas (_rff_kernel),
// rff_t_matvec_pallas (_rff_t_kernel) and rff_pair_pallas (_rff_pair_kernel),
// reached through rff_matvec_fused, rff_t_matvec_fused and rff_pair_fused.
//
// The kernel, its design and its plan are rff_matvec_kernel.cuh's; this
// source instantiates its fp32 tiles (BF16 = false) at the n-tile counts
// below, and holds their entry points.
#include <cuda_runtime.h>

#include "rff_matvec_kernel.cuh"

// n-tile counts (8 columns each) instantiated per orientation: the paths'
// widths exactly (s = 1-8, 9-16, 17-32, 64, 65, 100, 128) and the
// multiples of 4 for the rest.
#define REPRO_RFF_TILE_BUCKETS 1, 2, 4, 8, 9, 12, 13, 16

using RffF32 = repro_torch::Rff<false, REPRO_RFF_TILE_BUCKETS>;

// x (n, d), omega (m, d), w (2m, s) -> out (n, s) = Phi~ w. All float32,
// row-major, contiguous, on the current device. The plan, from rff_plan:
// w in slices of `width` columns (a multiple of 8, at most 128), the
// frequencies in chunks of `freq_chunk` (a multiple of 32); with several
// chunks, workspace holds their (chunks, n, s) partial sums. Requires n, m,
// s >= 1 and 1 <= d <= 128. One or two launches on `stream`; returns the
// first CUDA error (0 on success).
extern "C" int repro_rff_matvec_f32(const float* x, const float* omega,
                                    const float* w, float* workspace, float* out,
                                    int n, int m, int d, int s, int width,
                                    int freq_chunk, void* stream) {
  return RffF32::matvec_entry(x, omega, w, workspace, out, n, m, d, s, width,
                              freq_chunk, stream);
}

// x (n, d), omega (m, d), u (n, s) -> t (2m, s) = Phi~^T u, rows of
// frequencies >= m_true zeroed; the plan's width as above and row chunks of
// `row_chunk` rows (a multiple of 64), whose (chunks, 2m, s) partial sums go
// to workspace. Requires n, m, s >= 1, 1 <= d <= 128 and 0 <= m_true <= m.
// Two launches on `stream`; returns the first CUDA error.
extern "C" int repro_rff_t_matvec_f32(const float* x, const float* omega,
                                      const float* u, float* workspace, float* t,
                                      int n, int m, int d, int s, int m_true,
                                      int width, int row_chunk, void* stream) {
  return RffF32::t_matvec_entry(x, omega, u, workspace, t, n, m, d, s, m_true, width,
                                row_chunk, stream);
}

// x (n, d), omega (m, d), u (n, s) -> out (n, s) = Phi~ (M Phi~^T u): t (2m,
// s) as repro_rff_t_matvec_f32 writes it (row chunks of `row_chunk`), then
// Phi~ t as repro_rff_matvec_f32 (frequency chunks of `freq_chunk`); the
// workspace holds either phase's partials. Three or four launches on
// `stream`, no host sync; returns the first CUDA error.
extern "C" int repro_rff_pair_f32(const float* x, const float* omega,
                                  const float* u, float* workspace, float* t,
                                  float* out, int n, int m, int d, int s,
                                  int m_true, int width, int row_chunk,
                                  int freq_chunk, void* stream) {
  return RffF32::pair_entry(x, omega, u, workspace, t, out, n, m, d, s, m_true, width,
                            row_chunk, freq_chunk, stream);
}

// Dynamic shared memory per CTA of a launch with these d and slice width, in
// bytes (0 for a width no instance takes); the same in both orientations.
extern "C" int repro_rff_matvec_smem_bytes(int d, int width) {
  return RffF32::smem_bytes(d, width);
}
