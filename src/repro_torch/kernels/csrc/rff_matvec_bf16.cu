// Fused random-Fourier-feature matvecs with bf16 tiles, Phi~ = sqrt(1/m)
// [sin(x omega^T) | cos(x omega^T)] (n, 2m), sin features first, at the
// reference's tile precision "bf16": the contraction operands bf16, every
// accumulation fp32.
//
//   repro_rff_matvec_bf16:    out(n, s) = Phi~ @ w(2m, s);
//   repro_rff_t_matvec_bf16:  t(2m, s) = Phi~^T @ u(n, s), the rows of
//                             frequencies >= m_true zeroed;
//   repro_rff_pair_bf16:      out(n, s) = Phi~ (M Phi~^T u): the first on t,
//                             as the second writes it.
//
// Replaces: src/repro/kernels/rff_matvec.py, rff_matvec_pallas (_rff_kernel),
// rff_t_matvec_pallas (_rff_t_kernel) and rff_pair_pallas (_rff_pair_kernel)
// with precision="bf16", reached through rff_matvec_fused, rff_t_matvec_fused
// and rff_pair_fused.
//
// The cast points are the reference's (_proj, _cast_mxu): x and omega are
// rounded to bf16 (to nearest even) as they are read, and the projection is
// an fp32 sum of their exact products; sin and cos run in fp32 (full-range
// sincosf) and are rounded to bf16, unscaled, as is the B operand (w or u);
// the product runs on the tensor cores as mma.sync m16n8k16 bf16 with fp32
// accumulation, and sqrt(1/m) multiplies its sum. The pair's second phase
// takes t as the first writes it, scaled by sqrt(1/m) and masked, and rounds
// it as its B operand: rff_pair_pallas casts the scaled intermediate too.
//
// The kernel, its design and its plan are rff_matvec_kernel.cuh's (BF16 =
// true: one bf16 product a 16-deep k-step where the fp32 tiles run three in
// their TF32 split); this source instantiates the bf16 tiles at the n-tile
// counts below, in a source of its own so the two build in parallel.
#include <cuda_runtime.h>

#include "rff_matvec_kernel.cuh"

// n-tile counts (8 columns each) instantiated per orientation: the bf16
// paths' widths (s = 1-8, 65) exactly, and 2, 4, 12, 16 for the rest.
#define REPRO_RFF_BF16_TILE_BUCKETS 1, 2, 4, 8, 9, 12, 16

using RffBf16 = repro_torch::Rff<true, REPRO_RFF_BF16_TILE_BUCKETS>;

// repro_rff_matvec_f32's contract (rff_matvec.cu) with bf16 tiles: out (n, s)
// = Phi~ w on rff_plan's width and frequency chunks. One or two launches on
// `stream`; returns the first CUDA error (0 on success).
extern "C" int repro_rff_matvec_bf16(const float* x, const float* omega,
                                     const float* w, float* workspace, float* out,
                                     int n, int m, int d, int s, int width,
                                     int freq_chunk, void* stream) {
  return RffBf16::matvec_entry(x, omega, w, workspace, out, n, m, d, s, width,
                               freq_chunk, stream);
}

// repro_rff_t_matvec_f32's contract with bf16 tiles: t (2m, s) = Phi~^T u,
// rows of frequencies >= m_true zeroed. Two launches on `stream`.
extern "C" int repro_rff_t_matvec_bf16(const float* x, const float* omega,
                                       const float* u, float* workspace, float* t,
                                       int n, int m, int d, int s, int m_true,
                                       int width, int row_chunk, void* stream) {
  return RffBf16::t_matvec_entry(x, omega, u, workspace, t, n, m, d, s, m_true, width,
                                 row_chunk, stream);
}

// repro_rff_pair_f32's contract with bf16 tiles: out (n, s) = Phi~ (M Phi~^T
// u), t (2m, s) kept in fp32 between the phases and rounded by the second.
// Three or four launches on `stream`, no host sync.
extern "C" int repro_rff_pair_bf16(const float* x, const float* omega,
                                   const float* u, float* workspace, float* t,
                                   float* out, int n, int m, int d, int s,
                                   int m_true, int width, int row_chunk,
                                   int freq_chunk, void* stream) {
  return RffBf16::pair_entry(x, omega, u, workspace, t, out, n, m, d, s, m_true, width,
                             row_chunk, freq_chunk, stream);
}

// Dynamic shared memory per CTA of a bf16 launch with these d and slice
// width, in bytes (0 for a width no instance takes); either orientation.
extern "C" int repro_rff_matvec_smem_bytes_bf16(int d, int width) {
  return RffBf16::smem_bytes(d, width);
}
