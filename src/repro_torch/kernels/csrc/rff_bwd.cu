// Backward of the random-Fourier-feature matvecs with fp32 tiles: the input
// cotangent of the projection proj = R C^T,
// dR = scale (cos(R C^T) * P1 Q1^T - sin(R C^T) * P2 Q2^T) @ C.
//
// Replaces: src/repro/kernels/rff_matvec.py, rff_bwd_pallas
// (_rff_bwd_kernel), reached through the VJPs of rff_matvec_fused,
// rff_t_matvec_fused and rff_pair_fused.
//
// The kernel, its design and its plan are rff_bwd_kernel.cuh's; this source
// instantiates its fp32 tiles (BF16 = false) and holds their entry points.
#include <cuda_runtime.h>

#include "rff_bwd_kernel.cuh"

// r (rows, d), c (cols, d), p1, p2 (rows, s), q1, q2 (cols, s) -> out
// (rows, d) = scale * (cos(r c^T) * p1 q1^T - sin(r c^T) * p2 q2^T) @ c. All
// float32, row-major, contiguous, on the current device. The plan, from
// rff_bwd_plan: P and Q in slices of `width` columns (a multiple of 8), the
// columns in chunks of `chunk` (a multiple of 64), the factor products on the
// tensor cores (products_tc = 1) or the FMA pipe (0). With more than one (chunk,
// slice) part, workspace holds their (parts, rows, d) partial sums and a
// second launch adds them. Requires rows, cols, s >= 1 and 1 <= d <= 128.
// Returns the first CUDA error (0 on success).
extern "C" int repro_rff_bwd_f32(const float* r, const float* c, const float* p1,
                                 const float* p2, const float* q1, const float* q2,
                                 float* workspace, float* out, int rows, int cols, int d,
                                 int s, float scale, int width, int chunk, int products_tc,
                                 void* stream) {
  return repro_torch::rff_bwd<false>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s,
                                     scale, width, chunk, products_tc != 0,
                                     static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per CTA of a launch with these d, slice width and
// products variant, in bytes.
extern "C" int repro_rff_bwd_smem_bytes(int d, int width, int products_tc) {
  using namespace repro_torch;
  return (int)(sizeof(float) * bwd_smem_floats(d, width, products_tc != 0));
}
