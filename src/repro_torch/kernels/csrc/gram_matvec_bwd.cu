// Backward of the fused Gram matvec with fp32 tiles: the input cotangent of
// v -> K~(x, z) @ v, dx = 2 (x * sum_j W - W @ z).
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_matvec_bwd_pallas
// (_gram_matvec_bwd_kernel), reached through the VJP of gram_matvec_fused.
//
// The kernel, its design and its plan are gram_matvec_bwd_kernel.cuh's; this
// source instantiates its fp32 tiles (BF16 = false) and holds their entry
// points.
#include <cuda_runtime.h>

#include "gram_matvec_bwd_kernel.cuh"

// x (n, d), z (m, d), rowv (n, s), colv (m, s) -> out (n, d); all float32,
// row-major, contiguous, on the current device. kind: 0 se, 1 matern12,
// 2 matern32, 3 matern52. The plan, from gram_bwd_plan: rowv/colv in slices
// of `width` columns (a multiple of 8), columns in chunks of `chunk` (a
// multiple of 64), stage 2 on the tensor cores (stage2_tc = 1) or the FMA
// pipe (0, d <= 16). With more than one (chunk, slice) part, workspace holds
// their (parts, n, d + 1) partial sums and a second launch adds them.
// Requires n, m, s >= 1 and 1 <= d <= 128. Returns the first CUDA error (0
// on success).
extern "C" int repro_gram_matvec_bwd_f32(const float* x, const float* z,
                                         const float* rowv, const float* colv,
                                         float* workspace, float* out, int n,
                                         int m, int d, int s, int kind,
                                         int width, int chunk, int stage2_tc,
                                         void* stream) {
  return repro_torch::gram_bwd<false>(x, z, rowv, colv, workspace, out, n, m, d, s, kind,
                                      width, chunk, stage2_tc != 0,
                                      static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per CTA of a launch with these d, slice width and
// stage 2, in bytes (0 where the FMA variant does not take d).
extern "C" int repro_gram_matvec_bwd_smem_bytes(int d, int width, int stage2_tc) {
  using namespace repro_torch;
  if (!stage2_tc && stage2_width(d, false) == 0) return 0;
  return (int)(sizeof(float) *
               bwd_smem_floats(d, width, stage2_tc ? stage2_width(d, true) : 0));
}
