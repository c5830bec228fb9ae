// Backward of the fused Gram matvec with bf16 tiles: the input cotangent of
// v -> K~(x, z) @ v at the reference's tile precision "bf16",
// dx = 2 (x * sum_j W - W^ @ z^), W_ij = k'(d2^_ij) mask_ij (rowv^_i . colv^_j),
// ^ marking a value rounded to bf16 (to nearest even).
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_matvec_bwd_pallas
// (_gram_matvec_bwd_kernel) with precision="bf16", reached through the VJPs
// of gram_matvec_fused and gram_rows_pair_fused at that precision.
//
// The cast points are the reference's (_cast_mxu, _pair_dists): x and z
// rounded before the distance, whose norms and inner product are fp32 sums of
// the rounded values; rowv and colv before G = rowv colv^T, an m16n8k16 bf16
// product with fp32 accumulation; W, computed in fp32, before W z, whose z is
// rounded too; sum_j W from the fp32 W. The flush 2 (x sum W - W z) uses the
// fp32 x. The kernel, its design and its plan are
// gram_matvec_bwd_kernel.cuh's (BF16 = true); this source instantiates the
// bf16 tiles, 12 kernels (3 z widths a kind), in a source of its own so the
// two build in parallel.
#include <cuda_runtime.h>

#include "gram_matvec_bwd_kernel.cuh"

// repro_gram_matvec_bwd_f32's contract (gram_matvec_bwd.cu) and plan (width,
// chunk from gram_bwd_plan) with bf16 tiles: both products always on the
// tensor cores. Returns the first CUDA error (0 on success).
extern "C" int repro_gram_matvec_bwd_bf16(const float* x, const float* z,
                                          const float* rowv, const float* colv,
                                          float* workspace, float* out, int n,
                                          int m, int d, int s, int kind,
                                          int width, int chunk, void* stream) {
  return repro_torch::gram_bwd<true>(x, z, rowv, colv, workspace, out, n, m, d, s, kind,
                                     width, chunk, true, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per CTA of a bf16 launch with these d and slice
// width, in bytes.
extern "C" int repro_gram_matvec_bwd_smem_bytes_bf16(int d, int width) {
  using namespace repro_torch;
  return (int)(sizeof(float) * bwd_smem_floats<true>(d, width, stage2_width_bf16(d)));
}
