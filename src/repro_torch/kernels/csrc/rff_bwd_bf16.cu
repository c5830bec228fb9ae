// Backward of the random-Fourier-feature matvecs with bf16 tiles: the input
// cotangent of the projection proj = R^ C^^T at the reference's tile
// precision "bf16", dR = scale W^ @ C^, W = cos(proj) * P1^ Q1^^T -
// sin(proj) * P2^ Q2^^T in fp32, ^ marking a value rounded to bf16 (to
// nearest even).
//
// Replaces: src/repro/kernels/rff_matvec.py, rff_bwd_pallas
// (_rff_bwd_kernel) with precision="bf16", reached through the VJPs of
// rff_matvec_fused, rff_t_matvec_fused and rff_pair_fused at that precision.
//
// The kernel, its design and its plan are rff_bwd_kernel.cuh's (BF16 = true:
// one bf16 product a 16-deep k-step where the fp32 tiles run three in their
// TF32 split; sin, cos and W stay fp32); this source instantiates the bf16
// tiles, 2 kernels, in a source of its own so the two build in parallel.
#include <cuda_runtime.h>

#include "rff_bwd_kernel.cuh"

// repro_rff_bwd_f32's contract (rff_bwd.cu) and plan (width, chunk from
// rff_bwd_plan) with bf16 tiles: the factor products always on the tensor
// cores. Returns the first CUDA error (0 on success).
extern "C" int repro_rff_bwd_bf16(const float* r, const float* c, const float* p1,
                                  const float* p2, const float* q1, const float* q2,
                                  float* workspace, float* out, int rows, int cols, int d,
                                  int s, float scale, int width, int chunk, void* stream) {
  return repro_torch::rff_bwd<true>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s,
                                    scale, width, chunk, true,
                                    static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory per CTA of a bf16 launch with these d and slice
// width, in bytes.
extern "C" int repro_rff_bwd_smem_bytes_bf16(int d, int width) {
  using namespace repro_torch;
  return (int)(sizeof(float) * bwd_smem_floats<true>(d, width, true));
}
