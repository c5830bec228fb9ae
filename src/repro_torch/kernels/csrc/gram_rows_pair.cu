// The SGD pair on the row panel A = K~(xi, x) of a few hundred gathered rows
// xi against all n points x:
//
//   repro_gram_rows_pair_f32:    err(p, s) = A @ look - b, rows >= p_true
//                                zeroed;  g(n, s) = A^T @ err
//
// unit signal, inputs already lengthscale-scaled, no jitter. SDD's rows_mv,
// A @ u alone, is the Gram matvec itself (repro_gram_matvec_f32 with
// gram_plan's chunks).
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_rows_pair_pallas
// (_gram_rows_pair_kernel), reached through gram_rows_pair_fused.
//
// What bounds it on an H100: operations. Each of the 2pn panel entries it
// builds costs 2d flops for the distance and 2s for its contraction: at
// p = 512, n = 45,730, d = 9, s = 65 that is ~6.5e9 flops for ~0.03 GB of
// operands and partial sums: operations, on the Gram kernel's three pipes
// (the FMA pipe for the distance, the SFU for exp and sqrt, the tensor cores
// for the three-way TF32 contraction; see gram_matvec.cu).
//
// What the design does about it. The Pallas kernel runs a sequential (2, n)
// grid and keeps err in VMEM between its two phases; on Hopper CTAs run at
// once and in no order, so the phases are three launches on one stream, with
// no host sync between them and the (p, s) err block in device memory, each
// phase one call of repro_gram_matvec_f32 (gram_matvec.cu) with its plan from
// gram_plan in kernels/gram_matvec.py:
//
//   0. err = A @ look - b, rows >= p_true zeroed: the Gram kernel in column
//      chunks (its rows alone would give ceil(p/64) = 2-16 CTAs for 132 SMs,
//      so grid.y cuts the n columns into `chunk0`-column chunks, at least
//      264 CTAs, two waves, at p = 128, 512 and 1,024 on protein), then the
//      fixed-order chunk sum, which subtracts b and zeros the masked rows: no
//      float atomicAdd;
//   2. g = K~(x, xi) @ err: n output rows against p columns, a loop of only
//      ceil(p/64) tiles (8 at p = 512), so the plan runs `rows_per_cta2` row
//      blocks in each CTA, its copies pipelined across them; with few n,
//      `chunk2`-column chunks as in phase 0. Masked err rows contribute
//      nothing.
//
// Both phases are the Gram kernel, so d2 and k agree bit for bit with the
// Gram forward's.
//
// repro_gram_rows_pair_bf16 is the same two phases on the Gram kernel's bf16
// tiles (repro_gram_matvec_bf16, gram_matvec_bf16.cu): gram_rows_pair_pallas
// with precision="bf16", whose second phase contracts the panel with err
// rounded to bf16 after its fp32 accumulation, b and the mask: phase 2's v
// operand, which that kernel rounds as it lands.
#include <cuda_runtime.h>

extern "C" int repro_gram_matvec_f32(const float* x, const float* z,
                                     const float* v, const float* b,
                                     float* workspace, float* out, int n,
                                     int m, int d, int s, int kind,
                                     int rows_true, int width, int chunk,
                                     int rows_per_cta, void* stream);
extern "C" int repro_gram_matvec_bf16(const float* x, const float* z,
                                      const float* v, const float* b,
                                      float* workspace, float* out, int n,
                                      int m, int d, int s, int kind,
                                      int rows_true, int width, int chunk,
                                      int rows_per_cta, void* stream);

namespace {

using GramEntry = int (*)(const float*, const float*, const float*, const float*,
                          float*, float*, int, int, int, int, int, int, int, int,
                          int, void*);

// The two phases on the Gram entry `mv`.
int rows_pair(GramEntry mv, const float* xi, const float* x, const float* look,
              const float* b, float* workspace, float* err, float* g, int p,
              int n, int d, int s, int kind, int p_true, int width, int chunk0,
              int rows_per_cta0, int chunk2, int rows_per_cta2, void* stream) {
  if (p < 1 || p_true < 0 || p_true > p) return (int)cudaErrorInvalidValue;
  const int e = mv(xi, x, look, b, workspace, err, p, n, d, s, kind, p_true, width,
                   chunk0, rows_per_cta0, stream);
  if (e != 0) return e;
  return mv(x, xi, err, nullptr, workspace, g, n, p, d, s, kind, n, width, chunk2,
            rows_per_cta2, stream);
}

}  // namespace

// xi (p, d), x (n, d), look (n, s), b (p, s) -> err (p, s) = K~(xi, x) @ look
// - b with rows >= p_true zeroed, and g (n, s) = K~(xi, x)^T @ err. All
// float32, row-major, contiguous, on the current device; kind as in
// repro_gram_matvec_f32. Phase 0 runs gram_plan(p, n, d, s)'s (width,
// chunk0, rows_per_cta0), phase 2 gram_plan(n, p, d, s)'s (width, chunk2,
// rows_per_cta2); the workspace holds either phase's partials when it has
// several chunks (GramPlan.workspace_floats). Requires p, n, s >= 1,
// 1 <= d <= 128 and 0 <= p_true <= p. Three or four launches on `stream`, no
// host sync; returns the first CUDA error (0 on success).
extern "C" int repro_gram_rows_pair_f32(const float* xi, const float* x,
                                        const float* look, const float* b,
                                        float* workspace, float* err,
                                        float* g, int p, int n, int d, int s,
                                        int kind, int p_true, int width,
                                        int chunk0, int rows_per_cta0,
                                        int chunk2, int rows_per_cta2,
                                        void* stream) {
  return rows_pair(repro_gram_matvec_f32, xi, x, look, b, workspace, err, g, p, n,
                   d, s, kind, p_true, width, chunk0, rows_per_cta0, chunk2,
                   rows_per_cta2, stream);
}

// The same with bf16 tiles: repro_gram_matvec_bf16 in both phases.
extern "C" int repro_gram_rows_pair_bf16(const float* xi, const float* x,
                                         const float* look, const float* b,
                                         float* workspace, float* err,
                                         float* g, int p, int n, int d, int s,
                                         int kind, int p_true, int width,
                                         int chunk0, int rows_per_cta0,
                                         int chunk2, int rows_per_cta2,
                                         void* stream) {
  return rows_pair(repro_gram_matvec_bf16, xi, x, look, b, workspace, err, g, p, n,
                   d, s, kind, p_true, width, chunk0, rows_per_cta0, chunk2,
                   rows_per_cta2, stream);
}
