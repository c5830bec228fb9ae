// Row-panel matvecs of the stochastic solvers, A = K~(xi, x) the (p, n) panel
// of a few hundred gathered rows xi against all n points x:
//
//   repro_gram_rows_matvec_f32:  out(p, s) = A @ u(n, s)            (rows_mv)
//   repro_gram_rows_pair_f32:    err(p, s) = A @ look - b, rows >= p_true
//                                zeroed;  g(n, s) = A^T @ err        (SGD)
//
// unit signal, inputs already lengthscale-scaled, no jitter.
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_rows_pair_pallas
// (_gram_rows_pair_kernel), reached through gram_rows_pair_fused; and the
// row-panel call of gram_matvec_pallas behind ops.gram_rows_matvec.
//
// What bounds it on an H100: operations. Each of the 2pn panel entries it
// builds costs 2d flops for the distance and 2s for its contraction: at
// p = 512, n = 45,730, d = 9, s = 65 that is ~6.5e9 flops for ~0.03 GB of
// operands and partial sums, so the fp32 FMA rate and the exp/sqrt of the
// covariance map set the pace, as in the Gram matvec.
//
// What the design does about it. The Pallas kernel runs a sequential (2, n)
// grid and keeps err in VMEM between its two phases; on Hopper CTAs run at
// once and in no order, so the phases are three launches on one stream, with
// no host sync between them and the (p, s) err block in device memory:
//
//   0. A @ look by the Gram matvec kernel (gram_matvec.cu) in column chunks:
//      its row loop over p alone would give ceil(p/64) = 4-8 CTAs for 132
//      SMs, so grid.y cuts the n columns into chunks of kChunkCols, giving
//      ceil(p/64) * ceil(n/kChunkCols) CTAs (360 at p = 512 on protein),
//      each writing a (64, s) partial block to a (C, p, s) workspace;
//   1. a small kernel that adds the C partials in a fixed order, subtracts b
//      and zeros the rows >= p_true: deterministic, no float atomicAdd;
//   2. g = K~(x, xi) @ err by the Gram matvec kernel itself: n output rows,
//      ceil(n/64) = 715 CTAs. Masked err rows contribute nothing.
//
// Phases 0 and 2 use the Gram kernel's distance identity and FMA order
// (common.cuh), so d2 and k agree bit for bit with the Gram forward's.
#include <cuda_runtime.h>

#include "common.cuh"

extern "C" int repro_gram_matvec_f32(const float* x, const float* z,
                                     const float* v, float* out, int n, int m,
                                     int d, int s, int kind, void* stream);
extern "C" int repro_gram_matvec_chunked_f32(const float* x, const float* z,
                                             const float* v, float* partial,
                                             int n, int m, int d, int s,
                                             int kind, int chunk, void* stream);

namespace repro_torch {
namespace {

// Panel columns per CTA in phase 0 (16 column tiles).
constexpr int kChunkCols = 1024;
constexpr int kReduceThreads = 256;

__host__ inline int num_chunks(int n) { return (n + kChunkCols - 1) / kChunkCols; }

// out[i] = sum_c partial[c, i] (c in order) - b[i], zeroed past p_true.
__global__ void __launch_bounds__(kReduceThreads)
rows_reduce_kernel(const float* __restrict__ partial,
                   const float* __restrict__ b, float* __restrict__ out,
                   int chunks, int p, int s, int p_true) {
  const size_t total = (size_t)p * s;
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * total + i];
  if (b != nullptr) acc -= b[i];
  out[i] = (int)(i / s) < p_true ? acc : 0.0f;
}

// Phases 0 and 1: out(p, s) = A @ u (- b), rows >= p_true zeroed.
int panel_matvec(const float* xi, const float* x, const float* u,
                 const float* b, float* workspace, float* out, int p, int n,
                 int d, int s, int kind, int p_true, void* stream) {
  const int err = repro_gram_matvec_chunked_f32(xi, x, u, workspace, p, n, d,
                                                s, kind, kChunkCols, stream);
  if (err != 0) return err;
  const size_t total = (size_t)p * s;
  const unsigned blocks = (unsigned)((total + kReduceThreads - 1) / kReduceThreads);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rows_reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(
      workspace, b, out, num_chunks(n), p, s, p_true);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Floats of the workspace both entries below need: (ceil(n / 1024), p, s).
extern "C" long long repro_gram_rows_workspace_floats(int p, int n, int s) {
  return (long long)repro_torch::num_chunks(n) * p * s;
}

// xi (p, d), x (n, d), u (n, s) -> out (p, s) = K~(xi, x) @ u; workspace of
// repro_gram_rows_workspace_floats(p, n, s) floats. All float32, row-major,
// contiguous, on the current device; kind as in repro_gram_matvec_f32.
// Requires p, n, s >= 1 and 1 <= d <= 128. Two launches on `stream`; returns
// the first CUDA error (0 on success).
extern "C" int repro_gram_rows_matvec_f32(const float* xi, const float* x,
                                          const float* u, float* workspace,
                                          float* out, int p, int n, int d,
                                          int s, int kind, void* stream) {
  using namespace repro_torch;
  if (p < 1 || n < 1 || s < 1 || d < 1 || d > kMaxDim)
    return (int)cudaErrorInvalidValue;
  return panel_matvec(xi, x, u, nullptr, workspace, out, p, n, d, s, kind, p,
                      stream);
}

// xi (p, d), x (n, d), look (n, s), b (p, s) -> err (p, s) = K~(xi, x) @ look
// - b with rows >= p_true zeroed, and g (n, s) = K~(xi, x)^T @ err; workspace
// as above. Requires p, n, s >= 1, 1 <= d <= 128 and 0 <= p_true <= p. Three
// launches on `stream`, no host sync; returns the first CUDA error.
extern "C" int repro_gram_rows_pair_f32(const float* xi, const float* x,
                                        const float* look, const float* b,
                                        float* workspace, float* err,
                                        float* g, int p, int n, int d, int s,
                                        int kind, int p_true, void* stream) {
  using namespace repro_torch;
  if (p < 1 || n < 1 || s < 1 || d < 1 || d > kMaxDim || p_true < 0 ||
      p_true > p)
    return (int)cudaErrorInvalidValue;
  const int e = panel_matvec(xi, x, look, b, workspace, err, p, n, d, s, kind,
                             p_true, stream);
  if (e != 0) return e;
  return repro_gram_matvec_f32(x, xi, err, g, n, p, d, s, kind, stream);
}
