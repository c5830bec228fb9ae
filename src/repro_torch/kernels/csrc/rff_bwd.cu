// Backward of the random-Fourier-feature matvecs: the input cotangent of the
// projection proj = R C^T,
//
//   dR(rows, d) = scale * W @ C,
//   W_ij = cos(R_i . C_j) (P1_i . Q1_j) - sin(R_i . C_j) (P2_i . Q2_j),
//
// with R (rows, d), C (cols, d), P1, P2 (rows, s) and Q1, Q2 (cols, s). The
// factor roles give every VJP of rff_matvec.cu's three entries: dx of
// Phi~ w is (R, C, P1, P2, Q1, Q2) = (x, omega, g, g, w_sin, w_cos), domega
// is (omega, x, w_sin, w_cos, g, g), and the pair's are the same on its
// rank-2s factors.
//
// Replaces: src/repro/kernels/rff_matvec.py, rff_bwd_pallas
// (_rff_bwd_kernel), reached through the VJPs of rff_matvec_fused,
// rff_t_matvec_fused and rff_pair_fused.
//
// What bounds it on an H100: operations. Each of the rows * cols pairs costs
// 2d flops for the projection, 2s for each of the two factor products, one
// sincosf and 2d for W C, against 4(rows d + cols d + 2 rows s + 2 cols s +
// rows d) bytes: at the Thompson ascent's shape (400 query rows, 512
// frequencies, d = 8, s = 100) ~8.8e7 flops for ~0.6 MB, at protein's domega
// (1,024 frequencies against 45,730 rows, d = 9, s = 65) ~1.4e10 flops for
// ~25 MB. sincosf is the full-range libm version, as in the forward kernels:
// projections reach tens of radians, where the fast intrinsics lose digits,
// so there is no --use_fast_math here, and proj is built in the forward
// kernels' FMA order, so both passes see the same angle.
//
// What the design does about it. W never reaches device memory. One CTA owns
// BM = 64 output rows and one chunk of the columns (the reduction axis, the
// sequential column axis of the Pallas grid): both orientations can have few
// output rows (400 query points, or m = 100 frequencies) against a long
// reduction (45,730 points), so the columns are cut into chunks until about
// two waves of CTAs fill the card. Thread (r, g) owns row r and every
// KSPLIT-th column of each tile, with the row's P1 and P2 in shared memory
// at an odd stride (conflict-free) and the tile's C, Q1 and Q2 rows read as
// broadcasts; it accumulates W_ij C_j in DC registers (d rounded up to a
// bucket, the C tile zero-filled past d). The KSPLIT partials of a row are
// added through shared memory; a single chunk writes scale * dR directly,
// several write partial blocks that a second kernel adds in a fixed order
// and scales: deterministic, no float atomicAdd. Ragged edges are zero-filled
// tiles: a zero Q row makes its pair's weight 0. The wrapper slices s above
// kMaxS, since dR is linear in each rank-s product.
#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"

namespace repro_torch {
namespace {

// Widest factor one launch takes; the wrapper slices wider ones.
constexpr int kMaxS = 128;
constexpr int kTargetCtas = 2 * 132;  // two waves of CTAs on 132 SMs
constexpr int kReduceThreads = 256;

// Instantiated widths of the W C accumulator (multiples of 4: C rows are
// read as float4).
__host__ inline int pick_dc(int d) {
  const int widths[] = {4, 8, 12, 16, 32, 64, kMaxDim};
  for (int w : widths)
    if (d <= w) return w;
  return kMaxDim;
}

// Columns per chunk: enough chunks for kTargetCtas CTAs over the row blocks,
// a multiple of BN.
__host__ inline int chunk_cols(int rows, int cols) {
  const int blocks = (rows + BM - 1) / BM;
  const int want = (kTargetCtas + blocks - 1) / blocks;
  const int per = (cols + want - 1) / want;
  return ((per + BN - 1) / BN) * BN;
}

__host__ inline int num_chunks(int rows, int cols) {
  const int per = chunk_cols(rows, cols);
  return (cols + per - 1) / per;
}

// Dynamic shared memory of one CTA: the C (BN, dc), Q1 and Q2 (BN, s), R
// (BM, d|1), P1 and P2 (BM, s|1) tiles, or the reduction buffer
// (BM, dc|1), which reuses them, if that is larger.
__host__ inline size_t rff_bwd_smem_bytes(int dc, int d, int s) {
  const size_t tiles = (size_t)BN * dc + 2 * BN * s + BM * (d | 1) + 2 * BM * (s | 1);
  const size_t reduce = (size_t)BM * (dc | 1);
  return sizeof(float) * (tiles > reduce ? tiles : reduce);
}

template <int DC>
__global__ void __launch_bounds__(NTHREADS)
rff_bwd_kernel(const float* __restrict__ r, const float* __restrict__ c,
               const float* __restrict__ p1, const float* __restrict__ p2,
               const float* __restrict__ q1, const float* __restrict__ q2,
               float* __restrict__ dst, int rows, int cols, int d, int s,
               int cols_per_chunk, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  static_assert(DC % 4 == 0, "C rows are read as float4");
  const int dp = d | 1;  // odd strides: each lane reads its own row
  const int sp = s | 1;
  float* cs = smem;            // (BN, DC), first: 16-byte aligned rows
  float* q1s = cs + BN * DC;   // (BN, s), read as broadcasts
  float* q2s = q1s + BN * s;   // (BN, s)
  float* rs = q2s + BN * s;    // (BM, dp)
  float* p1s = rs + BM * dp;   // (BM, sp)
  float* p2s = p1s + BM * sp;  // (BM, sp)

  const int rr = threadIdx.x % BM;
  const int g = threadIdx.x / BM;
  const int row0 = blockIdx.x * BM;
  const int j_begin = blockIdx.y * cols_per_chunk;
  const int j_end = min(cols, j_begin + cols_per_chunk);

  // columns d..DC of the C tile stay 0 for the whole loop: they pad the
  // unrolled W C update
  for (int i = threadIdx.x; i < BN * DC; i += NTHREADS) cs[i] = 0.0f;
  load_rows(rs, r, row0, BM, rows, d, dp);
  load_rows(p1s, p1, row0, BM, rows, s, sp);
  load_rows(p2s, p2, row0, BM, rows, s, sp);

  float acc[DC];
#pragma unroll
  for (int k = 0; k < DC; ++k) acc[k] = 0.0f;

  const float* rrow = rs + rr * dp;
  const float* p1r = p1s + rr * sp;
  const float* p2r = p2s + rr * sp;
  for (int j0 = j_begin; j0 < j_end; j0 += BN) {
    __syncthreads();  // the previous tile is consumed (and the zero fill done)
    load_rows(cs, c, j0, BN, j_end, d, DC);  // zero past the chunk
    load_rows(q1s, q1, j0, BN, j_end, s, s);
    load_rows(q2s, q2, j0, BN, j_end, s, s);
    __syncthreads();
    for (int jj = g; jj < BN; jj += KSPLIT) {
      const float* cr = cs + jj * DC;
      // rff_matvec.cu's order: proj = fma(x_k, omega_k, proj), k ascending
      // (fmaf's product is exact, so the domega orientation's swapped
      // operands give the same angle)
      float proj = 0.0f;
      for (int k = 0; k < d; ++k) proj = fmaf(rrow[k], cr[k], proj);
      const float* a1 = q1s + jj * s;
      const float* a2 = q2s + jj * s;
      float a = 0.0f, b = 0.0f;
      for (int cc = 0; cc < s; ++cc) {
        a = fmaf(p1r[cc], a1[cc], a);
        b = fmaf(p2r[cc], a2[cc], b);
      }
      float sn, cn;
      sincosf(proj, &sn, &cn);
      const float w = cn * a - sn * b;
#pragma unroll
      for (int k = 0; k < DC; k += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(cr + k);
        acc[k] = fmaf(w, c4.x, acc[k]);
        acc[k + 1] = fmaf(w, c4.y, acc[k + 1]);
        acc[k + 2] = fmaf(w, c4.z, acc[k + 2]);
        acc[k + 3] = fmaf(w, c4.w, acc[k + 3]);
      }
    }
  }
  __syncthreads();  // every tile read: the reduction may reuse the buffer
  reduce_rows<DC>(acc, smem);
  if (threadIdx.x < BM && row0 + rr < rows) {
    float* o = dst + ((size_t)blockIdx.y * rows + row0 + rr) * d;
#pragma unroll
    for (int k = 0; k < DC; ++k)
      if (k < d) o[k] = scale * acc[k];
  }
}

// out[i] = scale * sum_c partial[c, i] (c in order).
__global__ void __launch_bounds__(kReduceThreads)
rff_bwd_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                      int chunks, size_t total, float scale) {
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * total + i];
  out[i] = scale * acc;
}

template <int DC>
cudaError_t launch(const float* r, const float* c, const float* p1,
                   const float* p2, const float* q1, const float* q2,
                   float* workspace, float* out, int rows, int cols, int d,
                   int s, float scale, cudaStream_t stream) {
  const size_t bytes = rff_bwd_smem_bytes(DC, d, s);
  auto kernel = rff_bwd_kernel<DC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int per = chunk_cols(rows, cols);
  const int chunks = (cols + per - 1) / per;
  const dim3 grid((rows + BM - 1) / BM, chunks);
  // one chunk writes the scaled result; several write partials
  kernel<<<grid, NTHREADS, bytes, stream>>>(
      r, c, p1, p2, q1, q2, chunks == 1 ? out : workspace, rows, cols, d, s,
      per, chunks == 1 ? scale : 1.0f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || chunks == 1) return err;
  const size_t total = (size_t)rows * d;
  const unsigned blocks = (unsigned)((total + kReduceThreads - 1) / kReduceThreads);
  rff_bwd_reduce_kernel<<<blocks, kReduceThreads, 0, stream>>>(
      workspace, out, chunks, total, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Floats of the partial-sum workspace of repro_rff_bwd_f32 at these sizes:
// (chunks, rows, d), or 0 when one chunk covers the columns.
extern "C" long long repro_rff_bwd_workspace_floats(int rows, int cols, int d) {
  const int chunks = repro_torch::num_chunks(rows, cols);
  return chunks > 1 ? (long long)chunks * rows * d : 0;
}

// r (rows, d), c (cols, d), p1, p2 (rows, s), q1, q2 (cols, s) -> out
// (rows, d) = scale * (cos(r c^T) * p1 q1^T - sin(r c^T) * p2 q2^T) @ c;
// workspace of repro_rff_bwd_workspace_floats(rows, cols, d) floats. All
// float32, row-major, contiguous, on the current device. Requires rows,
// cols >= 1, 1 <= s <= 128 and 1 <= d <= 128. One launch on `stream`, two
// when the columns take several chunks; returns the first CUDA error (0 on
// success).
extern "C" int repro_rff_bwd_f32(const float* r, const float* c,
                                 const float* p1, const float* p2,
                                 const float* q1, const float* q2,
                                 float* workspace, float* out, int rows,
                                 int cols, int d, int s, float scale,
                                 void* stream) {
  using namespace repro_torch;
  if (rows < 1 || cols < 1 || s < 1 || s > kMaxS || d < 1 || d > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (pick_dc(d)) {
    case 4: return (int)launch<4>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s, scale, st);
    case 8: return (int)launch<8>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s, scale, st);
    case 12: return (int)launch<12>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s, scale, st);
    case 16: return (int)launch<16>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s, scale, st);
    case 32: return (int)launch<32>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s, scale, st);
    case 64: return (int)launch<64>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s, scale, st);
    default:
      return (int)launch<kMaxDim>(r, c, p1, p2, q1, q2, workspace, out, rows, cols, d, s, scale, st);
  }
}

// Dynamic shared memory per CTA of a launch with these d and s, in bytes.
extern "C" int repro_rff_bwd_smem_bytes(int d, int s) {
  return (int)repro_torch::rff_bwd_smem_bytes(repro_torch::pick_dc(d), d, s);
}
