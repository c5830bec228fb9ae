// Transposed random-Fourier-feature matvec and the feature pair:
//
//   repro_rff_t_matvec_f32:  t(2m, s) = sqrt(1/m) [sin(x omega^T) |
//                            cos(x omega^T)]^T @ u(n, s), sin rows first,
//                            rows of frequencies >= m_true zeroed;
//   repro_rff_pair_f32:      out(n, s) = Phi~ (Phi~^T u), the same masked t
//                            followed by rff_matvec.cu's kernel on it.
//
// Replaces: src/repro/kernels/rff_matvec.py, rff_t_matvec_pallas
// (_rff_t_kernel), and rff_pair_pallas (_rff_pair_kernel), reached through
// rff_t_matvec_fused and rff_pair_fused.
//
// What bounds it on an H100: operations. Each (row, frequency) pair costs 2d
// flops for the projection, one sincosf and 4s flops for the two
// contractions, against 4(nd + md + ns + 2ms) bytes plus the partial sums: at
// n = 45,730, m = 100, d = 9, s = 65 that is ~1.3e9 flops for ~0.02 GB. The
// pair does it twice. sincosf is the full-range libm version: projections
// reach tens of radians, where the fast intrinsics lose digits, so there is
// no --use_fast_math here.
//
// What the design does about it. The (n, 2m) feature matrix never reaches
// device memory. One CTA owns BF = 64 frequencies and one column slice, and
// loops over one chunk of the n rows (the reduction axis): per tile of BN = 64
// rows it computes the (64 rows x 64 frequencies) projections once (16 per
// thread, in rff_matvec.cu's FMA order), takes sincosf once for each, and
// stages both halves in shared memory; then thread (f, g) adds
// sin[row][f] * u[row][c] and cos[row][f] * u[row][c] over the tile's rows for
// its quarter of the columns, in registers. The sin/cos reads are
// conflict-free (one frequency per lane), the u reads broadcasts. The rows
// are split into chunks across CTAs so that even m = 100 (2 frequency blocks)
// fills the card; each chunk writes a (2m, s) partial block, and a second
// kernel adds the chunks in a fixed order, applies sqrt(1/m) and the m_true
// mask: deterministic, no float atomicAdd. The pair keeps t in a (2m, s)
// device buffer between its phases: 2m s 4 bytes (52 KB at m = 100, s = 65)
// would not fit one CTA's registers, and every CTA of phase 2 needs all of it.
#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"

extern "C" int repro_rff_matvec_f32(const float* x, const float* omega,
                                    const float* w, float* out, int n, int m,
                                    int d, int s, void* stream);

namespace repro_torch {
namespace {

constexpr int BF = 64;                     // frequencies per CTA
constexpr int kTargetCtas = 2 * 132;       // two waves of CTAs on 132 SMs
constexpr int kMinChunkRows = 4 * BN;      // rows per chunk, at least
constexpr int kReduceThreads = 256;

static_assert(BF * KSPLIT == NTHREADS, "one thread per (frequency, quarter)");
static_assert((BN * BF) % NTHREADS == 0, "projections split evenly");

// Accumulator widths: a multiple of KSPLIT, so each quarter is SC / KSPLIT.
__host__ inline int pick_sc_t(int s) {
  const int widths[] = {4, 8, 16, 24, 32, 48, 64, 72, 96, kMaxSC};
  for (int w : widths)
    if (s <= w) return w;
  return kMaxSC;
}

// Rows per chunk: enough chunks for kTargetCtas CTAs, each at least
// kMinChunkRows rows, a multiple of BN.
__host__ inline int chunk_rows(int n, int m, int s) {
  const int blocks = ((m + BF - 1) / BF) * ((s + pick_sc_t(s) - 1) / pick_sc_t(s));
  const int want = (kTargetCtas + blocks - 1) / blocks;
  int rows = (n + want - 1) / want;
  rows = ((rows + BN - 1) / BN) * BN;
  return rows < kMinChunkRows ? kMinChunkRows : rows;
}

__host__ inline int num_chunks(int n, int m, int s) {
  const int rows = chunk_rows(n, m, s);
  return (n + rows - 1) / rows;
}

// Dynamic shared memory of one CTA: the sin and cos tiles, the u tile, the x
// and omega tiles.
__host__ inline size_t rff_t_smem_bytes(int sc, int d) {
  return sizeof(float) *
         (size_t)(2 * BN * BF + BN * ((sc + 3) & ~3) + BN * (d | 1) + BF * (d | 1));
}

template <int SC>
__global__ void __launch_bounds__(NTHREADS)
rff_t_partial_kernel(const float* __restrict__ x,
                     const float* __restrict__ omega,
                     const float* __restrict__ u, float* __restrict__ partial,
                     int n, int m, int d, int s, int rows_per_chunk) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr int SCP = padded_width<SC>();
  constexpr int SQ = SC / KSPLIT;  // columns per thread
  const int dp = d | 1;            // odd stride: lanes read distinct rows
  float* us = smem;                // (BN, SCP), first: 16-byte aligned
  float* sn = us + BN * SCP;       // (BN, BF) sin of the projections
  float* cs = sn + BN * BF;        // (BN, BF) cos
  float* xs = cs + BN * BF;        // (BN, dp)
  float* os = xs + BN * dp;        // (BF, dp)

  const int f = threadIdx.x % BF;
  const int g = threadIdx.x / BF;
  const int f0 = blockIdx.x * BF;
  const int i_begin = blockIdx.y * rows_per_chunk;
  const int i_end = min(n, i_begin + rows_per_chunk);
  const int c0 = blockIdx.z * SC;
  const int live = min(SC, s - c0);

  load_rows(os, omega, f0, BF, m, d, dp);

  float acc_s[SQ], acc_c[SQ];
#pragma unroll
  for (int c = 0; c < SQ; ++c) acc_s[c] = acc_c[c] = 0.0f;

  for (int i0 = i_begin; i0 < i_end; i0 += BN) {
    __syncthreads();  // the previous tiles are consumed
    load_rows(xs, x, i0, BN, i_end, d, dp);
    load_w_tile<SC>(us, u, i0, i_end, s, c0, live);  // zero past the chunk
    __syncthreads();
    // the (BN, BF) projections of the tile, each once
    for (int e = threadIdx.x; e < BN * BF; e += NTHREADS) {
      const int rr = e / BF;
      const int ff = e - rr * BF;
      const float* xr = xs + rr * dp;
      const float* om = os + ff * dp;
      float proj = 0.0f;
      for (int k = 0; k < d; ++k) proj = fmaf(xr[k], om[k], proj);
      float a, b;
      sincosf(proj, &a, &b);
      sn[e] = a;
      cs[e] = b;
    }
    __syncthreads();
    const float* ur = us + g * SQ;
    for (int rr = 0; rr < BN; ++rr) {
      const float a = sn[rr * BF + f];
      const float b = cs[rr * BF + f];
#pragma unroll
      for (int c = 0; c < SQ; ++c) {
        const float uc = ur[rr * SCP + c];
        acc_s[c] = fmaf(a, uc, acc_s[c]);
        acc_c[c] = fmaf(b, uc, acc_c[c]);
      }
    }
  }
  if (f0 + f >= m) return;
  // partial (C, 2m, s): sin row f0 + f, cos row m + f0 + f
  float* ps = partial + ((size_t)blockIdx.y * 2 * m + f0 + f) * s + c0 + g * SQ;
  float* pc = ps + (size_t)m * s;
#pragma unroll
  for (int c = 0; c < SQ; ++c) {
    if (g * SQ + c < live) {
      ps[c] = acc_s[c];
      pc[c] = acc_c[c];
    }
  }
}

// t[i] = scale * sum_c partial[c, i] (c in order), zero on the rows of
// frequencies >= m_true.
__global__ void __launch_bounds__(kReduceThreads)
rff_t_reduce_kernel(const float* __restrict__ partial, float* __restrict__ t,
                    int chunks, int m, int s, int m_true, float scale) {
  const size_t total = (size_t)2 * m * s;
  const size_t i = (size_t)blockIdx.x * kReduceThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * total + i];
  t[i] = (int)(i / s) % m < m_true ? scale * acc : 0.0f;
}

template <int SC>
cudaError_t launch_partial(const float* x, const float* omega, const float* u,
                           float* partial, int n, int m, int d, int s,
                           cudaStream_t stream) {
  const size_t bytes = rff_t_smem_bytes(SC, d);
  auto kernel = rff_t_partial_kernel<SC>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int rows = chunk_rows(n, m, s);
  const dim3 grid((m + BF - 1) / BF, (n + rows - 1) / rows, (s + SC - 1) / SC);
  kernel<<<grid, NTHREADS, bytes, stream>>>(x, omega, u, partial, n, m, d, s,
                                            rows);
  return cudaGetLastError();
}

cudaError_t rff_t(const float* x, const float* omega, const float* u,
                  float* workspace, float* t, int n, int m, int d, int s,
                  int m_true, cudaStream_t st) {
  cudaError_t err;
  switch (pick_sc_t(s)) {
    case 4: err = launch_partial<4>(x, omega, u, workspace, n, m, d, s, st); break;
    case 8: err = launch_partial<8>(x, omega, u, workspace, n, m, d, s, st); break;
    case 16: err = launch_partial<16>(x, omega, u, workspace, n, m, d, s, st); break;
    case 24: err = launch_partial<24>(x, omega, u, workspace, n, m, d, s, st); break;
    case 32: err = launch_partial<32>(x, omega, u, workspace, n, m, d, s, st); break;
    case 48: err = launch_partial<48>(x, omega, u, workspace, n, m, d, s, st); break;
    case 64: err = launch_partial<64>(x, omega, u, workspace, n, m, d, s, st); break;
    case 72: err = launch_partial<72>(x, omega, u, workspace, n, m, d, s, st); break;
    case 96: err = launch_partial<96>(x, omega, u, workspace, n, m, d, s, st); break;
    default:
      err = launch_partial<kMaxSC>(x, omega, u, workspace, n, m, d, s, st);
  }
  if (err != cudaSuccess) return err;
  const size_t total = (size_t)2 * m * s;
  const unsigned blocks = (unsigned)((total + kReduceThreads - 1) / kReduceThreads);
  rff_t_reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(
      workspace, t, num_chunks(n, m, s), m, s, m_true, sqrtf(1.0f / (float)m));
  return cudaGetLastError();
}

bool bad_shape(int n, int m, int d, int s, int m_true) {
  return n < 1 || m < 1 || s < 1 || d < 1 || d > kMaxDim || m_true < 0 ||
         m_true > m;
}

}  // namespace
}  // namespace repro_torch

// Floats of the partial-sum workspace of the two entries below:
// (chunks, 2m, s).
extern "C" long long repro_rff_t_workspace_floats(int n, int m, int s) {
  return (long long)repro_torch::num_chunks(n, m, s) * 2 * m * s;
}

// x (n, d), omega (m, d), u (n, s) -> t (2m, s) = sqrt(1/m) [sin | cos]^T u,
// rows of frequencies >= m_true zeroed; workspace of
// repro_rff_t_workspace_floats(n, m, s) floats. All float32, row-major,
// contiguous, on the current device. Requires n, m, s >= 1, 1 <= d <= 128
// and 0 <= m_true <= m. Two launches on `stream`; returns the first CUDA
// error (0 on success).
extern "C" int repro_rff_t_matvec_f32(const float* x, const float* omega,
                                      const float* u, float* workspace,
                                      float* t, int n, int m, int d, int s,
                                      int m_true, void* stream) {
  using namespace repro_torch;
  if (bad_shape(n, m, d, s, m_true)) return (int)cudaErrorInvalidValue;
  return (int)rff_t(x, omega, u, workspace, t, n, m, d, s, m_true,
                    static_cast<cudaStream_t>(stream));
}

// x (n, d), omega (m, d), u (n, s) -> out (n, s) = Phi~ (Phi~^T u), Phi~ =
// sqrt(1/m) [sin | cos], the intermediate t (2m, s) masked to m_true as in
// repro_rff_t_matvec_f32; workspace as there, t a (2m, s) buffer. Three
// launches on `stream`, no host sync; returns the first CUDA error.
extern "C" int repro_rff_pair_f32(const float* x, const float* omega,
                                  const float* u, float* workspace, float* t,
                                  float* out, int n, int m, int d, int s,
                                  int m_true, void* stream) {
  using namespace repro_torch;
  if (bad_shape(n, m, d, s, m_true)) return (int)cudaErrorInvalidValue;
  const cudaError_t err = rff_t(x, omega, u, workspace, t, n, m, d, s, m_true,
                                static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return (int)err;
  return repro_rff_matvec_f32(x, omega, t, out, n, m, d, s, stream);
}

// Dynamic shared memory per CTA of the partial kernel at these d and s.
extern "C" int repro_rff_t_matvec_smem_bytes(int d, int s) {
  return (int)repro_torch::rff_t_smem_bytes(repro_torch::pick_sc_t(s), d);
}
