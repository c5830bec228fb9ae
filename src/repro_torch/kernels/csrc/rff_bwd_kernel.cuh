// The backward kernel of the random-Fourier-feature matvecs, at either tile
// precision: BF16 = false is rff_bwd.cu's fp32 kernel, BF16 = true
// rff_bwd_bf16.cu's bf16 tiles. Each source instantiates its own precision
// and holds its entry points, so the two build in parallel; every BF16 branch
// is an if constexpr, so the fp32 instances keep their bits
// (scripts/fp32_bits.py).
//
// It computes the input cotangent of the projection proj = R C^T,
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
// What bounds it on an H100: operations, on three pipes. Per (row, column)
// pair: (1) the FMA pipe carries the projection (d FMAs), the full-range
// sincosf (its range reduction and polynomials: projections reach tens of
// radians, where the fast intrinsics lose digits, so no --use_fast_math) and
// W; (2) the two factor products A = P1 Q1^T and B = P2 Q2^T, 4s flops, on
// the tensor cores or the FMA pipe; (3) W C, 2d flops. The bytes are
// 4(rows d + cols d + 2 rows s + 2 cols s + rows d) and the partial sums: at
// protein's dx of the forward VJP (45,730 points, 1,024 frequencies, d = 9,
// s = 65) 1.4e10 flops for 25 MB, at the Thompson ascent's 400 x 512, d = 8,
// s = 100, 9e7 flops for 0.6 MB.
//
// What the design does about it: the Gram backward's (gram_matvec_bwd.cu),
// with the covariance derivative replaced by sin and cos of the projection,
// on the tile code the two share (gram_tile.cuh).
//
// * A CTA of 8 warps owns 64 output rows and a chunk of the columns, the
//   reduction axis (the Pallas grid's sequential one). Each thread owns a
//   4 x 4 micro-tile of pairs in the MMA C-fragment layout.
// * The factor products: for slices of at most 16 columns, FMA chains in
//   the micro-tile; wider, on the tensor cores in the three-way TF32 split,
//   the P1/P2 slice split once per CTA and the Q1/Q2 fragments as they are
//   read (a pass splitting each Q tile as it landed, between two barriers,
//   cost more than the products: one CTA fills an SM, so nothing overlaps
//   it), both products landing in the micro-tile's C layout. The projection
//   keeps the forward kernels' FMA order (fmaf over k from 0), so both
//   passes see the same angle, and W = cos A - sin B stays in registers.
// * W C on the tensor cores: W permuted in registers into A fragments
//   against the split C tile, two n-tiles of C up to d = 16, sixteen above.
//   (W C on the FMA pipe was no faster at any path shape: PERF.md §6.)
// * The plan (rff_bwd_plan in kernels/rff_matvec.py) owns the geometry: row
//   blocks along grid.x, column chunks by round_chunks along grid.y (few
//   output rows fill the card: the Thompson ascent's 7 row blocks run one
//   64-column tile a CTA), slices of P and Q along grid.z. Each (chunk,
//   slice) part writes its (rows, d) partial sums, and a second kernel adds
//   the parts in a fixed order and scales: no float atomicAdd, so every run
//   gives the same bits; a single part writes scale * dR itself.
// * Copies: the next tile's C, Q1 and Q2 by 4-byte cp.async into the second
//   of two buffers, in flight during the current tile. Ragged edges are zero
//   tiles: a zero Q row makes its pair's weight 0.
//
// The bf16 tiles (the reference's precision="bf16", _cast_mxu at
// rff_matvec.py:216-241): R and C are rounded to bf16 as the projection reads
// them (its fmaf chain over the rounded values; sin and cos stay fp32); P1,
// P2, Q1 and Q2 are rounded into bf16 tiles and A and B run as one mma.sync
// m16n8k16 a 16-deep k-step; W = cos A - sin B is computed in fp32, then
// rounded in registers to the A fragment of W C, one m16n8k16 product against
// a transposed bf16 C tile for each 8 features. The scale is applied in
// fp32 at the end, as the fp32 kernel's.
#pragma once

#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"
#include "gram_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kB = 64;                  // rows of a CTA, and columns of a tile
constexpr int kThreads = kPairThreads;  // 8 warps: 2 row groups x 4 column groups
constexpr int kSumThreads = 256;

// Row stride of the P and Q tiles: K padded to k-steps plus 4 where the
// products run on the tensor cores, odd where they run on the FMA pipe.
__host__ __device__ inline int pq_stride(int width, bool gtc) {
  return gtc ? ((width + 7) & ~7) + 4 : (width | 1);
}

// The n-tiles of C in W C at this d.
__host__ __device__ inline int stage2_width(int d) { return d <= 16 ? 2 : 16; }

// Dynamic shared memory of one CTA in floats: R (64, d|1) and two C tiles;
// P1, P2 (their TF32 parts where the products run on the tensor cores); two
// buffers each of Q1, Q2; the split C tile. With bf16 tiles: R and two C
// tiles, one fp32 staging buffer each of Q1 and Q2 (P staged there first),
// the bf16 P1, P2, Q1 and Q2 tiles, and the transposed bf16 C tile.
template <bool BF16 = false>
__host__ __device__ inline size_t bwd_smem_floats(int d, int width, bool gtc) {
  const size_t dp = d | 1, ps = pq_stride(width, gtc);
  if constexpr (BF16) {
    return 3 * kB * dp + 2 * kB * ps + 4 * kB * bf16_words(width) +
           8 * stage2_width(d) * kTWords;
  } else {
    return 3 * kB * dp + (gtc ? 8 : 6) * kB * ps + 2 * kB * contract_stride(stage2_width(d));
  }
}

// One CTA: rows blockIdx.x * 64 + [0, 64), column chunk blockIdx.y of
// `chunk` columns (a multiple of 64), P/Q columns blockIdx.z * width +
// [0, width). GTC: the factor products on the tensor cores. W C with DW
// n-tiles of C. BF16 (with GTC): bf16 tiles.
template <bool GTC, int DW, bool BF16>
__global__ void __launch_bounds__(kThreads, BF16 ? (DW > 2 ? 1 : 2) : (GTC ? 1 : 2))
rff_bwd_kernel(const float* __restrict__ r, const float* __restrict__ c,
               const float* __restrict__ p1, const float* __restrict__ p2,
               const float* __restrict__ q1, const float* __restrict__ q2,
               float* __restrict__ out, int rows, int cols, int d, int s, int width,
               int chunk, float scale) {
  static_assert(!BF16 || GTC, "bf16 tiles run the factor products on the tensor cores");
  constexpr int CS = contract_stride(DW);
  extern __shared__ float4 smem4[];
  const int dp = d | 1;
  const int ps = pq_stride(width, GTC);
  const int pw = bf16_words(width);  // bf16: words a row of the P and Q tiles
  float* rs = reinterpret_cast<float*>(smem4);  // (64, dp)
  float* cs = rs + kB * dp;                     // 2 x (64, dp)
  float* pt = cs + 2 * kB * dp;                 // P1, P2: raw, or hi, lo, hi, lo
  // Q1 buffers 0, 1, Q2 buffers 0, 1; bf16: Q1 and Q2 staged once each
  float* qt = pt + (BF16 ? 0 : (GTC ? 4 : 2) * kB * ps);
  float* chi = qt + (BF16 ? 2 : 4) * kB * ps;   // the split C tile
  float* clo = chi + kB * CS;
  // bf16: P1, P2, Q1, Q2 (64, pw words each), then C^T (8 DW, kTWords)
  unsigned* p16 = reinterpret_cast<unsigned*>(chi);
  unsigned* q16 = p16 + 2 * kB * pw;
  unsigned* ct16 = q16 + 2 * kB * pw;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = (warp >> 2) * 32;
  const int cb = (warp & 3) * 16;
  int R[4], C[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    R[a] = rg + 16 * (a >> 1) + g + 8 * (a & 1);
    C[a] = cb + 8 * (a >> 1) + 2 * t4 + (a & 1);
  }
  const int row0 = blockIdx.x * kB;
  const int c0 = blockIdx.z * width;
  const int live = min(width, s - c0);
  const int kp = BF16 ? (live + 15) & ~15 : (live + 7) & ~7;
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(cols, j_begin + chunk);
  const int tiles = (j_end - j_begin + kB - 1) / kB;
  const int cq = kThreads / d, cr = kThreads - cq * d;
  const int lq = kThreads / live, lr = kThreads - lq * live;

  // Stationary: the R rows and the P1, P2 slices (for GTC staged in the Q
  // buffers and split below), zero past rows.
  for (int i = tid; i < kB * d; i += kThreads) {
    const int rr = i / d, k = i - rr * d;
    const bool ok = row0 + rr < rows;
    cp_async_f32(rs + rr * dp + k, ok ? r + (size_t)(row0 + rr) * d + k : r, ok);
  }
  float* pdst[2] = {GTC ? qt : pt, GTC ? qt + (BF16 ? 1 : 2) * kB * ps : pt + kB * ps};
  const float* psrc[2] = {p1, p2};
  for (int f = 0; f < 2; ++f)
    for (int i = tid; i < kB * live; i += kThreads) {
      const int rr = i / live, cc = i - rr * live;
      const bool ok = row0 + rr < rows;
      cp_async_f32(pdst[f] + rr * ps + cc,
                   ok ? psrc[f] + (size_t)(row0 + rr) * s + c0 + cc : psrc[f], ok);
    }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if constexpr (BF16) {
    for (int f = 0; f < 2; ++f) fill_bf16_rows(p16 + f * kB * pw, pdst[f], ps, kB, live, kp, pw);
    __syncthreads();  // the staged P is rounded: the Q buffers are free
  } else if constexpr (GTC) {
    for (int f = 0; f < 2; ++f)
      for (int i = tid; i < kB * kp; i += kThreads) {
        const int rr = i / kp, cc = i - rr * kp;
        float hi = 0.0f, lo = 0.0f;
        if (cc < live) split_tf32(pdst[f][rr * ps + cc], hi, lo);
        pt[(2 * f) * kB * ps + rr * ps + cc] = hi;
        pt[(2 * f + 1) * kB * ps + rr * ps + cc] = lo;
      }
    __syncthreads();  // the staged P is split: the Q buffers are free
    // columns live..kp of the Q buffers stay 0 for the whole loop: they pad
    // the last k-step
    for (int i = tid; i < 4 * kB * (kp - live); i += kThreads) {
      const int tile = i / (kB * (kp - live)), e = i - tile * kB * (kp - live);
      const int j = e / (kp - live);
      qt[tile * kB * ps + j * ps + live + e - j * (kp - live)] = 0.0f;
    }
  }

  // Tile t's C rows into buffer buf (with `with_c`) and its Q1 and Q2 rows
  // (with `with_q`; fp32: into buffer buf, bf16: into the staging tiles),
  // zero past the chunk.
  auto prefetch = [&](int t, int buf, bool with_c, bool with_q) {
    const int j0 = j_begin + t * kB;
    float* cd = cs + buf * kB * dp;
    for (int j = tid / d, k = tid % d; with_c && j < kB;) {
      const bool ok = j0 + j < j_end;
      cp_async_f32(cd + j * dp + k, ok ? c + (size_t)(j0 + j) * d + k : c, ok);
      j += cq;
      k += cr;
      if (k >= d) {
        k -= d;
        ++j;
      }
    }
    if (with_q) {
      const float* qsrc[2] = {q1, q2};
      for (int f = 0; f < 2; ++f) {
        float* qd = qt + (BF16 ? f : 2 * f + buf) * kB * ps;
        for (int j = tid / live, cc = tid % live; j < kB;) {
          const bool ok = j0 + j < j_end;
          cp_async_f32(qd + j * ps + cc, ok ? qsrc[f] + (size_t)(j0 + j) * s + c0 + cc : qsrc[f],
                       ok);
          j += lq;
          cc += lr;
          if (cc >= live) {
            cc -= live;
            ++j;
          }
        }
      }
    }
    cp_async_commit();
  };
  // W C: C fragments of rows rg + 16 mt + .. and C columns 8 n + ..
  constexpr int AN = 2 * DW * 4;
  float acc[AN];
#pragma unroll
  for (int i = 0; i < AN; ++i) acc[i] = 0.0f;

  prefetch(0, 0, true, true);
  for (int t = 0; t < tiles; ++t) {
    const float* ct = cs + (t & 1) * kB * dp;
    const float* q1t = qt + (BF16 ? 0 : t & 1) * kB * ps;
    const float* q2t = qt + (BF16 ? 1 : 2 + (t & 1)) * kB * ps;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the previous one is consumed
    if (t + 1 < tiles) prefetch(t + 1, (t + 1) & 1, true, !BF16);
    if constexpr (BF16) {  // Q1, Q2 and C^T rounded to bf16
      const int rows = min(kB, j_end - (j_begin + t * kB));
      fill_bf16_rows(q16, q1t, ps, rows, live, kp, pw);
      fill_bf16_rows(q16 + kB * pw, q2t, ps, rows, live, kp, pw);
      fill_bf16_transposed<DW>(ct16, ct, dp, d);
      __syncthreads();  // the bf16 tiles are written; the Q staging tiles are free
      if (t + 1 < tiles) prefetch(t + 1, 0, false, true);  // the C tile went above
    } else {  // [C | 0..], split (read after the barrier below)
      for (int i = tid; i < kB * 8 * DW; i += kThreads) {
        const int j = i / (8 * DW), k = i - j * (8 * DW);
        split_tf32(k < d ? ct[j * dp + k] : 0.0f, chi[j * CS + k], clo[j * CS + k]);
      }
    }

    // A = P1 Q1^T and B = P2 Q2^T in the C layout
    float wa[2][2][4], wb[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) wa[mt][nt][e] = wb[mt][nt][e] = 0.0f;
    if constexpr (BF16) {
      pair_product_bf16(wa, p16, q16, pw, kp, rg, cb, g, t4);
      pair_product_bf16(wb, p16 + kB * pw, q16 + kB * pw, pw, kp, rg, cb, g, t4);
    } else if constexpr (GTC) {  // Q split as it is read
      pair_product_tc<true>(wa, pt, pt + kB * ps, q1t, nullptr, ps, kp, rg, cb, g, t4);
      pair_product_tc<true>(wb, pt + 2 * kB * ps, pt + 3 * kB * ps, q2t, nullptr, ps, kp, rg,
                            cb, g, t4);
    } else {
      pair_product_fma(wa, pt, q1t, ps, live, R, C);
      pair_product_fma(wb, pt + kB * ps, q2t, ps, live, R, C);
    }

    // The projection in the forward kernels' order (fmaf over k from 0; its
    // product is exact, so the domega orientation's swapped operands give the
    // same angle), then W = cos A - sin B into wa.
    {
      float proj[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) proj[a][b] = 0.0f;
      for (int k = 0; k < d; ++k) {
        float rv[4], cv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          rv[a] = tile_operand<BF16>(rs[R[a] * dp + k]);
          cv[a] = tile_operand<BF16>(ct[C[a] * dp + k]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) proj[a][b] = fmaf(rv[a], cv[b], proj[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          float sn, cn;
          sincosf(proj[a][b], &sn, &cn);
          float& wv = wa[a >> 1][b >> 1][2 * (a & 1) + (b & 1)];
          wv = cn * wv - sn * wb[a >> 1][b >> 1][2 * (a & 1) + (b & 1)];
        }
    }

    // W C over this tile's 16 columns of the warp.
    if constexpr (BF16) {
      pair_contract_bf16<DW>(acc, wa, ct16, cb, g, t4);
    } else {
      __syncthreads();  // the split C tile is written
      pair_contract_tc<DW>(acc, wa, chi, clo, CS, cb, g, t4);
    }
  }

  // The four column groups' sums of each row, added in order through shared
  // memory (the C tiles, free once every tile is consumed): red (64, d).
  float* red = cs;
  for (int grp = 0; grp < 4; ++grp) {
    __syncthreads();
    if ((warp & 3) != grp) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int n = 0; n < DW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = rg + 16 * mt + g + 8 * (e >> 1);
          const int k = 8 * n + 2 * t4 + (e & 1);
          if (k < d) {
            const float v = acc[(mt * DW + n) * 4 + e];
            red[rr * d + k] = grp == 0 ? v : red[rr * d + k] + v;
          }
        }
  }
  __syncthreads();
  const bool one_part = gridDim.y * gridDim.z == 1;
  float* dst = one_part ? out
                        : out + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * rows * d;
  for (int i = tid; i < kB * d; i += kThreads) {
    const int rr = i / d;
    if (row0 + rr < rows) dst[(size_t)row0 * d + i] = one_part ? scale * red[i] : red[i];
  }
}

// out[i] = scale * sum_p partial[p, i] (p in order).
__global__ void __launch_bounds__(kSumThreads)
rff_bwd_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, int parts,
                   size_t total, float scale) {
  const size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int p = 0; p < parts; ++p) acc += partial[(size_t)p * total + i];
  out[i] = scale * acc;
}

// A launch's operands and shape.
struct BwdArgs {
  const float *r, *c, *p1, *p2, *q1, *q2;
  float* out;
  int rows, cols, d, s, width, chunk;
  float scale;
};

template <bool GTC, int DW, bool BF16>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * bwd_smem_floats<BF16>(a.d, a.width, GTC);
  auto kernel = rff_bwd_kernel<GTC, DW, BF16>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.rows + kB - 1) / kB, (a.cols + a.chunk - 1) / a.chunk,
                  (a.s + a.width - 1) / a.width);
  kernel<<<grid, kThreads, bytes, stream>>>(a.r, a.c, a.p1, a.p2, a.q1, a.q2, a.out, a.rows,
                                            a.cols, a.d, a.s, a.width, a.chunk, a.scale);
  return cudaGetLastError();
}

template <bool GTC, bool BF16>
cudaError_t dispatch_stage2(const BwdArgs& a, cudaStream_t st) {
  return stage2_width(a.d) == 2 ? launch<GTC, 2, BF16>(a, st) : launch<GTC, 16, BF16>(a, st);
}

// r (rows, d), c (cols, d), p1, p2 (rows, s), q1, q2 (cols, s) -> out
// (rows, d) = scale * (cos(r c^T) * p1 q1^T - sin(r c^T) * p2 q2^T) @ c at
// tile precision BF16. All float32, row-major, contiguous, on the current
// device. The plan, from rff_bwd_plan: P and Q in slices of `width` columns
// (a multiple of 8), the columns in chunks of `chunk` (a multiple of 64), for
// fp32 the factor products on the tensor cores (products_tc) or the FMA pipe
// (bf16: always the tensor cores). With more than one (chunk, slice) part,
// workspace holds their (parts, rows, d) partial sums and a second launch
// adds them. Requires rows, cols, s >= 1 and 1 <= d <= 128. Returns the first
// CUDA error (0 on success).
template <bool BF16>
int rff_bwd(const float* r, const float* c, const float* p1, const float* p2,
            const float* q1, const float* q2, float* workspace, float* out, int rows,
            int cols, int d, int s, float scale, int width, int chunk, bool products_tc,
            cudaStream_t st) {
  if (rows < 1 || cols < 1 || s < 1 || d < 1 || d > kMaxDim || width < 8 ||
      width % 8 != 0 || chunk < kB || chunk % kB != 0 ||
      (cols + chunk - 1) / chunk > 65535 || (s + width - 1) / width > 65535)
    return (int)cudaErrorInvalidValue;
  const int parts = ((cols + chunk - 1) / chunk) * ((s + width - 1) / width);
  const BwdArgs a{r, c, p1, p2, q1, q2, parts == 1 ? out : workspace,
                  rows, cols, d, s, width, chunk, scale};
  cudaError_t err;
  if constexpr (BF16) {
    err = dispatch_stage2<true, true>(a, st);
  } else {
    err = products_tc ? dispatch_stage2<true, false>(a, st) : dispatch_stage2<false, false>(a, st);
  }
  if (err != cudaSuccess || parts == 1) return (int)err;
  const size_t total = (size_t)rows * d;
  rff_bwd_sum_kernel<<<(unsigned)((total + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
                       st>>>(workspace, out, parts, total, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch
