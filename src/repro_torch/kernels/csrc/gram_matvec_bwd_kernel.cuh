// The backward kernel of the fused Gram matvec, at either tile precision:
// BF16 = false is gram_matvec_bwd.cu's fp32 kernel, BF16 = true
// gram_matvec_bwd_bf16.cu's bf16 tiles. Each source instantiates its own
// precision and holds its entry points, so the two build in parallel; every
// BF16 branch is an if constexpr, so the fp32 instances hold no bf16 code
// and keep their bits (scripts/fp32_bits.py).
//
// It computes the input cotangent of v -> K~(x, z) @ v,
//
//   dx(n, d) = 2 (x * sum_j W - W @ z),
//   W_ij = k'(d2_ij) * mask_ij * (rowv_i . colv_j),
//
// with rowv = g-bar (n, s) and colv = v (m, s); called with (z, x, colv, rowv)
// it gives dz. k' is dk/d(d2) at the unit-signal, already lengthscale-scaled
// inputs, and the mask, built from the raw d2 before its clamp, is the
// reference's: Matern-1/2 drops coincident pairs (k' ~ 1/r there), the other
// kinds weigh them 1/2 (autodiff's convention for max(d2, 0) at 0).
//
// Replaces: src/repro/kernels/gram_matvec.py, gram_matvec_bwd_pallas
// (_gram_matvec_bwd_kernel), reached through the VJP of gram_matvec_fused.
//
// What bounds it on an H100: operations, on three pipes. Per pair (i, j):
// (1) the FMA pipe carries the distance (d FMAs), k' and the mask; (2) the
// SFU its exp and, for Matern, its sqrt; (3) G = rowv . colv (2s flops) and
// the contraction [sum_j W | W z] = W [1 | z] (2(d + 1) flops), on the
// tensor cores or the FMA pipe. At training's 45,730^2, d = 9, s = 8 that is
// ~1.1e11 flops for 6 MB; at the Thompson ascent's 400 x 50,000, d = 8,
// s = 100, the G products dominate.
//
// What the design does about it. W never reaches device memory.
//
// * Few rows fill the card: the column loop is cut into chunks along grid.y
//   (the plan's, gram_bwd_plan in kernels/gram_matvec.py: at 400 rows, 7 row
//   blocks become 280 CTAs) and rowv/colv's columns into slices along
//   grid.z. Each (chunk, slice) writes [W z | sum_j W] of its rows to a
//   (parts, n, d + 1) workspace, and a second kernel adds them in a fixed
//   order (no float atomicAdd: every run gives the same bits) and applies
//   dx = 2 (x sum_j W - W z). With one part the CTA applies it itself.
// * Stage 1 on the CUDA cores, in registers: each thread owns a 4 x 4
//   micro-tile of (row, column) pairs laid out as the C fragments of
//   mma.m16n8k8 (rows g + 8h of two m-tiles, columns 2t + e of two n-tiles;
//   g = lane / 4, t = lane % 4). d2 keeps common.cuh's FMA chains bit for
//   bit: the norms and the dot in k order from 0, then fmaf(-2, dot, xn + zn),
//   so a point paired with itself gives raw d2 exactly 0, as in the forward,
//   and the mask's 1/2 and Matern-1/2's drop see it.
// * G = rowv . colv^T: for slices up to 16 columns, FMA chains in the same
//   micro-tile; wider, on the tensor cores in the three-way TF32 split
//   (gram_tile.cuh), the rowv tile split once per CTA and the colv tile once
//   as it lands, the products landing in the micro-tile's C layout.
// * W = k'(max(d2, 0)) mask G stays in registers. Stage 2, [W z | sum W]:
//   - on the tensor cores (S2TC): a thread's W entries of one n-tile are, in
//     order (h0 e0, h1 e0, h0 e1, h1 e1), an A fragment of m16n8k8 whose k
//     index runs over the columns 2t, 2t + 1 as t, t + 4; the B fragment
//     reads rows 2t and 2t + 1 of the split [z | 1] tile. So W is split in
//     registers and never staged;
//   - on the CUDA cores (the other variant): acc[row][k] += W z_k and
//     acc[row][d] += W in registers, the rows' partials added across the
//     four lanes by shuffles at the end.
//   The plan picks the variant (both are built; PERF.md has both times).
//   The micro-tile's G products and the tensor-core stage 2 are the tile
//   code this kernel shares with the RFF backward (rff_bwd.cu), in
//   gram_tile.cuh.
// * Copies: the next tile's z (and, for narrow slices, colv) by 4-byte
//   cp.async into the second of two buffers; for wide slices, colv's next
//   tile into a staging tile, 16 bytes at a time where its rows are one
//   contiguous run, as soon as the current one is split.
//
// The bf16 tiles (the reference's precision="bf16", _cast_mxu at
// gram_matvec.py:210-241): x and z are rounded to bf16 as stage 1 reads them,
// so d2 is the identity's fmaf chains over the rounded values (exact
// products, fp32 sums); rowv and colv are rounded into bf16 tiles and G runs
// as one mma.sync m16n8k16 a 16-deep k-step (the fp32 tiles take three
// m16n8k8 products a k-step of 8 in their TF32 split); W stays fp32 for
// sum_j W, summed in registers apart from the contraction (the fp32 kernel's
// [z | 1] tile would sum the rounded W), and is rounded in registers to the
// A fragment of W z, one m16n8k16 product against a transposed bf16 z tile
// (features by columns) for each 8 features. The flush 2 (x sum W - W z) uses
// the fp32 x. The mask, the clamp and the plan are the fp32 kernel's.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "gram_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kB = 64;          // rows of a CTA, and columns of a tile
constexpr int kThreads = kPairThreads;  // 8 warps: 2 row groups x 4 column groups
constexpr int kNarrowG = 16;    // slices this wide or less: G on the FMA pipe

// dk/d(d2) of gram_matvec.py:_dcov_map, with the same r = sqrt(d2 + 1e-36).
template <int KIND>
__device__ __forceinline__ float dcov_map(float d2) {
  if constexpr (KIND == kSE) {
    return -0.5f * expf(-0.5f * d2);
  } else {
    const float r = sqrtf(d2 + 1e-36f);
    if constexpr (KIND == kMatern12) {
      return -expf(-r) / (2.0f * r);
    } else if constexpr (KIND == kMatern32) {
      return -1.5f * expf(-kSqrt3 * r);
    } else {
      const float t = kSqrt5 * r;
      return -(5.0f / 6.0f) * (1.0f + t) * expf(-t);
    }
  }
}

// The pair's weight from its raw d2 (gram_matvec.py:221-229).
template <int KIND>
__device__ __forceinline__ float pair_mask(float raw) {
  if constexpr (KIND == kMatern12) {
    return raw > 0.0f ? 1.0f : 0.0f;
  } else {
    return raw > 0.0f ? 1.0f : (raw == 0.0f ? 0.5f : 0.0f);
  }
}

// Row stride of the rowv and colv tiles: K padded to k-steps plus 4 (an odd
// multiple of 4: the fragment reads (row g, column t) hit 32 banks) where G
// runs on the tensor cores, odd where it runs on the FMA pipe.
__host__ __device__ inline int rc_stride(int width) {
  return width > kNarrowG ? ((width + 7) & ~7) + 4 : (width | 1);
}

// Dynamic shared memory of one CTA in floats: x (64, d|1), two z tiles,
// rowv (its TF32 parts where G runs on the tensor cores), colv (two buffers,
// or a staging tile and its parts), and the split [z | 1] tile for S2TC.
//
// With bf16 tiles: x and two z tiles, the bf16 rowv and colv tiles, colv's
// fp32 staging tile, and the transposed bf16 z tile (8 n2 features).
template <bool BF16 = false>
__host__ __device__ inline size_t bwd_smem_floats(int d, int width, int n2) {
  const size_t dp = d | 1;
  if constexpr (BF16) {
    return 3 * kB * dp + 2 * kB * bf16_words(width) + kB * width + 8 * n2 * kTWords;
  } else {
    const size_t rs = rc_stride(width);
    const bool gtc = width > kNarrowG;
    return 3 * kB * dp + (gtc ? 4 : 3) * kB * rs + (gtc ? kB * width : 0) +
           2 * kB * (n2 > 0 ? contract_stride(n2) : 0);
  }
}

// One CTA: rows blockIdx.x * 64 + [0, 64), column chunk blockIdx.y of `chunk`
// columns (a multiple of 64), rowv/colv columns blockIdx.z * width + [0,
// width). GTC: G on the tensor cores. S2TC: stage 2 on the tensor cores with
// DW n-tiles of [z | 1]; otherwise on the FMA pipe with DW >= d accumulators.
// BF16 (with GTC and S2TC): bf16 tiles, W z with DW n-tiles of z.
template <int KIND, bool GTC, bool S2TC, int DW, bool BF16>
__global__ void __launch_bounds__(kThreads, BF16 ? (DW > 4 ? 1 : 2) : (GTC ? 1 : 2))
gram_bwd_kernel(const float* __restrict__ x, const float* __restrict__ z,
                const float* __restrict__ rowv, const float* __restrict__ colv,
                float* __restrict__ out, int n, int m, int d, int s, int width,
                int chunk) {
  static_assert(!BF16 || (GTC && S2TC), "bf16 tiles run both products on the tensor cores");
  constexpr int N2 = S2TC ? 8 * DW : 0;
  constexpr int ZS = contract_stride(DW);
  extern __shared__ float4 smem4[];
  const int dp = d | 1;
  const int rs = BF16 ? bf16_words(width) : rc_stride(width);
  float* xs = reinterpret_cast<float*>(smem4);  // (64, dp)
  float* zs = xs + kB * dp;                     // 2 x (64, dp)
  // fp32: rowv (or its hi and lo parts), colv (its parts, or two buffers),
  // colv's staging tile, the split [z | 1] tile; bf16: r16 and c16 (64, rs
  // words), colv's staging tile, the transposed z tile zt16 (8 DW, kTWords)
  float* rhi = zs + 2 * kB * dp;                // (64, rs): rowv, or its hi part
  float* rlo = rhi + kB * rs;                   // GTC: rowv's lo part
  float* chi = rlo + (GTC && !BF16 ? kB * rs : 0);  // colv's hi part, or buffer 0
  float* clo = chi + kB * rs;                   // colv's lo part, or buffer 1
  float* cst = BF16 ? clo : clo + kB * rs;      // GTC: colv staging (64, live)
  float* zhi = cst + (GTC ? kB * width : 0);    // S2TC: (64, ZS)
  float* zlo = zhi + kB * ZS;
  unsigned* r16 = reinterpret_cast<unsigned*>(rhi);
  unsigned* c16 = reinterpret_cast<unsigned*>(chi);
  unsigned* zt16 = reinterpret_cast<unsigned*>(zhi);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = (warp >> 2) * 32;  // rows rg + 16 (a >> 1) + g + 8 (a & 1)
  const int cb = (warp & 3) * 16;   // columns cb + 8 (b >> 1) + 2 t4 + (b & 1)
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
  const int j_end = min(m, j_begin + chunk);
  const int tiles = (j_end - j_begin + kB - 1) / kB;
  // elements e = tid + kThreads i of a (rows, w) tile sit at (e / w, e % w):
  // the per-tile loops below walk them by these steps, without a division
  const int zq = kThreads / d, zr = kThreads - zq * d;
  const int cq = kThreads / live, cr = kThreads - cq * live;
  const int kq = kThreads / kp, kr = kThreads - kq * kp;

  // Stationary: the x rows and the rowv slice (for GTC staged in chi and
  // split below), zero past n.
  for (int i = tid; i < kB * d; i += kThreads) {
    const int r = i / d, k = i - r * d;
    const bool ok = row0 + r < n;
    cp_async_f32(xs + r * dp + k, ok ? x + (size_t)(row0 + r) * d + k : x, ok);
  }
  float* rdst = BF16 ? cst : (GTC ? chi : rhi);
  const int rds = BF16 ? live : rs;  // bf16: staged dense
  for (int i = tid; i < kB * live; i += kThreads) {
    const int r = i / live, c = i - r * live;
    const bool ok = row0 + r < n;
    cp_async_f32(rdst + r * rds + c, ok ? rowv + (size_t)(row0 + r) * s + c0 + c : rowv, ok);
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if constexpr (BF16) {
    fill_bf16_rows(r16, cst, live, kB, live, kp, rs);
    __syncthreads();  // the staging tile is free for colv
  } else if constexpr (GTC) {
    for (int i = tid; i < kB * kp; i += kThreads) {
      const int r = i / kp, c = i - r * kp;
      float hi = 0.0f, lo = 0.0f;
      if (c < live) split_tf32(chi[r * rs + c], hi, lo);
      rhi[r * rs + c] = hi;
      rlo[r * rs + c] = lo;
    }
  }
  float xn[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    if constexpr (BF16) {  // the norm of the rounded row, sq_norm's chain
      xn[a] = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float v = tile_operand<BF16>(xs[R[a] * dp + k]);
        xn[a] = fmaf(v, v, xn[a]);
      }
    } else {
      xn[a] = sq_norm(xs + R[a] * dp, d);
    }
  }

  // Tile t's z rows (and, for narrow slices, its colv rows) into buffer buf,
  // zero past the chunk.
  auto prefetch = [&](int t, int buf) {
    const int j0 = j_begin + t * kB;
    float* zd = zs + buf * kB * dp;
    for (int j = tid / d, k = tid % d; j < kB;) {
      const bool ok = j0 + j < j_end;
      cp_async_f32(zd + j * dp + k, ok ? z + (size_t)(j0 + j) * d + k : z, ok);
      j += zq;
      k += zr;
      if (k >= d) {
        k -= d;
        ++j;
      }
    }
    if constexpr (!GTC) {
      float* cd = buf ? clo : chi;
      for (int j = tid / live, c = tid % live; j < kB;) {
        const bool ok = j0 + j < j_end;
        cp_async_f32(cd + j * rs + c, ok ? colv + (size_t)(j0 + j) * s + c0 + c : colv, ok);
        j += cq;
        c += cr;
        if (c >= live) {
          c -= live;
          ++j;
        }
      }
    }
    cp_async_commit();
  };
  // GTC: tile t's colv rows into the staging tile, dense (rows, live).
  auto prefetch_colv = [&](int t) {
    const int j0 = j_begin + t * kB;
    const int total = min(kB, j_end - j0) * live;
    const float* src = colv + (size_t)j0 * s + c0;
    if (live == s && (reinterpret_cast<size_t>(src) & 15) == 0) {
      for (int e = 4 * tid; e < total; e += 4 * kThreads)
        cp_async_16(cst + e, src + e, 4 * min(4, total - e));
    } else {
      for (int e = tid; e < total; e += kThreads) {
        const int j = e / live, c = e - j * live;
        cp_async_f32(cst + e, src + (size_t)j * s + c, true);
      }
    }
    cp_async_commit();
  };

  // stage 2's sums: S2TC, C fragments of rows rg + 16 mt + .. and [z | 1]
  // columns 8 n2 + ..; otherwise acc[a][k] of row R[a], k < d, and acc[a][DW]
  // = sum_j W
  constexpr int AN = S2TC ? 2 * DW * 4 : 4 * (DW + 1);
  float acc[AN];
#pragma unroll
  for (int i = 0; i < AN; ++i) acc[i] = 0.0f;
  // bf16: sum_j W of rows R[a], from the fp32 W
  float wsum[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  prefetch(0, 0);
  if constexpr (GTC) prefetch_colv(0);
  for (int t = 0; t < tiles; ++t) {
    const int rows = min(kB, j_end - (j_begin + t * kB));
    const float* zt = zs + (t & 1) * kB * dp;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the previous one is consumed
    if (t + 1 < tiles) prefetch(t + 1, (t + 1) & 1);
    if constexpr (BF16) {  // colv and z rounded to bf16; past the chunk 0
      fill_bf16_rows(c16, cst, live, rows, live, kp, rs);
      fill_bf16_transposed<DW>(zt16, zt, dp, d);
    } else if constexpr (GTC) {  // colv's split; columns past the chunk are 0
      for (int j = tid / kp, c = tid % kp; j < kB;) {
        float hi = 0.0f, lo = 0.0f;
        if (j < rows && c < live) split_tf32(cst[j * live + c], hi, lo);
        chi[j * rs + c] = hi;
        clo[j * rs + c] = lo;
        j += kq;
        c += kr;
        if (c >= kp) {
          c -= kp;
          ++j;
        }
      }
    }
    if constexpr (S2TC && !BF16) {  // [z | 1 | 0..], split
      for (int i = tid; i < kB * N2; i += kThreads) {
        const int j = i / N2, k = i - j * N2;
        const float v = k < d ? zt[j * dp + k] : (k == d ? 1.0f : 0.0f);
        split_tf32(v, zhi[j * ZS + k], zlo[j * ZS + k]);
      }
    }
    __syncthreads();  // the split tiles are written; the staging tile is free
    if constexpr (GTC) {
      if (t + 1 < tiles) prefetch_colv(t + 1);
    }

    // G in the C layout: w[mt][nt][e], row rg + 16 mt + g + 8 (e >> 1),
    // column cb + 8 nt + 2 t4 + (e & 1)
    float w[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) w[mt][nt][e] = 0.0f;
    if constexpr (BF16) {
      pair_product_bf16(w, r16, c16, rs, kp, rg, cb, g, t4);
    } else if constexpr (GTC) {
      pair_product_tc(w, rhi, rlo, chi, clo, rs, kp, rg, cb, g, t4);
    } else {
      pair_product_fma(w, rhi, (t & 1) ? clo : chi, rs, live, R, C);
    }

    // Stage 1: raw d2 of the micro-tile, common.cuh's chains, then W.
    {
      float dot[4][4], zn[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        zn[b] = 0.0f;
#pragma unroll
        for (int a = 0; a < 4; ++a) dot[a][b] = 0.0f;
      }
      for (int k = 0; k < d; ++k) {
        float xv[4], zv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          xv[a] = tile_operand<BF16>(xs[R[a] * dp + k]);
          zv[a] = tile_operand<BF16>(zt[C[a] * dp + k]);
          zn[a] = fmaf(zv[a], zv[a], zn[a]);
        }
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 4; ++b) dot[a][b] = fmaf(xv[a], zv[b], dot[a][b]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          // columns past the chunk: zero colv rows, so G = 0 and W = 0
          const float raw = fmaf(-2.0f, dot[a][b], xn[a] + zn[b]);
          float& wv = w[a >> 1][b >> 1][2 * (a & 1) + (b & 1)];
          wv = dcov_map<KIND>(fmaxf(raw, 0.0f)) * pair_mask<KIND>(raw) * wv;
          if constexpr (BF16) wsum[a] += wv;  // the fp32 W
        }
    }

    // Stage 2: [W z | sum_j W] of this tile's 16 columns of the warp (bf16:
    // W z alone).
    if constexpr (BF16) {
      pair_contract_bf16<DW>(acc, w, zt16, cb, g, t4);
    } else if constexpr (S2TC) {
      pair_contract_tc<DW>(acc, w, zhi, zlo, ZS, cb, g, t4);
    } else {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc[a * (DW + 1) + DW] += w[a >> 1][b >> 1][2 * (a & 1) + (b & 1)];
#pragma unroll
      for (int k = 0; k < DW; ++k) {
        if (k < d) {
          float zv[4];
#pragma unroll
          for (int b = 0; b < 4; ++b) zv[b] = zt[C[b] * dp + k];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
              acc[a * (DW + 1) + k] =
                  fmaf(w[a >> 1][b >> 1][2 * (a & 1) + (b & 1)], zv[b], acc[a * (DW + 1) + k]);
        }
      }
    }
  }

  // The four column groups' sums of each row, added in order through shared
  // memory (the z tiles, free once every tile is consumed): red (64, d + 1),
  // column d = sum_j W.
  const int rw = d + 1;
  float* red = zs;
  if constexpr (!S2TC) {  // first the four lanes t4 of each row
#pragma unroll
    for (int i = 0; i < AN; ++i) {
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 1);
      acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], 2);
    }
  }
  if constexpr (BF16) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      wsum[a] += __shfl_xor_sync(0xffffffffu, wsum[a], 1);
      wsum[a] += __shfl_xor_sync(0xffffffffu, wsum[a], 2);
    }
  }
  for (int grp = 0; grp < 4; ++grp) {
    __syncthreads();
    if ((warp & 3) != grp) continue;
    if constexpr (S2TC) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n2 = 0; n2 < DW; ++n2)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rg + 16 * mt + g + 8 * (e >> 1);
            const int k = 8 * n2 + 2 * t4 + (e & 1);
            if (k < (BF16 ? d : rw)) {
              const float v = acc[(mt * DW + n2) * 4 + e];
              red[r * rw + k] = grp == 0 ? v : red[r * rw + k] + v;
            }
          }
      if constexpr (BF16) {
        if (t4 == 0) {
#pragma unroll
          for (int a = 0; a < 4; ++a)
            red[R[a] * rw + d] = grp == 0 ? wsum[a] : red[R[a] * rw + d] + wsum[a];
        }
      }
    } else if (t4 == 0) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int k = 0; k <= DW; ++k) {
          const int kk = k == DW ? d : k;
          if (k == DW || k < d) {
            const float v = acc[a * (DW + 1) + k];
            red[R[a] * rw + kk] = grp == 0 ? v : red[R[a] * rw + kk] + v;
          }
        }
    }
  }
  __syncthreads();
  if (gridDim.y * gridDim.z == 1) {  // one part: dx here
    for (int i = tid; i < kB * d; i += kThreads) {
      const int r = i / d, k = i - r * d;
      if (row0 + r < n)
        out[(size_t)(row0 + r) * d + k] =
            2.0f * (xs[r * dp + k] * red[r * rw + d] - red[r * rw + k]);
    }
  } else {
    float* part = out + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * n * rw;
    for (int i = tid; i < kB * rw; i += kThreads) {
      const int r = i / rw;
      if (row0 + r < n) part[(size_t)row0 * rw + i] = red[i];
    }
  }
}

// A launch's operands and shape.
struct BwdArgs {
  const float *x, *z, *rowv, *colv;
  float* out;
  int n, m, d, s, width, chunk;
};

template <int KIND, bool GTC, bool S2TC, int DW, bool BF16>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * bwd_smem_floats<BF16>(a.d, a.width, S2TC ? DW : 0);
  auto kernel = gram_bwd_kernel<KIND, GTC, S2TC, DW, BF16>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.n + kB - 1) / kB, (a.m + a.chunk - 1) / a.chunk,
                  (a.s + a.width - 1) / a.width);
  kernel<<<grid, kThreads, bytes, stream>>>(a.x, a.z, a.rowv, a.colv, a.out, a.n, a.m,
                                            a.d, a.s, a.width, a.chunk);
  return cudaGetLastError();
}

// The [z | 1] n-tiles (S2TC) or accumulator width (FMA) of an fp32 instance.
__host__ inline int stage2_width(int d, bool s2tc) {
  if (s2tc) {
    const int n2 = (d + 1 + 7) / 8;
    return n2 <= 2 ? 2 : (n2 <= 5 ? 5 : 17);
  }
  return d <= 8 ? 8 : (d <= 12 ? 12 : (d <= 16 ? 16 : 0));
}

// The z n-tiles of a bf16 instance (W z alone: sum_j W is apart).
__host__ inline int stage2_width_bf16(int d) {
  const int n2 = (d + 7) / 8;
  return n2 <= 2 ? 2 : (n2 <= 4 ? 4 : 16);
}

template <int KIND, bool GTC>
cudaError_t dispatch_stage2(bool s2tc, const BwdArgs& a, cudaStream_t st) {
  switch (s2tc ? -stage2_width(a.d, true) : stage2_width(a.d, false)) {
    case -2: return launch<KIND, GTC, true, 2, false>(a, st);
    case -5: return launch<KIND, GTC, true, 5, false>(a, st);
    case -17: return launch<KIND, GTC, true, 17, false>(a, st);
    case 8: return launch<KIND, GTC, false, 8, false>(a, st);
    case 12: return launch<KIND, GTC, false, 12, false>(a, st);
    case 16: return launch<KIND, GTC, false, 16, false>(a, st);
    default: return cudaErrorInvalidValue;  // the FMA variant takes d <= 16
  }
}

// The fp32 instances: G on the tensor cores past kNarrowG columns, stage 2
// as asked. The bf16 instances: both products on the tensor cores.
template <int KIND, bool BF16>
cudaError_t dispatch_g(bool s2tc, const BwdArgs& a, cudaStream_t st) {
  if constexpr (BF16) {
    switch (stage2_width_bf16(a.d)) {
      case 2: return launch<KIND, true, true, 2, true>(a, st);
      case 4: return launch<KIND, true, true, 4, true>(a, st);
      default: return launch<KIND, true, true, 16, true>(a, st);
    }
  } else {
    if (a.width > kNarrowG) return dispatch_stage2<KIND, true>(s2tc, a, st);
    return dispatch_stage2<KIND, false>(s2tc, a, st);
  }
}

constexpr int kSumThreads = 256;

// dx[i, k] = 2 (x[i, k] S - T_k), S and T the (parts, n, d + 1) partials'
// sums over the parts, in order.
__global__ void __launch_bounds__(kSumThreads)
bwd_sum_kernel(const float* __restrict__ partial, const float* __restrict__ x,
               float* __restrict__ out, int parts, int n, int d) {
  const size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= (size_t)n * d) return;
  const size_t row = i / d, k = i - row * d, rw = d + 1;
  float sw = 0.0f, wz = 0.0f;
  for (int p = 0; p < parts; ++p) {
    const float* pr = partial + ((size_t)p * n + row) * rw;
    sw += pr[d];
    wz += pr[k];
  }
  out[i] = 2.0f * (x[i] * sw - wz);
}

// x (n, d), z (m, d), rowv (n, s), colv (m, s) -> out (n, d) at tile
// precision BF16; all float32, row-major, contiguous, on the current device.
// kind: 0 se, 1 matern12, 2 matern32, 3 matern52. The plan, from
// gram_bwd_plan: rowv/colv in slices of `width` columns (a multiple of 8),
// columns in chunks of `chunk` (a multiple of 64), for fp32 stage 2 on the
// tensor cores (stage2_tc) or the FMA pipe (d <= 16). With more than one
// (chunk, slice) part, workspace holds their (parts, n, d + 1) partial sums
// and a second launch adds them. Requires n, m, s >= 1 and 1 <= d <= 128.
// Returns the first CUDA error (0 on success).
template <bool BF16>
int gram_bwd(const float* x, const float* z, const float* rowv, const float* colv,
             float* workspace, float* out, int n, int m, int d, int s, int kind, int width,
             int chunk, bool stage2_tc, cudaStream_t st) {
  if (n < 1 || m < 1 || s < 1 || d < 1 || d > kMaxDim || width < 8 ||
      width % 8 != 0 || chunk < kB || chunk % kB != 0 ||
      (m + chunk - 1) / chunk > 65535 || (s + width - 1) / width > 65535)
    return (int)cudaErrorInvalidValue;
  const int parts = ((m + chunk - 1) / chunk) * ((s + width - 1) / width);
  const BwdArgs a{x, z, rowv, colv, parts == 1 ? out : workspace, n, m, d, s, width, chunk};
  cudaError_t err;
  switch (kind) {
    case kSE: err = dispatch_g<kSE, BF16>(stage2_tc, a, st); break;
    case kMatern12: err = dispatch_g<kMatern12, BF16>(stage2_tc, a, st); break;
    case kMatern32: err = dispatch_g<kMatern32, BF16>(stage2_tc, a, st); break;
    case kMatern52: err = dispatch_g<kMatern52, BF16>(stage2_tc, a, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || parts == 1) return (int)err;
  const size_t total = (size_t)n * d;
  bwd_sum_kernel<<<(unsigned)((total + kSumThreads - 1) / kSumThreads), kSumThreads, 0,
                   st>>>(workspace, x, out, parts, n, d);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch
