// The fused random-Fourier-feature matvec kernel, Phi~ = sqrt(1/m)
// [sin(x omega^T) | cos(x omega^T)] (n, 2m), sin features first, in both
// orientations (Phi~ W and Phi~^T u) and at either tile precision: BF16 =
// false is rff_matvec.cu's fp32 kernel, BF16 = true rff_matvec_bf16.cu's
// bf16 tiles. Each source instantiates its own precision (its entry points
// and its list of n-tile counts), so the two build in parallel; every BF16
// branch is an if constexpr, so the fp32 instances hold no bf16 code and
// keep their bits (scripts/fp32_bits.py).
//
// What bounds it on an H100: operations, on three pipes. Per (row,
// frequency) pair, (1) the FMA pipe carries the projection, d FMAs; (2) one
// full-range sincosf, whose range reduction and polynomials run on the FMA
// pipe too (projections reach tens of radians, where the fast intrinsics
// lose digits: no --use_fast_math); (3) the tensor cores carry the
// contraction with w or u, 2 x 2 s_pad flops, 3 x that in the three-way TF32
// split below, or once at the bf16 rate. At SGD's n = 45,730, m = 100,
// d = 9, s = 65, (1) + (2) are ~50 instructions a pair and (3) ~860 flops
// in fp32; the bytes, 4(nd + md + 2ms + ns) and the partial sums, are a few
// MB. In bf16 the sincosf dominates.
//
// What the design does about it. The Gram forward's structure
// (gram_matvec_kernel.cuh) with the covariance map replaced by sin/cos of
// the projection, in both orientations of one kernel template:
//
// * Phi~ W (TRANS = false): a CTA owns 64 data rows (M) and loops over
//   feature tiles of 32 frequencies (K = 64 features: the 32 sins, then the
//   32 cosines); the B tile is w's 32 sin rows and 32 cos rows.
//   Phi~^T u (TRANS = true): a CTA owns 32 frequencies, 64 features (M: in
//   each m-tile of 16, the sins of 8 frequencies, then their cosines) and
//   loops over tiles of 64 data rows (K); the B tile is u's 64 rows.
// * Stage 1, the features, on the CUDA cores in IEEE fp32: each thread
//   builds a micro-tile of 8 projections (4 rows x 2 frequencies, or 2 x 4)
//   in rff's FMA order (fmaf over k from 0, as the plain version's x omega^T
//   rounds once a term), one sincosf each, and stores sin and cos into the
//   feature tile P, split once there into TF32 high and low tiles (float4
//   stores, conflict-free). With bf16 tiles x and omega are rounded to bf16
//   as they are read (the projection is an fp32 sum of exact products), and
//   sin and cos, unscaled, are rounded into a bf16 P (row stride 72, 8-byte
//   stores of four features), zeroed once, so a 16-deep k-step that reaches
//   past a tile's live frequencies reads finite stale features against zero
//   B rows.
// * Stage 2, P B on the tensor cores: mma.sync m16n8k8, each operand split
//   into TF32 high and low parts and three products summed per k-step, added
//   to the fp32 accumulators by FADD (gram_tile.cuh). The split is safe
//   here: the phase-sensitive projection and sin/cos stay fp32, and only the
//   contraction's operands, features in [-1, 1] and w or u, are split (a
//   TF32 projection would lose three digits of phase; this one is not TF32).
//   The B tile is split once as it lands, P once as stage 1 writes it (four
//   column-group warps read each P entry). With bf16 tiles, B is rounded
//   once as it is transposed into a (columns, 72) bf16 tile, two k rows a
//   .b32, and each 16-deep k-step is one mma.sync m16n8k16 bf16 product,
//   added by FADD as the split's; sqrt(1/m) multiplies the sum.
// * Ragged edges cost no padded work: a frequency tile's k-steps (8 or 16
//   frequencies) and a frequency block's m-tiles past m are skipped, so
//   m = 100 runs as 104 frequencies, not 128; data rows past n are zero rows
//   of the B tile or are not stored.
// * Copies: the next tile's x or omega tile by 4-byte cp.async into the
//   second of two buffers, the next B tile by cp.async into a staging tile
//   as soon as the current one is split, before stage 1, 16 bytes at a time
//   where its rows are one contiguous run: each copy has a whole tile's
//   stages to land. Shared memory past 48 KB is opted in.
// * Few columns: with fewer n-tiles than the four column groups (s <= 16),
//   the idle groups take a share of the k-steps instead (KS ways), and
//   their sums are added in a fixed order once per CTA; three CTAs are
//   resident on an SM (two up to 72 columns, one above).
// * The card is filled by chunks of the K loop along grid.y (row chunks of
//   Phi~^T u: 4 frequency blocks at m = 100 would be 4 CTAs; frequency
//   chunks of Phi~ W at few rows), whose partial sums a second kernel adds
//   in a fixed order (no float atomicAdd, so every run gives the same bits);
//   that sum applies the m_true mask. s is sliced along grid.z at the plan's
//   width (at most 128 columns). The plan (width, chunk) is the caller's,
//   rff_plan in kernels/rff_matvec.py, which alone owns the geometry.
// * The pair keeps t in a (2m, s) device buffer between its phases: every
//   CTA of phase 2 needs all of it. Its second phase takes t as the first
//   writes it, scaled and masked, so with bf16 tiles it rounds the scaled t,
//   as rff_pair_pallas casts the scaled intermediate.
#pragma once

#include <cuda_runtime.h>

#include <math.h>

#include "gram_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kM = 64;               // output rows of a CTA (M)
constexpr int kK = 64;               // K per tile: data rows, or features
constexpr int kF = 32;               // frequencies of a feature tile or block
constexpr int kThreads = 256;        // 8 warps
constexpr int kPStride = kK + 4;     // A-fragment reads hit 32 banks
constexpr int kColGroups = 4;        // stage 2: 2 row groups x 4 column groups
constexpr int kMaxDim = 128;
constexpr int kWords = kBf16Stride / 2;  // .b32 words per bf16 tile row

// The instance of the list TILES that runs a slice of nt n-tiles (0: none).
template <int... TILES>
__host__ inline int tile_bucket(int nt) {
  constexpr int tiles[] = {TILES...};
  for (const int b : tiles)
    if (b >= nt) return b;
  return 0;
}

// Dynamic shared memory of one CTA: the stationary tile (64 x (d|1)), two
// streaming tiles (d x 64), then in fp32 P's TF32 parts, the B staging tile
// and its parts; in bf16 the fp32 B staging tile, the bf16 feature tile
// (64, 72) and the transposed bf16 B tile (8 nt, 72).
template <bool BF16>
__host__ inline size_t rff_smem_bytes(int d, int nt) {
  if constexpr (BF16) {
    const size_t floats = (size_t)kM * (d | 1) + 2 * d * kK + kK * 8 * nt;
    const size_t halves = (size_t)kM * kBf16Stride + (size_t)8 * nt * kBf16Stride;
    return sizeof(float) * floats + sizeof(unsigned short) * halves;
  } else {
    return sizeof(float) * ((size_t)kM * (d | 1) + 2 * d * kK + 2 * kM * kPStride +
                            kK * 8 * nt + 2 * kK * v_stride(8 * nt));
  }
}

// One CTA: output block blockIdx.x (64 data rows, or frequencies
// 32 bx + [0, 32)), K chunk blockIdx.y of `chunk` K items (frequencies, a
// multiple of 32, or data rows, a multiple of 64), column slice blockIdx.z of
// `width` columns. Writes scale * (its chunk's sum) to out + blockIdx.y *
// out_rows * s, out_rows = n (Phi~ W) or 2m (Phi~^T u: sin row f, cos row
// m + f).
template <bool TRANS, int NT, bool BF16>
__global__ void __launch_bounds__(kThreads, NT <= 2 ? 3 : NT <= 9 ? 2 : 1)
rff_kernel(const float* __restrict__ x, const float* __restrict__ omega,
           const float* __restrict__ bsrc, float* __restrict__ out, int n,
           int m, int d, int s, int width, int chunk, float scale) {
  constexpr int SW = 8 * NT;
  constexpr int VST = v_stride(SW);
  constexpr int Q = (NT + kColGroups - 1) / kColGroups;  // n-tiles per warp
  // with NT < 4, KS column groups share an n-tile, each a KS-th of the
  // k-steps
  constexpr int KS = (NT < kColGroups && kColGroups % NT == 0) ? kColGroups / NT : 1;
  constexpr int PS = BF16 ? kBf16Stride : kPStride;  // P's row stride
  constexpr int KD = BF16 ? 16 : 8;                   // depth of a k-step
  extern __shared__ float4 smem4[];
  const int dp = d | 1;
  float* sta = reinterpret_cast<float*>(smem4);  // x rows or omega rows: (rows, dp)
  float* stb = sta + kM * dp;                    // 2 x the streaming tile
  // fp32: phi, plo (kM, kPStride), bstage, bhi, blo (kK, VST); bf16: bstage,
  // P16 (kM, 72), bt32 (SW, 72): B^T in bf16
  float* phi = stb + 2 * d * kK;                 // (kM, kPStride): P's hi part
  float* plo = phi + kM * kPStride;              // and its lo part
  float* bstage = BF16 ? phi : plo + kM * kPStride;  // (kK, live), 16-byte aligned
  float* bhi = bstage + kK * SW;                 // (kK, VST)
  float* blo = bhi + kK * VST;
  unsigned short* P16 = reinterpret_cast<unsigned short*>(bstage + kK * SW);
  unsigned* P32 = reinterpret_cast<unsigned*>(P16);
  unsigned* bt32 = reinterpret_cast<unsigned*>(P16 + kM * kBf16Stride);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = (warp / kColGroups) * 32;  // stage 2: M rows rg + [0, 32)
  const int cg = (warp % kColGroups) / KS;  // and n-tiles cg + 4q, q < Q,
  const int kpart = (warp % kColGroups) % KS;  // k-steps kpart + KS i
  const bool has_last = cg + kColGroups * (Q - 1) < NT;
  const int c0 = blockIdx.z * width;
  const int live = min(width, s - c0);
  // the CTA's output block and K range
  const int m0 = blockIdx.x * (TRANS ? kF : kM);
  const int k_begin = blockIdx.y * chunk;
  const int k_end = min(TRANS ? n : m, k_begin + chunk);
  const int step = TRANS ? kK : kF;
  const int tiles = (k_end - k_begin + step - 1) / step;
  // live frequencies of the block (TRANS), for its m-tiles past m
  const int fl = TRANS ? min(kF, m - m0) : kF;
  // elements e = tid + kThreads i of a (rows, w) tile sit at (e / w, e % w):
  // the loops below walk them by these steps, without a division
  const int sq = kThreads / d, sr = kThreads - sq * d;
  const int bq = kThreads / live, br = kThreads - bq * live;

  // The stationary tile: omega rows m0.. (TRANS) or x rows m0.. (rows past
  // the edge zero-filled), row-major with the odd stride dp.
  {
    const int rows = TRANS ? kF : kM;
    const int total = TRANS ? m : n;
    const float* src = TRANS ? omega : x;
    for (int i = tid; i < rows * d; i += kThreads) {
      const int r = i / d, k = i - r * d;
      const bool ok = m0 + r < total;
      cp_async_f32(sta + r * dp + k, ok ? src + (size_t)(m0 + r) * d + k : src, ok);
    }
  }
  // The streaming tile of tile t, transposed: x rows (TRANS, (d, 64)) or
  // omega rows (!TRANS, (d, 32)), zero past the chunk.
  auto prefetch_stream = [&](int t, int buf) {
    const int j0 = k_begin + t * step;
    const float* src = TRANS ? x : omega;
    float* dst = stb + buf * d * kK;
    for (int r = tid / d, k = tid % d; r < step;) {
      const bool ok = j0 + r < k_end;
      cp_async_f32(dst + k * step + r, ok ? src + (size_t)(j0 + r) * d + k : src, ok);
      r += sq;
      k += sr;
      if (k >= d) {
        k -= d;
        ++r;
      }
    }
    cp_async_commit();
  };
  // The B tile of tile t into the staging tile, dense (rows, live): u rows
  // j0.. (TRANS), or w's sin rows f0.. at rows 0.. and cos rows m + f0.. at
  // rows 32.. (!TRANS). Rows past the chunk are left out.
  auto copy_rows = [&](float* dst, const float* src, int rows) {
    const int total = rows * live;
    if (live == s && (reinterpret_cast<size_t>(src) & 15) == 0) {
      for (int e = 4 * tid; e < total; e += 4 * kThreads)
        cp_async_16(dst + e, src + e, 4 * min(4, total - e));
    } else {
      for (int e = tid; e < total; e += kThreads) {
        const int r = e / live, c = e - r * live;
        cp_async_f32(dst + e, src + (size_t)r * s + c, true);
      }
    }
  };
  auto prefetch_b = [&](int t) {
    const int j0 = k_begin + t * step;
    const int rows = min(step, k_end - j0);
    copy_rows(bstage, bsrc + (size_t)j0 * s + c0, rows);
    if constexpr (!TRANS) {
      copy_rows(bstage + kF * live, bsrc + (size_t)(m + j0) * s + c0, rows);
    }
    cp_async_commit();
  };

  if constexpr (BF16) {
    // B^T's columns past `live` stay 0, and P starts finite
    for (int i = tid; i < SW * kWords; i += kThreads) bt32[i] = 0u;
    for (int i = tid; i < kM * kWords; i += kThreads) P32[i] = 0u;
  } else {
    for (int i = tid; i < 2 * kK * VST; i += kThreads) bhi[i] = 0.0f;
  }
  // four features into P at offset o (16-byte aligned in fp32, 8 in bf16):
  // split into P's TF32 parts, or rounded to bf16
  auto store4 = [&](int o, const float (&v)[4]) {
    if constexpr (BF16) {
      *reinterpret_cast<uint2*>(P16 + o) =
          make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
    } else {
      float hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_tf32(v[i], hi[i], lo[i]);
      *reinterpret_cast<float4*>(phi + o) = make_float4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<float4*>(plo + o) = make_float4(lo[0], lo[1], lo[2], lo[3]);
    }
  };
  float acc[2][Q][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.0f;

  prefetch_stream(0, 0);
  prefetch_b(0);
  for (int t = 0; t < tiles; ++t) {
    const int j0 = k_begin + t * step;
    const int rows = min(step, k_end - j0);  // live K items of the tile
    const float* st = stb + (t & 1) * d * kK;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the previous one is consumed
    if (t + 1 < tiles) prefetch_stream(t + 1, (t + 1) & 1);
    if constexpr (BF16) {
      // B rounded to bf16 and transposed, two k rows to a word; rows past
      // the chunk are 0
      for (int e = tid; e < (kK / 2) * live; e += kThreads) {
        const int c = e / (kK / 2), rp = e - c * (kK / 2);
        const int r = 2 * rp;
        const int item = TRANS ? r : (r & (kF - 1));  // data row or frequency
        const float lo = item < rows ? bstage[r * live + c] : 0.0f;
        const float hi = item + 1 < rows ? bstage[(r + 1) * live + c] : 0.0f;
        bt32[c * kWords + rp] = pack_bf16x2(lo, hi);
      }
    } else {
      // B's split, once per tile, from the staging tile; rows past the chunk
      // are 0 (so are the columns past `live`, never written)
      for (int r = tid / live, c = tid % live; r < kK;) {
        const int item = TRANS ? r : (r & (kF - 1));  // data row or frequency
        float hi = 0.0f, lo = 0.0f;
        if (item < rows) split_tf32(bstage[r * live + c], hi, lo);
        bhi[r * VST + c] = hi;
        blo[r * VST + c] = lo;
        r += bq;
        c += br;
        if (c >= live) {
          c -= live;
          ++r;
        }
      }
    }
    __syncthreads();  // the staging tile is read: the next B tile may land there
    if (t + 1 < tiles) prefetch_b(t + 1);

    // Stage 1: the tile's features into P, rff's FMA order, one sincosf per
    // projection.
    if constexpr (TRANS) {
      // thread: data rows 4 tx + [0, 4) (K), frequencies 2 ty, 2 ty + 1;
      // m-tiles past the block's live frequencies are never read
      const int tx = tid & 15, ty = tid >> 4;
      if (8 * (ty >> 2) < fl) {
        float pr[4][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i][0] = pr[i][1] = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float4 x4 = *reinterpret_cast<const float4*>(st + k * kK + 4 * tx);
          const float xv[4] = {tile_operand<BF16>(x4.x), tile_operand<BF16>(x4.y),
                               tile_operand<BF16>(x4.z), tile_operand<BF16>(x4.w)};
          const float o0 = tile_operand<BF16>(sta[(2 * ty) * dp + k]);
          const float o1 = tile_operand<BF16>(sta[(2 * ty + 1) * dp + k]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pr[i][0] = fmaf(xv[i], o0, pr[i][0]);
            pr[i][1] = fmaf(xv[i], o1, pr[i][1]);
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int f = 2 * ty + j;
          const int row = 16 * (f >> 3) + (f & 7);  // sin row; cos 8 below
          float sn[4], cs[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sincosf(pr[i][j], &sn[i], &cs[i]);
          store4(row * PS + 4 * tx, sn);
          store4((row + 8) * PS + 4 * tx, cs);
        }
      }
    } else {
      // thread: data rows 2 tr, 2 tr + 1 (M), frequencies 4 tf + [0, 4);
      // k-steps past the tile's live frequencies are never read
      const int tf = tid & 7, tr = tid >> 3;
      if (8 * (tf >> 1) < rows) {
        float pr[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) pr[i][j] = 0.0f;
        for (int k = 0; k < d; ++k) {
          const float4 o4 = *reinterpret_cast<const float4*>(st + k * kF + 4 * tf);
          const float ov[4] = {tile_operand<BF16>(o4.x), tile_operand<BF16>(o4.y),
                               tile_operand<BF16>(o4.z), tile_operand<BF16>(o4.w)};
          const float x0 = tile_operand<BF16>(sta[(2 * tr) * dp + k]);
          const float x1 = tile_operand<BF16>(sta[(2 * tr + 1) * dp + k]);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pr[0][j] = fmaf(x0, ov[j], pr[0][j]);
            pr[1][j] = fmaf(x1, ov[j], pr[1][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float sn[4], cs[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) sincosf(pr[i][j], &sn[j], &cs[j]);
          store4((2 * tr + i) * PS + 4 * tf, sn);
          store4((2 * tr + i) * PS + 4 * tf + kF, cs);
        }
      }
    }
    __syncthreads();  // P is written

    // Stage 2: acc += P B, the three-way split (or one bf16 product), one
    // k-step at a time, over the live k-steps only: data rows below `rows`
    // (TRANS), or frequencies below `rows` in each half (!TRANS, both halves
    // an iteration). The loops carry no branch, so neighbouring k-steps' MMA
    // chains interleave; a warp whose m-tiles all lie past the block's
    // frequencies (TRANS) skips stage 2, and one of its two m-tiles past them
    // runs on stale P rows and is never stored.
    if (cg < NT && (!TRANS || 8 * (rg >> 4) < fl)) {
      auto kstep = [&](int k0) {
        if constexpr (BF16) {
          unsigned bw[Q][2] = {};
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            if (q < Q - 1 || has_last) {
              const unsigned* bp =
                  bt32 + ((cg + kColGroups * q) * 8 + g) * kWords + k0 / 2 + t4;
              bw[q][0] = bp[0];
              bw[q][1] = bp[4];
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const unsigned* pr = P32 + (rg + 16 * mt + g) * kWords + k0 / 2 + t4;
            const unsigned a[4] = {pr[0], pr[8 * kWords], pr[4], pr[8 * kWords + 4]};
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (q < Q - 1 || has_last) {
                float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_bf16(f, a, bw[q]);
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[mt][q][e] += f[e];
              }
          }
        } else {
          float bh[Q][2] = {}, bl[Q][2] = {};
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            if (q < Q - 1 || has_last) {  // the last n-tile may lie past SW
              const int col = (cg + kColGroups * q) * 8 + g;
              const int r0 = (k0 + t4) * VST + col, r1 = r0 + 4 * VST;
              bh[q][0] = bhi[r0];
              bh[q][1] = bhi[r1];
              bl[q][0] = blo[r0];
              bl[q][1] = blo[r1];
            }
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int o = (rg + 16 * mt + g) * kPStride + k0 + t4;
            const float ahi[4] = {phi[o], phi[o + 8 * kPStride], phi[o + 4],
                                  phi[o + 8 * kPStride + 4]};
            const float alo[4] = {plo[o], plo[o + 8 * kPStride], plo[o + 4],
                                  plo[o + 8 * kPStride + 4]};
#pragma unroll
            for (int q = 0; q < Q; ++q)
              if (q < Q - 1 || has_last) mma_split_add(acc[mt][q], ahi, alo, bh[q], bl[q]);
          }
        }
      };
      const int ks = (rows + KD - 1) / KD;
      if constexpr (TRANS) {
#pragma unroll 2
        for (int kk = kpart; kk < ks; kk += KS) kstep(KD * kk);
      } else {
        for (int kk = kpart; kk < ks; kk += KS) {
          kstep(KD * kk);
          kstep(kF + KD * kk);
        }
      }
    }
  }

  if constexpr (KS > 1) {  // the KS k-step shares of each n-tile, in order
    __syncthreads();        // every tile is consumed: P is free
    float* red = BF16 ? reinterpret_cast<float*>(P16) : phi;  // (8 warps, 8 sums, 32 lanes)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) red[(warp * 8 + mt * 4 + e) * 32 + lane] = acc[mt][0][e];
    __syncthreads();
    if (kpart == 0) {
      for (int j = 1; j < KS; ++j)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][0][e] += red[((warp + j) * 8 + mt * 4 + e) * 32 + lane];
    }
  }

  // Store scale * acc: rows m0 + M-row (!TRANS), or sin row f / cos row
  // m + f of frequency f = m0 + 8 (M-row / 16) + M-row % 8 (TRANS).
  if (cg >= NT || kpart != 0) return;
  const int out_rows = TRANS ? 2 * m : n;
  float* o = out + (size_t)blockIdx.y * out_rows * s;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = (cg + kColGroups * q) * 8 + 2 * t4 + (e & 1);
        int r;
        if constexpr (TRANS) {
          const int f = m0 + 8 * ((rg >> 4) + mt) + g;
          r = f < m ? ((e >> 1) ? m + f : f) : out_rows;
        } else {
          r = m0 + rg + 16 * mt + g + 8 * (e >> 1);
        }
        if ((q < Q - 1 || has_last) && r < out_rows && c < live)
          o[(size_t)r * s + c0 + c] = scale * acc[mt][q][e];
      }
}

template <bool TRANS, int NT, bool BF16>
cudaError_t launch(const float* x, const float* omega, const float* b, float* out,
                   int n, int m, int d, int s, int width, int chunk, float scale,
                   cudaStream_t stream) {
  const size_t bytes = rff_smem_bytes<BF16>(d, NT);
  auto kernel = rff_kernel<TRANS, NT, BF16>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int blocks = TRANS ? (m + kF - 1) / kF : (n + kM - 1) / kM;
  const int chunks = ((TRANS ? n : m) + chunk - 1) / chunk;
  const dim3 grid(blocks, chunks, (s + width - 1) / width);
  kernel<<<grid, kThreads, bytes, stream>>>(x, omega, b, out, n, m, d, s, width,
                                            chunk, scale);
  return cudaGetLastError();
}

// launch<TRANS, B, BF16> for the first bucket B >= nt of the list NT, MORE...
template <bool TRANS, bool BF16, int NT, int... MORE>
cudaError_t dispatch_tiles(int nt, const float* x, const float* omega,
                           const float* b, float* out, int n, int m, int d,
                           int s, int width, int chunk, float scale,
                           cudaStream_t st) {
  if constexpr (sizeof...(MORE) > 0) {
    if (nt > NT)
      return dispatch_tiles<TRANS, BF16, MORE...>(nt, x, omega, b, out, n, m, d, s,
                                                  width, chunk, scale, st);
  }
  return launch<TRANS, NT, BF16>(x, omega, b, out, n, m, d, s, width, chunk, scale,
                                 st);
}

constexpr int kSumThreads = 256;

// out[i] = sum_c partial[c, i] (c in order), zero on the rows r with
// period > 0 and r % period >= keep. out may be partial itself.
__global__ void __launch_bounds__(kSumThreads)
rff_sum_kernel(const float* partial, float* out, int chunks, int rows, int s,
                 int period, int keep) {
  const size_t total = (size_t)rows * s;
  const size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * total + i];
  const int r = (int)(i / s);
  out[i] = (period == 0 || r % period < keep) ? acc : 0.0f;
}

cudaError_t rff_sum(const float* partial, float* out, int chunks, int rows,
                      int s, int period, int keep, cudaStream_t st) {
  const size_t total = (size_t)rows * s;
  const unsigned blocks = (unsigned)((total + kSumThreads - 1) / kSumThreads);
  rff_sum_kernel<<<blocks, kSumThreads, 0, st>>>(partial, out, chunks, rows,
                                                   s, period, keep);
  return cudaGetLastError();
}

float rff_scale(int m) { return sqrtf(1.0f / (float)m); }

// The three entry points at precision BF16 on the instances TILES.
template <bool BF16, int... TILES>
struct Rff {
  static bool valid(int n, int m, int d, int s, int width, int chunk, int unit) {
    constexpr int tiles[] = {TILES...};  // ascending: the last is the widest
    return n >= 1 && m >= 1 && s >= 1 && d >= 1 && d <= kMaxDim && width >= 8 &&
           width % 8 == 0 && width <= 8 * tiles[sizeof...(TILES) - 1] &&
           (s + width - 1) / width <= 65535 && chunk >= unit && chunk % unit == 0;
  }

  // Phi~ W: one launch into out where one chunk covers m, else the partials
  // into workspace and their sum into out.
  static cudaError_t matvec(const float* x, const float* omega, const float* w,
                            float* workspace, float* out, int n, int m, int d,
                            int s, int width, int chunk, cudaStream_t st) {
    const int chunks = (m + chunk - 1) / chunk;
    float* dst = chunks == 1 ? out : workspace;
    const cudaError_t err = dispatch_tiles<false, BF16, TILES...>(
        width / 8, x, omega, w, dst, n, m, d, s, width, chunk, rff_scale(m), st);
    if (err != cudaSuccess || chunks == 1) return err;
    return rff_sum(dst, out, chunks, n, s, 0, 0, st);
  }

  // Phi~^T u: the partials into workspace, then their masked sum into t.
  static cudaError_t t_matvec(const float* x, const float* omega, const float* u,
                              float* workspace, float* t, int n, int m, int d,
                              int s, int m_true, int width, int chunk,
                              cudaStream_t st) {
    const cudaError_t err = dispatch_tiles<true, BF16, TILES...>(
        width / 8, x, omega, u, workspace, n, m, d, s, width, chunk, rff_scale(m), st);
    if (err != cudaSuccess) return err;
    return rff_sum(workspace, t, (n + chunk - 1) / chunk, 2 * m, s, m, m_true, st);
  }

  // The entry points' checks and launches: repro_rff_matvec_f32's,
  // repro_rff_t_matvec_f32's and repro_rff_pair_f32's contracts (rff_matvec.cu).
  static int matvec_entry(const float* x, const float* omega, const float* w,
                          float* workspace, float* out, int n, int m, int d, int s,
                          int width, int freq_chunk, void* stream) {
    if (!valid(n, m, d, s, width, freq_chunk, kF)) return (int)cudaErrorInvalidValue;
    return (int)matvec(x, omega, w, workspace, out, n, m, d, s, width, freq_chunk,
                       static_cast<cudaStream_t>(stream));
  }
  static int t_matvec_entry(const float* x, const float* omega, const float* u,
                            float* workspace, float* t, int n, int m, int d, int s,
                            int m_true, int width, int row_chunk, void* stream) {
    if (!valid(n, m, d, s, width, row_chunk, kK) || m_true < 0 || m_true > m)
      return (int)cudaErrorInvalidValue;
    return (int)t_matvec(x, omega, u, workspace, t, n, m, d, s, m_true, width,
                         row_chunk, static_cast<cudaStream_t>(stream));
  }
  static int pair_entry(const float* x, const float* omega, const float* u,
                        float* workspace, float* t, float* out, int n, int m, int d,
                        int s, int m_true, int width, int row_chunk, int freq_chunk,
                        void* stream) {
    if (!valid(n, m, d, s, width, row_chunk, kK) ||
        !valid(n, m, d, s, width, freq_chunk, kF) || m_true < 0 || m_true > m)
      return (int)cudaErrorInvalidValue;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const cudaError_t err = t_matvec(x, omega, u, workspace, t, n, m, d, s, m_true,
                                     width, row_chunk, st);
    if (err != cudaSuccess) return (int)err;
    return (int)matvec(x, omega, t, workspace, out, n, m, d, s, width, freq_chunk, st);
  }
  // Dynamic shared memory per CTA of a launch with these d and slice width,
  // in bytes (0 for a width no instance takes); the same in both orientations.
  static int smem_bytes(int d, int width) {
    const int nt = tile_bucket<TILES...>((width + 7) / 8);
    return nt == 0 ? 0 : (int)rff_smem_bytes<BF16>(d, nt);
  }
};

}  // namespace
}  // namespace repro_torch
