// The fused Gram matvec kernel, out(n, s) = K~(x, z) @ v(m, s), K~ the
// unit-signal stationary covariance of already lengthscale-scaled inputs, no
// jitter; with SCALED, gram_matvec_pallas's in-kernel signal and jitter,
// (signal K~ + jitter I) @ v (jitter only where z = x), on instances of their
// own (REPRO_GRAM_SCALED_TILE_BUCKETS), so the unscaled ones every path runs
// keep their code. At either tile precision: BF16 = false is gram_matvec.cu's fp32
// kernel, BF16 = true gram_matvec_bf16.cu's bf16 tiles. Each source
// instantiates its own precision (its entry points and its list of n-tile
// counts), so the two build in parallel; every BF16 branch is an
// if constexpr, so the fp32 instances hold no bf16 code and keep their bits
// (scripts/fp32_bits.py).
//
// The shape is flash attention's without the softmax: per (64-row, 64-column)
// tile, S = ||x||^2 + ||z||^2 - 2 X Z^T, P = cov(S), O += P V; K never reaches
// device memory.
//
// What bounds it on an H100: operations, on three pipes. Per kernel entry,
// (1) the FMA pipe carries the distance (d FMAs), the clamp and the
// covariance map's polynomial; (2) the SFU carries its exp and, for Matern,
// its sqrt (16 operations per clock per SM); (3) the tensor cores carry the
// contraction, 3 x 2 s_pad flops (s_pad = s rounded up to 8) in the three-way
// TF32 split below, or 2 s_pad at the bf16 rate. At d = 9 and s = 65, (3) is
// ~430 of the entry's flops in fp32 and (1) ~30 instructions; the
// shared-memory traffic that feeds (3), the P fragments and the split V
// tile, is of the same order as either, and with two CTAs (16 warps) on an
// SM the phases' latencies show too. In bf16, (2) is the floor.
//
// What the design does about it:
//
// * Stage 1, the distance on the CUDA cores, register-tiled and bit-exact.
//   Each of the 256 threads computes a 4 x 4 micro-tile of d^2 (rows 4ty..,
//   columns tx + 16j), so every x value it loads from shared memory (one
//   float4 broadcast per k) serves 4 entries and every z value 4 entries.
//   Each entry keeps common.cuh's arithmetic: sq_norm's fmaf chain in k
//   order from 0 for the norms and the dot, then fmaf(-2, dot, xn + zn), so
//   a point paired with itself gives d^2 exactly 0 and agrees bit for bit
//   with the backward (gram_matvec_bwd.cu). The norms are those same chains,
//   built by each thread from the loads of its own micro-tile, so no phase
//   waits on them. Clamp and cov_map follow in registers (with SCALED, then
//   the signal's product, before P is stored and, with bf16 tiles, rounded,
//   where gram_matvec_pallas scales its k tile). With bf16 tiles
//   the points are rounded to bf16 as they are read, and the norms and the
//   dot are these chains over the rounded values (exact products).
// * Stage 2, P V on the tensor cores at fp32 accuracy: mma.sync m16n8k8 with
//   TF32 operands and fp32 accumulation, each operand split a = a_hi + a_lo
//   (a_hi rounded to nearest TF32, a_lo = a - a_hi truncated to TF32) and
//   a_lo b_hi + a_hi b_lo + a_hi b_hi summed. The cancellation that rules
//   TF32 out of the reference's "fp32" lies wholly in stage 1, which stays
//   IEEE fp32; the split drops a_lo b_lo and a_lo's truncation, ~2^-21 of
//   each product. V is split once, when its tile lands, into high and low
//   tiles; P in registers, as each warp reads its A fragments. P is staged
//   in shared memory in fp32 (a high and a low tile would double the bytes
//   stage 2 reads, and two CTAs per SM would no longer fit at s = 100):
//   staged, each P entry is built once and a warp (2 m-tiles of 16 rows x
//   every 4th n-tile of 8 columns) shares each B fragment between two MMAs,
//   where a P kept in registers in the A-fragment layout would tie each warp
//   to all n-tiles of its rows (8 NT accumulators on top of P) or rebuild P
//   in every column group. The tensor cores sum one k-step's three products
//   only (their accumulation does not round to nearest: over a 715-tile loop
//   its bias exceeds the reference's 2e-4 tolerance, and over one tile it
//   still drifts the clipped SGD iterates off the plain route's); k-steps
//   and tiles are added by FADD, rounding to nearest. s is padded to a
//   multiple of 8 and sliced along grid.z (the plan's width, at most 128
//   columns). A slice of w columns runs the instance of the smallest n-tile
//   count in the source's list at or above w / 8, its extra n-tiles on zero
//   columns of V. Each tile is two phases between two barriers: stage 1 with
//   V's split, then stage 2.
//   With bf16 tiles, stage 1 stores P as bf16 (row stride 72 bf16: the
//   A-fragment reads, 32 bits at (row g, word t), hit 32 banks), V is rounded
//   once as it is transposed into a (columns, 72) bf16 tile, two k rows to a
//   .b32, so each B fragment is two 32-bit loads, and stage 2 is one
//   mma.sync m16n8k16 bf16 product a 16-deep k-step, added by FADD as the
//   split's. A column's result depends on its own P row and v column alone,
//   in a fixed order, so it is the same at every slice width.
// * Asynchronous tile loads: the (64, d) z tile of column tile j + 1 (and
//   the next row block's x) is issued with 4-byte cp.async into the second
//   of two buffers as tile j starts, and the (64, s) v tile of j + 1 into a
//   staging tile as soon as tile j's split has read it, so both land while
//   tile j computes. Where one slice covers s, v's tile is a contiguous run
//   of memory and is copied 16 bytes at a time (cp.async.cg): a quarter of
//   the copy instructions of 4-byte copies, whose issue competes with
//   stage 2's fragment loads for the load/store pipe. Ragged n, m and s
//   edges are zero-filled by the copies (src-size below the copy size) and
//   the split, not padded copies. Shared memory past 48 KB is opted in. With
//   up to 32 columns a CTA takes at most 80 registers, so three fit on an SM.
// * Few rows fill the card: grid.y cuts the column loop into chunks whose
//   (chunks, n, s) partial sums a second kernel adds in a fixed order (no
//   float atomicAdd, so every run gives the same bits). Many rows
//   against few columns (the SGD pair's g: 45,730 rows x 512 columns) run
//   several row blocks per CTA (rows_per_cta), the cp.async pipeline running
//   on across them, so no row block pays a CTA's prologue for an 8-tile
//   loop. The plan (width, chunk, rows_per_cta) is the caller's, gram_plan in
//   kernels/gram_matvec.py, which alone owns the tile geometry; gram_matvec
//   below runs it, chunk sum included.
// * The jitter (SCALED; z = x, m = n): row r's jitter v[r] is added once,
//   by the CTAs whose column chunk holds column r, to the sums they store;
//   the chunk sum then adds it with that chunk's partial.
#pragma once

#include <cuda_runtime.h>

#include "common.cuh"
#include "gram_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kBM = 64;                  // output rows per row block
constexpr int kBN = 64;                  // columns per tile
constexpr int kThreads = 256;            // 16 x 16 stage-1 threads, 8 warps
constexpr int kPStride = kBN + 4;        // A-fragment reads hit 32 banks
constexpr int kColGroups = 4;            // stage 2: 2 row groups x 4 column groups
constexpr int kWords = kBf16Stride / 2;  // .b32 words per bf16 tile row

// The covariance map of gram_matvec.py:_cov_map, with r = sqrt(d2 + 1e-36)
// exactly as there, so Matern stays finite at coincident points.
template <int KIND>
__device__ __forceinline__ float cov_map(float d2) {
  if constexpr (KIND == kSE) {
    return expf(-0.5f * d2);
  } else {
    const float r = sqrtf(d2 + 1e-36f);
    if constexpr (KIND == kMatern12) {
      return expf(-r);
    } else if constexpr (KIND == kMatern32) {
      const float t = kSqrt3 * r;
      return (1.0f + t) * expf(-t);
    } else {
      const float t = kSqrt5 * r;
      return (1.0f + t + t * t / 3.0f) * expf(-t);
    }
  }
}

// The n-tile counts of the scaled instances (gram_matvec_scaled, no path's
// launch), at each precision: a slice runs the smallest at or above its width
// (9: CG's s = 65 on a 9-tile instance, as unscaled; on the 16-tile one it
// took 26.2 ms against 15.2 at 45,730², fp32, on an H100 at 700 W).
#define REPRO_GRAM_SCALED_TILE_BUCKETS 1, 2, 4, 8, 9, 16

// The instance of the list TILES that runs a slice of nt n-tiles (0: none).
template <int... TILES>
__host__ inline int tile_bucket(int nt) {
  constexpr int tiles[] = {TILES...};
  for (const int b : tiles)
    if (b >= nt) return b;
  return 0;
}

// Dynamic shared memory of one CTA: xbufs transposed x blocks (d, 64), then
// in fp32 the P tile, v's staging tile and its TF32 high and low parts, and
// two z tiles with an odd row stride; in bf16 v's fp32 staging tile, the two
// z tiles, the bf16 k tile (64, 72) and the transposed bf16 v tile (8 nt, 72).
template <bool BF16>
__host__ inline size_t gram_smem_bytes(int d, int nt, int xbufs) {
  if constexpr (BF16) {
    const size_t floats = (size_t)xbufs * d * kBM + kBN * 8 * nt + 2 * kBN * (d | 1);
    const size_t halves = (size_t)kBM * kBf16Stride + (size_t)8 * nt * kBf16Stride;
    return sizeof(float) * floats + sizeof(unsigned short) * halves;
  } else {
    const size_t floats = (size_t)xbufs * d * kBM + kBM * kPStride +
                          kBN * 8 * nt + 2 * kBN * v_stride(8 * nt) +
                          2 * kBN * (d | 1);
    return sizeof(float) * floats;
  }
}

// One CTA: row blocks blockIdx.x * rpc + [0, rpc) of 64 rows, column slice
// blockIdx.z of `width` <= 8 NT columns, and column chunk blockIdx.y of
// `chunk` columns (a multiple of 64), whose partial sums go to
// out + blockIdx.y * n * s. One chunk of m columns is the matvec itself.
//
// Each iteration (one column tile of one row block) has two phases between
// two barriers: stage 1 with V's split (or rounding), then stage 2. The z
// and x copies of the next iteration are issued at its start, V's at the
// second barrier, once its staging tile has been read.
template <int KIND, int NT, bool BF16, bool SCALED>
__global__ void __launch_bounds__(kThreads, NT <= 4 ? 3 : 2)
gram_matvec_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ v, float* __restrict__ out,
                   int n, int m, int d, int s, int width, int chunk,
                   int rpc, float signal, float jitter) {
  constexpr int SW = 8 * NT;
  constexpr int VST = v_stride(SW);
  constexpr int Q = (NT + kColGroups - 1) / kColGroups;  // n-tiles per warp
  extern __shared__ float4 smem4[];
  const int dp = d | 1;
  float* xb = reinterpret_cast<float*>(smem4);  // (xbufs, d, kBM)
  float* tail = xb + (rpc > 1 ? 2 : 1) * d * kBM;
  // fp32: P (kBM, kPStride), vstage, vhi, vlo, zb; bf16: vstage, zb, then
  // P16 (kBM, 72) and vt32 (SW, 72): v^T in bf16
  float* P = tail;
  float* vstage = BF16 ? tail : P + kBM * kPStride;  // (kBN, live), 16-byte aligned
  float* vhi = vstage + kBN * SW;                     // (kBN, VST)
  float* vlo = vhi + kBN * VST;                       // (kBN, VST)
  float* zb = BF16 ? vstage + kBN * SW : vlo + kBN * VST;  // 2 x (kBN, dp)
  unsigned short* P16 = reinterpret_cast<unsigned short*>(zb + 2 * kBN * dp);
  const unsigned* P32 = reinterpret_cast<const unsigned*>(P16);
  unsigned* vt32 = reinterpret_cast<unsigned*>(P16 + kBM * kBf16Stride);

  const int tid = threadIdx.x;
  const int rb0 = blockIdx.x * rpc;
  const int nrb = min(rpc, (n + kBM - 1) / kBM - rb0);
  const int c0 = blockIdx.z * width;
  const int live = min(width, s - c0);
  const int j_begin = blockIdx.y * chunk;
  const int j_end = min(m, j_begin + chunk);
  const int tiles = (j_end - j_begin + kBN - 1) / kBN;
  // v's tiles are whole rows of v, contiguous in memory, where one slice
  // covers s: then they are copied 16 bytes at a time
  const bool vec = live == s && (reinterpret_cast<size_t>(v) & 15) == 0;
  // elements e = tid + kThreads r of a (rows, w) tile sit at (e / w, e % w);
  // the steps below walk them without a division
  const int zq = kThreads / d, zr = kThreads - zq * d;
  const int zj0 = tid / d, zk0 = tid - zj0 * d;
  const int vq = kThreads / live, vr = kThreads - vq * live;
  const int vj0 = tid / live, vc0 = tid - vj0 * live;

  // Issue the copies of (row block rb, tile t) but v's: its z tile and, at
  // the first tile of a row block, that block's x, transposed.
  auto prefetch_zx = [&](int rb, int t, int buf) {
    if (t == 0) {
      float* xd = xb + (rb & 1) * d * kBM;
      const int r0 = (rb0 + rb) * kBM;
      for (int i = tid; i < kBM * d; i += kThreads) {
        const int r = i / d;
        const int k = i - r * d;
        const bool ok = r0 + r < n;
        cp_async_f32(xd + k * kBM + r, ok ? x + (size_t)(r0 + r) * d + k : x, ok);
      }
    }
    const int j0 = j_begin + t * kBN;
    float* zd = zb + buf * kBN * dp;
    for (int jj = zj0, k = zk0; jj < kBN;) {
      const bool ok = j0 + jj < j_end;
      cp_async_f32(zd + jj * dp + k, ok ? z + (size_t)(j0 + jj) * d + k : z, ok);
      jj += zq;
      k += zr;
      if (k >= d) {
        k -= d;
        ++jj;
      }
    }
    cp_async_commit();
  };
  // Issue the copy of tile t's live v columns, rows past j_end left out, into
  // the staging tile as a dense (rows, live) array.
  auto prefetch_v = [&](int t) {
    const int j0 = j_begin + t * kBN;
    const int total = min(kBN, j_end - j0) * live;
    if (vec) {
      const float* src = v + (size_t)j0 * s;
      for (int e = 4 * tid; e < total; e += 4 * kThreads)
        cp_async_16(vstage + e, src + e, 4 * min(4, total - e));
    } else {
      for (int jj = vj0, c = vc0; jj * live + c < total;) {
        cp_async_f32(vstage + jj * live + c, v + (size_t)(j0 + jj) * s + c0 + c, true);
        jj += vq;
        c += vr;
        if (c >= live) {
          c -= live;
          ++jj;
        }
      }
    }
    cp_async_commit();
  };

  const int tx = tid & 15, ty = tid >> 4;  // stage 1: rows 4ty + i, columns tx + 16j
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rg = (warp / kColGroups) * 32;  // stage 2: rows rg + [0, 32)
  const int cg = warp % kColGroups;         // and n-tiles cg + 4q, q < Q
  // whether this warp's last n-tile exists (all but the last always do)
  const bool has_last = cg + kColGroups * (Q - 1) < NT;
  float* o = out + (size_t)blockIdx.y * n * s;

  // V's split parts (v^T in bf16): the columns past `live` (to SW) stay 0
  if constexpr (BF16) {
    for (int i = tid; i < SW * kWords; i += kThreads) vt32[i] = 0u;
  } else {
    for (int i = tid; i < 2 * kBN * VST; i += kThreads) vhi[i] = 0.0f;
  }
  float acc[2][Q][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][q][e] = 0.0f;
  float xn[4];

  prefetch_zx(0, 0, 0);
  prefetch_v(0);
  for (int rb = 0, t = 0, it = 0; rb < nrb; ++it) {
    const float* xt = xb + (rb & 1) * d * kBM;
    const float* zt = zb + (it & 1) * kBN * dp;
    const int rows = min(kBN, j_end - (j_begin + t * kBN));  // live v rows
    const bool last = t + 1 == tiles;
    const int rb_next = last ? rb + 1 : rb, t_next = last ? 0 : t + 1;
    cp_async_wait_all();
    __syncthreads();  // this tile has landed; the previous one is consumed
    if (rb_next < nrb) prefetch_zx(rb_next, t_next, (it + 1) & 1);

    // Stage 1: d^2 of the 4 x 4 micro-tile with the norms of its rows and
    // columns (sq_norm's FMA chains, built here from the same loads), then
    // P = cov(max(d^2, 0)).
    if (t == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i) xn[i] = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float4 x4 = *reinterpret_cast<const float4*>(xt + k * kBM + 4 * ty);
        const float xv[4] = {tile_operand<BF16>(x4.x), tile_operand<BF16>(x4.y),
                             tile_operand<BF16>(x4.z), tile_operand<BF16>(x4.w)};
#pragma unroll
        for (int i = 0; i < 4; ++i) xn[i] = fmaf(xv[i], xv[i], xn[i]);
      }
    }
    {
      float dacc[4][4], zn[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        zn[j] = 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) dacc[i][j] = 0.0f;
      }
#pragma unroll 3
      for (int k = 0; k < d; ++k) {
        const float4 x4 = *reinterpret_cast<const float4*>(xt + k * kBM + 4 * ty);
        const float xv[4] = {tile_operand<BF16>(x4.x), tile_operand<BF16>(x4.y),
                             tile_operand<BF16>(x4.z), tile_operand<BF16>(x4.w)};
        float zv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          zv[j] = tile_operand<BF16>(zt[(tx + 16 * j) * dp + k]);
          zn[j] = fmaf(zv[j], zv[j], zn[j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dacc[i][j] = fmaf(xv[i], zv[j], dacc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // columns past m are zero rows of z and v: a finite entry times 0
          const float d2 = fmaxf(fmaf(-2.0f, dacc[i][j], xn[i] + zn[j]), 0.0f);
          float k = cov_map<KIND>(d2);
          if constexpr (SCALED) k *= signal;
          if constexpr (BF16) {
            P16[(4 * ty + i) * kBf16Stride + tx + 16 * j] = bf16_bits(k);
          } else {
            P[(4 * ty + i) * kPStride + tx + 16 * j] = k;
          }
        }
    }
    if constexpr (BF16) {
      // v's tile rounded to bf16 and transposed, two k rows to a word; rows
      // past j_end are 0
      for (int e = tid; e < (kBN / 2) * live; e += kThreads) {
        const int c = e / (kBN / 2), jp = e - c * (kBN / 2);
        const int j = 2 * jp;
        const float lo = j < rows ? vstage[j * live + c] : 0.0f;
        const float hi = j + 1 < rows ? vstage[(j + 1) * live + c] : 0.0f;
        vt32[c * kWords + jp] = pack_bf16x2(lo, hi);
      }
    } else {
      // V's split, once per tile, from the staging tile; rows past j_end are 0
      for (int jj = vj0, c = vc0; jj < kBN;) {
        float hi = 0.0f, lo = 0.0f;
        if (jj < rows) split_tf32(vstage[jj * live + c], hi, lo);
        vhi[jj * VST + c] = hi;
        vlo[jj * VST + c] = lo;
        jj += vq;
        c += vr;
        if (c >= live) {
          c -= live;
          ++jj;
        }
      }
    }
    __syncthreads();  // P and V's parts are written; the staging tile is free
    if (rb_next < nrb) prefetch_v(t_next);

    // Stage 2: O += P V, three TF32 products per fragment pair (one bf16
    // product), summed by the tensor cores over one k-step only, then added
    // by FADD to the tile's sums and those to the row block's: the tensor
    // cores' fp32 accumulation does not round to nearest, and its bias grows
    // with the terms it sums.
    if (cg < NT) {  // warp-uniform: with NT < 4 some column groups idle
      float tacc[2][Q][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) tacc[mt][q][e] = 0.0f;
      if constexpr (BF16) {
#pragma unroll
        for (int k0 = 0; k0 < kBN; k0 += 16) {
          unsigned a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const unsigned* pr = P32 + (rg + 16 * mt + g) * kWords + k0 / 2 + t4;
            a[mt][0] = pr[0];
            a[mt][1] = pr[8 * kWords];
            a[mt][2] = pr[4];
            a[mt][3] = pr[8 * kWords + 4];
          }
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            if (q < Q - 1 || has_last) {
              const unsigned* br =
                  vt32 + ((cg + kColGroups * q) * 8 + g) * kWords + k0 / 2 + t4;
              const unsigned b[2] = {br[0], br[4]};
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_bf16(f, a[mt], b);
#pragma unroll
                for (int e = 0; e < 4; ++e) tacc[mt][q][e] += f[e];
              }
            }
          }
        }
      } else {
#pragma unroll(Q == 1 ? 8 : 4)  // fastest on the card at s = 9, 17, 65, 100
        for (int k0 = 0; k0 < kBN; k0 += 8) {
          float ahi[2][4], alo[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const float* pr = P + (rg + 16 * mt + g) * kPStride + k0 + t4;
            const float a[4] = {pr[0], pr[8 * kPStride], pr[4], pr[8 * kPStride + 4]};
#pragma unroll
            for (int e = 0; e < 4; ++e) split_tf32(a[e], ahi[mt][e], alo[mt][e]);
          }
#pragma unroll
          for (int q = 0; q < Q; ++q) {
            const int col = (cg + kColGroups * q) * 8 + g;
            if (q < Q - 1 || has_last) {
              const int r0 = (k0 + t4) * VST + col;
              const int r1 = r0 + 4 * VST;
              const float bhi[2] = {vhi[r0], vhi[r1]};
              const float blo[2] = {vlo[r0], vlo[r1]};
#pragma unroll
              for (int mt = 0; mt < 2; ++mt) {
                float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
                mma_tf32(f, alo[mt], bhi);
                mma_tf32(f, ahi[mt], blo);
                mma_tf32(f, ahi[mt], bhi);
#pragma unroll
                for (int e = 0; e < 4; ++e) tacc[mt][q][e] += f[e];
              }
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][q][e] += tacc[mt][q][e];
    }

    if (last) {  // the row block is done: store and restart
      const int row0 = (rb0 + rb) * kBM + rg;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int q = 0; q < Q; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = row0 + 16 * mt + g + 8 * (e >> 1);
            const int c = (cg + kColGroups * q) * 8 + 2 * t4 + (e & 1);
            if ((q < Q - 1 || has_last) && r < n && c < live) {
              float sum = acc[mt][q][e];
              // the diagonal entry (r, r) lies in this CTA's column chunk
              if constexpr (SCALED) {
                if (jitter != 0.0f && r >= j_begin && r < j_end)
                  sum += jitter * v[(size_t)r * s + c0 + c];
              }
              o[(size_t)r * s + c0 + c] = sum;
            }
            acc[mt][q][e] = 0.0f;
          }
    }
    rb = rb_next;
    t = t_next;
  }
}

template <int KIND, int NT, bool BF16, bool SCALED>
cudaError_t launch(const float* x, const float* z, const float* v, float* out,
                   int n, int m, int d, int s, int width, int chunk, int rpc,
                   float signal, float jitter, cudaStream_t stream) {
  const size_t bytes = gram_smem_bytes<BF16>(d, NT, rpc > 1 ? 2 : 1);
  auto kernel = gram_matvec_kernel<KIND, NT, BF16, SCALED>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const int row_blocks = (n + kBM - 1) / kBM;
  const dim3 grid((row_blocks + rpc - 1) / rpc, (m + chunk - 1) / chunk,
                  (s + width - 1) / width);
  kernel<<<grid, kThreads, bytes, stream>>>(x, z, v, out, n, m, d, s, width,
                                            chunk, rpc, signal, jitter);
  return cudaGetLastError();
}

// launch<KIND, B, BF16, SCALED> for the first bucket B >= nt of the list NT,
// MORE...
template <int KIND, bool BF16, bool SCALED, int NT, int... MORE>
cudaError_t dispatch_tiles(int nt, const float* x, const float* z,
                           const float* v, float* out, int n, int m, int d,
                           int s, int width, int chunk, int rpc, float signal,
                           float jitter, cudaStream_t st) {
  if constexpr (sizeof...(MORE) > 0) {
    if (nt > NT)
      return dispatch_tiles<KIND, BF16, SCALED, MORE...>(
          nt, x, z, v, out, n, m, d, s, width, chunk, rpc, signal, jitter, st);
  }
  return launch<KIND, NT, BF16, SCALED>(x, z, v, out, n, m, d, s, width, chunk,
                                        rpc, signal, jitter, st);
}

// The kernel at precision BF16 on the instances TILES, for the plan's width.
template <bool BF16, bool SCALED, int... TILES>
cudaError_t dispatch_kind(const float* x, const float* z, const float* v,
                          float* out, int n, int m, int d, int s, int kind,
                          int width, int chunk, int rpc, float signal,
                          float jitter, cudaStream_t st) {
  const int nt = width / 8;
  switch (kind) {
    case kSE:
      return dispatch_tiles<kSE, BF16, SCALED, TILES...>(nt, x, z, v, out, n, m, d, s,
                                                 width, chunk, rpc, signal,
                                                 jitter, st);
    case kMatern12:
      return dispatch_tiles<kMatern12, BF16, SCALED, TILES...>(nt, x, z, v, out, n, m, d,
                                                       s, width, chunk, rpc,
                                                       signal, jitter, st);
    case kMatern32:
      return dispatch_tiles<kMatern32, BF16, SCALED, TILES...>(nt, x, z, v, out, n, m, d,
                                                       s, width, chunk, rpc,
                                                       signal, jitter, st);
    case kMatern52:
      return dispatch_tiles<kMatern52, BF16, SCALED, TILES...>(nt, x, z, v, out, n, m, d,
                                                       s, width, chunk, rpc,
                                                       signal, jitter, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int... TILES>
bool valid_plan(int n, int m, int d, int s, int width, int chunk, int rpc) {
  constexpr int tiles[] = {TILES...};  // ascending: the last is the widest
  constexpr int max_tiles = tiles[sizeof...(TILES) - 1];
  return n >= 1 && m >= 1 && s >= 1 && d >= 1 && d <= kMaxDim && rpc >= 1 &&
         width >= 8 && width % 8 == 0 && width <= 8 * max_tiles &&
         (s + width - 1) / width <= 65535 && chunk >= kBN &&
         chunk % kBN == 0 && (m + chunk - 1) / chunk <= 65535;
}

constexpr int kSumThreads = 256;

// out[i] = sum_c partial[c, i] (c in order) - b[i], rows >= rows_true zeroed;
// out may be partial itself (one chunk: each thread reads its entry, then
// writes it).
__global__ void __launch_bounds__(kSumThreads)
chunk_sum_kernel(const float* partial, const float* __restrict__ b, float* out,
                 int chunks, int rows, int s, int rows_true) {
  const size_t total = (size_t)rows * s;
  const size_t i = (size_t)blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= total) return;
  float acc = 0.0f;
  for (int c = 0; c < chunks; ++c) acc += partial[(size_t)c * total + i];
  if (b != nullptr) acc -= b[i];
  out[i] = (int)(i / s) < rows_true ? acc : 0.0f;
}

int chunk_sum(const float* partial, const float* b, float* out, int chunks,
              int rows, int s, int rows_true, cudaStream_t stream) {
  const size_t total = (size_t)rows * s;
  const unsigned blocks = (unsigned)((total + kSumThreads - 1) / kSumThreads);
  chunk_sum_kernel<<<blocks, kSumThreads, 0, stream>>>(partial, b, out, chunks,
                                                       rows, s, rows_true);
  return (int)cudaGetLastError();
}

// out (n, s) = K~(x, z) @ v - b (with SCALED, (signal K~ + jitter I) @ v -
// b), rows >= rows_true zeroed (b may be null; 0 <= rows_true <= n; jitter
// only where z = x, so m = n), by the plan (width, chunk, rows_per_cta), at
// precision BF16 on the instances TILES. With one chunk (chunk >= m), no b and rows_true = n, one
// launch writes out; with one chunk otherwise, the chunk sum subtracts b and
// masks rows in place; with several, the kernel writes the (chunks, n, s)
// partials to `workspace` and the chunk sum adds them in a fixed order into
// out. Returns the first CUDA error (0 on success).
template <bool BF16, bool SCALED, int... TILES>
int gram_matvec(const float* x, const float* z, const float* v, const float* b,
                float* workspace, float* out, int n, int m, int d, int s, int kind,
                int rows_true, int width, int chunk, int rpc, cudaStream_t st,
                float signal = 1.0f, float jitter = 0.0f) {
  if (rows_true < 0 || rows_true > n || (jitter != 0.0f && m != n) ||
      !valid_plan<TILES...>(n, m, d, s, width, chunk, rpc))
    return (int)cudaErrorInvalidValue;
  const int chunks = chunk >= m ? 1 : (m + chunk - 1) / chunk;
  float* dst = chunks == 1 ? out : workspace;
  const int err = (int)dispatch_kind<BF16, SCALED, TILES...>(x, z, v, dst, n, m, d, s, kind,
                                                     width, chunk, rpc, signal,
                                                     jitter, st);
  if (err != 0 || (chunks == 1 && b == nullptr && rows_true == n)) return err;
  return chunk_sum(dst, b, out, chunks, n, s, rows_true, st);
}

}  // namespace
}  // namespace repro_torch
