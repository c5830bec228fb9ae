// The tile primitives of the tensor-core kernels (gram_matvec_kernel.cuh,
// gram_matvec_bwd_kernel.cuh, rff_matvec_kernel.cuh, rff_bwd_kernel.cuh,
// flash_attention.cu): 4- and 16-byte cp.async with zero fill, the m16n8k8
// TF32 tensor-core product with fp32 accumulation, and the three-way TF32
// split of its operands; the m16n8k16 bf16 product with fp32 accumulation and
// the rounding to bf16; and the pair-weight tiles that the two backward
// kernels share: a factor product rowv . colv^T over a slice, into a
// micro-tile in the MMA C-fragment layout, and the weights contracted with a
// column tile on the tensor cores, each in the TF32 split (fp32 instances)
// and in bf16 (bf16 instances).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

// dst (shared) <- *src (global), asynchronously; writes 0 instead when !valid
// (src-size 0: nothing is read, src need only be a valid address).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr),
               "l"(src), "r"(valid ? 4 : 0));
}

// 16 bytes dst (shared) <- src (global), both 16-byte aligned, of which the
// first `bytes` (0 to 16) are read and the rest written as 0.
__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            int bytes) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until every cp.async this thread issued has landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until all but the N most recently committed groups have landed.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// c += a b for a 16x8 A, an 8x8 B and a 16x8 fp32 C, in the fragment layouts
// of mma.m16n8k8 (g = lane / 4, t = lane % 4):
//   a[0] A[g][t], a[1] A[g+8][t], a[2] A[g][t+4], a[3] A[g+8][t+4];
//   b[0] B[t][g], b[1] B[t+4][g];
//   c[e] C[g + 8 (e / 2)][2t + e % 2].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const float (&a)[4],
                                         const float (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(__float_as_uint(a[0])), "r"(__float_as_uint(a[1])),
        "r"(__float_as_uint(a[2])), "r"(__float_as_uint(a[3])),
        "r"(__float_as_uint(b[0])), "r"(__float_as_uint(b[1])));
}

// The TF32 split of one operand: hi = a rounded to TF32 (to nearest, ties
// away from 0: +half an ulp of TF32, then the low 13 bits cleared) and
// lo = a - hi, exact in fp32, then cleared to TF32 too (truncated). A product
// a b is then a_lo b_hi + a_hi b_lo + a_hi b_hi, three MMAs, which drops
// a_lo b_lo and a_lo's truncation, ~2^-21 of the product.
__device__ __forceinline__ void split_tf32(float a, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
  lo = __uint_as_float(__float_as_uint(a - hi) & 0xffffe000u);
}

// c += a b in the three-way split: the three products summed in f by the
// tensor cores, then added to c by FADD, rounding to nearest (the tensor
// cores' own accumulation does not, and its bias grows with the terms).
__device__ __forceinline__ void mma_split_add(float (&c)[4], const float (&ahi)[4],
                                              const float (&alo)[4],
                                              const float (&bhi)[2],
                                              const float (&blo)[2]) {
  float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  mma_tf32(f, alo, bhi);
  mma_tf32(f, ahi, blo);
  mma_tf32(f, ahi, bhi);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += f[e];
}

// Two floats rounded to bf16, to nearest even, packed into one .b32: lo in
// the low half (the lower column or k index of an MMA fragment), hi in the
// high half.
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// a rounded to bf16 (to nearest even), as the fp32 value it stands for.
__device__ __forceinline__ float round_bf16(float a) {
  return __uint_as_float(pack_bf16x2(a, 0.0f) << 16);
}

// The bf16 bits of a, rounded to nearest even.
__device__ __forceinline__ unsigned short bf16_bits(float a) {
  return static_cast<unsigned short>(pack_bf16x2(a, 0.0f) & 0xffffu);
}

// a as a contraction operand of a tile of precision BF16: rounded to bf16
// (to nearest even), or as it is.
template <bool BF16>
__device__ __forceinline__ float tile_operand(float a) {
  if constexpr (BF16) {
    return round_bf16(a);
  } else {
    return a;
  }
}

// c += a b for a 16x16 A, a 16x8 B (bf16) and a 16x8 fp32 C, in the
// fragment layouts of mma.m16n8k16 (g = lane / 4, t = lane % 4; each .b32
// holds two bf16, the lower k index in the low half):
//   a[0] A[g][2t..2t+1], a[1] A[g+8][2t..2t+1], a[2] A[g][2t+8..2t+9],
//   a[3] A[g+8][2t+8..2t+9];  b[0] B[2t..2t+1][g], b[1] B[2t+8..2t+9][g];
//   c as mma_tf32's. A product of two bf16 values is exact in fp32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Row stride, in bf16, of a bf16 tile whose rows are read by 32-bit fragment
// loads at (row g, word t): 64 + 8 bf16 = 36 words, 4 mod 32, so the reads of
// a warp hit 32 distinct banks.
constexpr int kBf16Stride = 72;

// Row stride of a (K, 8 NT) B tile read as b[0] = B[t][g]: 8 mod 16 floats,
// so the B-fragment reads (row t, column g) of a warp hit 32 distinct banks.
__host__ __device__ constexpr int v_stride(int sw) {
  return sw + ((sw & 8) ? 16 : 8);
}

// The backward kernels' CTA: 8 warps, 2 row groups x 4 column groups, over 64
// rows and a tile of 64 columns. Thread (g, t4) of a warp at rows rg and
// columns cb owns the micro-tile w[mt][nt][e] of row rg + 16 mt + g +
// 8 (e >> 1) and column cb + 8 nt + 2 t4 + (e & 1): the C fragments of two
// m-tiles by two n-tiles; R[a] = rg + 16 (a >> 1) + g + 8 (a & 1) and
// C[b] = cb + 8 (b >> 1) + 2 t4 + (b & 1) list its rows and columns, so w's
// entry (a, b) is w[a >> 1][b >> 1][2 (a & 1) + (b & 1)].
constexpr int kPairThreads = 256;

// w += rows . cols^T over kp columns (a multiple of 8) of a row tile split
// into TF32 parts and a column tile, split too (chi, clo) or, with RAW_B, raw
// in chi and split as it is read (clo unused), both at row stride `stride`:
// three-way split products on the tensor cores, in the C layout.
template <bool RAW_B = false>
__device__ __forceinline__ void pair_product_tc(float (&w)[2][2][4],
                                                const float* __restrict__ rhi,
                                                const float* __restrict__ rlo,
                                                const float* __restrict__ chi,
                                                const float* __restrict__ clo,
                                                int stride, int kp, int rg, int cb,
                                                int g, int t4) {
  for (int k0 = 0; k0 < kp; k0 += 8) {
    float ahi[2][4], alo[2][4], bhi[2][2], blo[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int o = (rg + 16 * mt + g) * stride + k0 + t4;
      const int oo[4] = {o, o + 8 * stride, o + 4, o + 8 * stride + 4};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ahi[mt][e] = rhi[oo[e]];
        alo[mt][e] = rlo[oo[e]];
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int o = (cb + 8 * nt + g) * stride + k0 + t4;
      if constexpr (RAW_B) {
        split_tf32(chi[o], bhi[nt][0], blo[nt][0]);
        split_tf32(chi[o + 4], bhi[nt][1], blo[nt][1]);
      } else {
        bhi[nt][0] = chi[o];
        bhi[nt][1] = chi[o + 4];
        blo[nt][0] = clo[o];
        blo[nt][1] = clo[o + 4];
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
        mma_split_add(w[mt][nt], ahi[mt], alo[mt], bhi[nt], blo[nt]);
  }
}

// w += rows . cols^T over `live` columns of raw tiles at row stride `stride`
// (odd: the lanes' rows hit distinct banks), FMA chains in column order.
__device__ __forceinline__ void pair_product_fma(float (&w)[2][2][4],
                                                 const float* __restrict__ rt,
                                                 const float* __restrict__ ct,
                                                 int stride, int live,
                                                 const int (&R)[4], const int (&C)[4]) {
  for (int c = 0; c < live; ++c) {
    float rv[4], qv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      rv[a] = rt[R[a] * stride + c];
      qv[a] = ct[C[a] * stride + c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        float& wv = w[a >> 1][b >> 1][2 * (a & 1) + (b & 1)];
        wv = fmaf(rv[a], qv[b], wv);
      }
  }
}

// acc[(mt N + n) 4 + e] += W B over the warp's 16 columns of the tile, W in
// the micro-tile w and B a split (64, 8 N) tile at row stride bs (an odd
// multiple of 4 when halved: the reads of rows 2 t4, 2 t4 + 1 hit 32 banks):
// a thread's W entries of one n-tile are, in the order (h0 e0, h1 e0, h0 e1,
// h1 e1), an A fragment whose k index t4, t4 + 4 stands for the columns
// 2 t4, 2 t4 + 1, so W is split in registers and never staged.
template <int N>
__device__ __forceinline__ void pair_contract_tc(float (&acc)[2 * N * 4],
                                                 const float (&w)[2][2][4],
                                                 const float* __restrict__ bhi,
                                                 const float* __restrict__ blo, int bs,
                                                 int cb, int g, int t4) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float a[4] = {w[mt][nt][0], w[mt][nt][2], w[mt][nt][1], w[mt][nt][3]};
      float ahi[4], alo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(a[e], ahi[e], alo[e]);
      const int jb = (cb + 8 * nt + 2 * t4) * bs + g;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const int o = jb + 8 * n;
        const float bh[2] = {bhi[o], bhi[o + bs]};
        const float bl[2] = {blo[o], blo[o + bs]};
        float* ap = acc + (mt * N + n) * 4;  // compile-time offsets
        float c[4] = {ap[0], ap[1], ap[2], ap[3]};
        mma_split_add(c, ahi, alo, bh, bl);
#pragma unroll
        for (int e = 0; e < 4; ++e) ap[e] = c[e];
      }
    }
}

// Row stride of a split (64, 8 n) B tile of pair_contract_tc.
__host__ __device__ constexpr int contract_stride(int n) { return 8 * n + 4; }

// The bf16 instances' tiles. A factor tile (64 rows by a slice of columns,
// padded with zeros to k-steps of 16) holds two bf16 of a row in a .b32
// word, the lower column in the low half, at a row stride of bf16_words
// words: kp16 / 2 + 4, which is 4 mod 8, so the fragment reads (row g, word
// t) of a warp hit 32 distinct banks.
__host__ __device__ inline int bf16_words(int width) { return ((width + 15) & ~15) / 2 + 4; }

// Row stride, in words, of a transposed column tile: one row a feature k,
// the tile's 64 columns two to a word (kBf16Stride bf16).
constexpr int kTWords = kBf16Stride / 2;

// dst (64 rows, `words` a row) <- src (rows x live fp32 at row stride ss),
// rounded to bf16; rows >= rows and columns >= live (up to kp16) are 0.
__device__ __forceinline__ void fill_bf16_rows(unsigned* __restrict__ dst,
                                               const float* __restrict__ src, int ss,
                                               int rows, int live, int kp16, int words) {
  const int wpr = kp16 / 2;
  for (int i = threadIdx.x; i < 64 * wpr; i += blockDim.x) {
    const int r = i / wpr, c = 2 * (i - r * wpr);
    const float lo = r < rows && c < live ? src[r * ss + c] : 0.0f;
    const float hi = r < rows && c + 1 < live ? src[r * ss + c + 1] : 0.0f;
    dst[r * words + c / 2] = pack_bf16x2(lo, hi);
  }
}

// dst (8 N rows of kTWords words) <- the (64, d) tile src at row stride sp,
// transposed and rounded to bf16: row k holds feature k of the 64 columns,
// two to a word; features k >= d are 0.
template <int N>
__device__ __forceinline__ void fill_bf16_transposed(unsigned* __restrict__ dst,
                                                     const float* __restrict__ src,
                                                     int sp, int d) {
  for (int i = threadIdx.x; i < 8 * N * 32; i += blockDim.x) {
    const int k = i >> 5, jp = i & 31;
    const float lo = k < d ? src[(2 * jp) * sp + k] : 0.0f;
    const float hi = k < d ? src[(2 * jp + 1) * sp + k] : 0.0f;
    dst[k * kTWords + jp] = pack_bf16x2(lo, hi);
  }
}

// w += rows . cols^T over kp16 columns (a multiple of 16) of two bf16 factor
// tiles at row stride `words`: one mma.sync m16n8k16 a k-step and fragment
// pair, its sum added to w by FADD, in the C layout of pair_product_tc.
__device__ __forceinline__ void pair_product_bf16(float (&w)[2][2][4],
                                                  const unsigned* __restrict__ rt,
                                                  const unsigned* __restrict__ ct,
                                                  int words, int kp16, int rg, int cb,
                                                  int g, int t4) {
  for (int k0 = 0; k0 < kp16; k0 += 16) {
    unsigned a[2][4], b[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const unsigned* pr = rt + (rg + 16 * mt + g) * words + k0 / 2 + t4;
      a[mt][0] = pr[0];
      a[mt][1] = pr[8 * words];
      a[mt][2] = pr[4];
      a[mt][3] = pr[8 * words + 4];
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const unsigned* pc = ct + (cb + 8 * nt + g) * words + k0 / 2 + t4;
      b[nt][0] = pc[0];
      b[nt][1] = pc[4];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(f, a[mt], b[nt]);
#pragma unroll
        for (int e = 0; e < 4; ++e) w[mt][nt][e] += f[e];
      }
  }
}

// acc[(mt N + n) 4 + e] += W B over the warp's 16 columns of the tile, W the
// micro-tile w rounded to bf16 and B a transposed bf16 column tile (N
// n-tiles of features): the warp's 16 columns are one k-step of m16n8k16,
// and a thread's W entries of n-tiles 0 and 1, row by row, are its A
// fragment (a[0] row g columns 2 t4, 2 t4 + 1 of n-tile 0, a[2] the same of
// n-tile 1, a[1] and a[3] row g + 8), so W is rounded in registers and never
// staged. Each product is added to acc by FADD.
template <int N>
__device__ __forceinline__ void pair_contract_bf16(float (&acc)[2 * N * 4],
                                                   const float (&w)[2][2][4],
                                                   const unsigned* __restrict__ bt,
                                                   int cb, int g, int t4) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const unsigned a[4] = {pack_bf16x2(w[mt][0][0], w[mt][0][1]),
                           pack_bf16x2(w[mt][0][2], w[mt][0][3]),
                           pack_bf16x2(w[mt][1][0], w[mt][1][1]),
                           pack_bf16x2(w[mt][1][2], w[mt][1][3])};
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const unsigned* pb = bt + (8 * n + g) * kTWords + cb / 2 + t4;
      const unsigned b[2] = {pb[0], pb[4]};
      float f[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(f, a, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[(mt * N + n) * 4 + e] += f[e];
    }
  }
}

}  // namespace repro_torch
