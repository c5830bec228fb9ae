// The tile primitives of the tensor-core kernels (gram_matvec.cu,
// gram_matvec_bwd.cu, rff_matvec.cu): 4- and 16-byte cp.async with zero
// fill, the m16n8k8 TF32 tensor-core product with fp32 accumulation, and the
// three-way TF32 split of its operands.
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

// Row stride of a (K, 8 NT) B tile read as b[0] = B[t][g]: 8 mod 16 floats,
// so the B-fragment reads (row t, column g) of a warp hit 32 distinct banks.
__host__ __device__ constexpr int v_stride(int sw) {
  return sw + ((sw & 8) ? 16 : 8);
}

}  // namespace repro_torch
