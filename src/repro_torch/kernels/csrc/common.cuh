// Shared constants and helpers of the fused kernels: the largest feature
// dimension, the stationary kinds, and the canonical FMA order of squared
// distances (gram_matvec.cu and gram_matvec_bwd.cu).
#pragma once

#include <cuda_runtime.h>

namespace repro_torch {

constexpr int kMaxDim = 128;  // largest feature dimension d

// Stationary kernel kinds, in the order of the wrappers' CUDA_KINDS.
enum Kind : int { kSE = 0, kMatern12 = 1, kMatern32 = 2, kMatern52 = 3 };

constexpr float kSqrt3 = 1.7320508075688772f;
constexpr float kSqrt5 = 2.23606797749979f;

// ||a||^2 of a d-vector: fmaf over k from 0. The Gram kernel and its
// backward build every norm and inner product x.z in this one FMA order and
// the raw squared distance as fmaf(-2, x.z, ||x||^2 + ||z||^2), so for a
// point paired with itself the norms and the dot agree bit for bit and the
// raw distance is exactly 0.
__device__ __forceinline__ float sq_norm(const float* __restrict__ a, int d) {
  float acc = 0.0f;
  for (int k = 0; k < d; ++k) acc = fmaf(a[k], a[k], acc);
  return acc;
}

}  // namespace repro_torch
