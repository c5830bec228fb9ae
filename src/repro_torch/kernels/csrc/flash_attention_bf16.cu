// Causal flash attention over bf16 (b, s, heads, d) tensors, grouped-query
// heads: flash_attention.cu's kernel for bf16 q, k and v.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// _flash_kernel) on bf16 inputs, with the head gather, transposes and padding
// of repro.kernels.ops.flash_attention, as flash_attention.cu does for fp32.
//
// The cast points are the TPU kernel's on bf16 inputs: the scores q k^T come
// from bf16 operands with fp32 accumulation (preferred_element_type), the
// running max m and normaliser l stay fp32 and l sums the unrounded p,
// p.astype(v.dtype) rounds p to bf16 for p v alone, the accumulator is fp32,
// and the output acc / max(l, 1e-30) is rounded to bf16 (o_ref's dtype).
//
// What bounds it on an H100: operations. Per visible (row, key) pair, 2d
// flops for q k^T and 2d for p v, at the bf16 tensor-core rate; at the
// serving path's b = 4, s = 1,024, 32 query heads, d = 128, 34 GFLOP (diagonal
// tiles whole) against 84 MB of operands: ~0.035 ms of tensor-core time, the
// exp of each score ~0.017 ms on the SFU, 0.025 ms of bytes.
//
// What the design does about it: flash_attention.cu's split of the work (a
// CTA of 4 warps per (batch x query head, 64 query rows), 16 rows a warp,
// the key axis a loop inside the CTA, fully masked tiles skipped, the
// longest causal rows first), with the products on mma.sync m16n8k16 bf16,
// one product a 16-deep k-step where the fp32 kernel runs three m16n8k8 in
// its TF32 split:
//
// * q, k and v land in bf16 tiles by 16-byte cp.async, zero-filled past s,
//   at a row stride of d + 8 bf16 (d / 2 + 4 words, 4 mod 8: the fragment
//   reads (row g, word t) of a warp hit 32 banks; 16-byte rows for ldmatrix).
//   V's copy is in flight during q k^T, the next tile's K during p v.
// * S = q k^T: q's A fragments and k's B fragments are 32-bit reads of two
//   adjacent features of a row; the tensor cores accumulate S over the d / 16
//   k-steps in fp32.
// * P never touches shared memory: the S accumulators of two 8-key n-tiles
//   are, row by row, the A fragment of one 16-key k-step of P V (a[0] row g
//   keys 2t, 2t + 1 of the first, a[2] of the second, a[1] and a[3] row
//   g + 8), so p is rounded to bf16 in registers, after l has summed it.
// * V's B fragments are read transposed by ldmatrix.trans (four 8 x 8
//   matrices: two k halves of two n-tiles). Each k-step's P V is added to the
//   fp32 accumulator by FADD, rounding to nearest.
#include <cuda_runtime.h>

#include "gram_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kBlock = 64;         // query rows per CTA, keys per tile
constexpr int kWarps = 4;          // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;  // the reference's mask value

// Row stride of the q, k and v tiles, in bf16.
template <int D>
__host__ __device__ constexpr int tile_stride() { return D + 8; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(unsigned short) * 3 * kBlock * tile_stride<D>();
}

// Rows [r0, r0 + kBlock) of head `head` of a (b, s, heads, D) bf16 tensor
// into a tile of row stride TS bf16 by 16-byte cp.async, rows past s
// zero-filled.
template <int D, int TS>
__device__ __forceinline__ void copy_tile(unsigned short* __restrict__ dst,
                                          const unsigned short* __restrict__ src, int batch,
                                          int r0, int s, int heads, int head) {
  constexpr int kVec = D / 8;  // 16-byte pieces a row
  for (int i = threadIdx.x; i < kBlock * kVec; i += kThreads) {
    const int r = i / kVec, c = i - r * kVec;
    const bool ok = r0 + r < s;
    cp_async_16(reinterpret_cast<float*>(dst + r * TS + 8 * c),
                reinterpret_cast<const float*>(
                    ok ? src + (((size_t)batch * s + r0 + r) * heads + head) * D + 8 * c : src),
                ok ? 16 : 0);
  }
}

// B fragments of two n-tiles (features n0 .. n0 + 15) for keys k0 .. k0 + 15
// of a row-major (keys, features) bf16 tile: four transposed 8 x 8 matrices,
// b0 the n-tile at n0, b1 at n0 + 8.
__device__ __forceinline__ void ldmatrix_v(unsigned (&b0)[2], unsigned (&b1)[2],
                                           const unsigned short* tile, int ts, int k0,
                                           int n0, int lane) {
  const unsigned short* p =
      tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ts + n0 + (lane >> 4) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
      : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_bf16_kernel(const unsigned short* __restrict__ q,
                            const unsigned short* __restrict__ k,
                            const unsigned short* __restrict__ v,
                            unsigned short* __restrict__ out, int s, int hq, int hkv,
                            int causal, float scale) {
  constexpr int TS = tile_stride<D>();
  constexpr int TW = TS / 2;  // words a tile row
  constexpr int NT = D / 8;   // n-tiles of p v
  extern __shared__ float4 smem4[];
  unsigned short* qt = reinterpret_cast<unsigned short*>(smem4);
  unsigned short* kt = qt + kBlock * TS;
  unsigned short* vt = kt + kBlock * TS;
  const unsigned* q32 = reinterpret_cast<const unsigned*>(qt);
  const unsigned* k32 = reinterpret_cast<const unsigned*>(kt);

  const int nq = (s + kBlock - 1) / kBlock;
  const int qb = nq - 1 - (int)blockIdx.y;  // longest causal rows first
  const int batch = blockIdx.x / hq;
  const int head = blockIdx.x - batch * hq;
  const int kv_head = head / (hq / hkv);
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;  // the warp's first row in the block
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  copy_tile<D, TS>(qt, q, batch, q0, s, hq, head);
  copy_tile<D, TS>(kt, k, batch, 0, s, hkv, kv_head);
  cp_async_commit();
  copy_tile<D, TS>(vt, v, batch, 0, s, hkv, kv_head);
  cp_async_commit();

  float o[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;

  const int ntiles = causal ? qb + 1 : nq;
  for (int kb = 0; kb < ntiles; ++kb) {
    const int k0 = kb * kBlock;
    // on the diagonal tile, keys past the warp's last row are masked: its
    // n-tiles from nlim on (and p v's k-steps from nlim / 2) are skipped
    const int nlim = causal && k0 == q0 ? 2 * warp + 2 : 8;
    cp_async_wait<1>();  // this k tile (and, first, q) has landed
    __syncthreads();

    // S = q k^T: 16 rows x 64 keys a warp, C layout (rows g, g + 8; keys
    // 8 n + 2 t + (e & 1)), one m16n8k16 a k-step of 16 features.
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      const unsigned* qa = q32 + (wr + g) * TW + kk / 2 + t;
      const unsigned a[4] = {qa[0], qa[8 * TW], qa[4], qa[8 * TW + 4]};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        if (n < nlim) {
          const unsigned* kb32 = k32 + (8 * n + g) * TW + kk / 2 + t;
          const unsigned b[2] = {kb32[0], kb32[4]};
          mma_bf16(sc[n], a, b);
        }
      }
    }

    // scale, mask, and the online-softmax update of rows g and g + 8
    const bool masked = k0 + kBlock > s || (causal && k0 + kBlock - 1 > q0 + wr);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = sc[n][e] * scale;
        if (masked) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          if (col >= s || (causal && col > row[e >> 1])) val = kNegInf;
        }
        sc[n][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m[h], mx[h]);
      corr[h] = expf(m[h] - m_new);
      m[h] = m_new;
    }
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[n][e] - m[e >> 1]);
        sc[n][e] = p;
        sum[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = corr[h] * l[h] + sum[h];  // this lane's share
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= corr[e >> 1];

    cp_async_wait<0>();  // this v tile has landed
    __syncthreads();     // v is visible, and every warp is done with k
    if (kb + 1 < ntiles) {
      copy_tile<D, TS>(kt, k, batch, k0 + kBlock, s, hkv, kv_head);
      cp_async_commit();
    }

    // O += P V: k-step j is the 16 keys of S's n-tiles 2j and 2j + 1, p
    // rounded to bf16 in registers.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * j < nlim) {
        const unsigned a[4] = {pack_bf16x2(sc[2 * j][0], sc[2 * j][1]),
                               pack_bf16x2(sc[2 * j][2], sc[2 * j][3]),
                               pack_bf16x2(sc[2 * j + 1][0], sc[2 * j + 1][1]),
                               pack_bf16x2(sc[2 * j + 1][2], sc[2 * j + 1][3])};
#pragma unroll
        for (int c = 0; c < NT; c += 2) {
          unsigned b0[2], b1[2];
          ldmatrix_v(b0, b1, vt, TS, 16 * j, 8 * c, lane);
          float f0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, f1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma_bf16(f0, a, b0);
          mma_bf16(f1, a, b1);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            o[c][e] += f0[e];
            o[c + 1][e] += f1[e];
          }
        }
      }
    }
    __syncthreads();  // every warp is done with v
    if (kb + 1 < ntiles) {
      copy_tile<D, TS>(vt, v, batch, k0 + kBlock, s, hkv, kv_head);
      cp_async_commit();
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= s) continue;
    const float denom = fmaxf(l[h], 1e-30f);
    // n-tile c holds columns 8c + 2t, 8c + 2t + 1 of the row: one bf16 pair
    unsigned* dst = reinterpret_cast<unsigned*>(
        out + (((size_t)batch * s + row[h]) * hq + head) * D + 2 * t);
#pragma unroll
    for (int c = 0; c < NT; ++c)
      dst[4 * c] = pack_bf16x2(o[c][2 * h] / denom, o[c][2 * h + 1] / denom);
  }
}

template <int D>
cudaError_t launch(const unsigned short* q, const unsigned short* k, const unsigned short* v,
                   unsigned short* out, int b, int s, int hq, int hkv, int causal, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  auto kernel = flash_attention_bf16_kernel<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(b * hq, (s + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, out, s, hq, hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// repro_flash_attention_f32's contract (flash_attention.cu) on bf16 tensors:
// q (b, s, hq, d), k and v (b, s, hkv, d) -> out (b, s, hq, d), all bf16,
// contiguous, 16-byte aligned, on the current device; scores scaled by
// `scale` in fp32. Requires b, s >= 1, hq a multiple of hkv,
// ceil(s / 64) <= 65,535 and d in {64, 128}. One launch on `stream`; returns
// its CUDA error (0 on success).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* out, int b, int s, int hq, int hkv, int d,
                                          int causal, float scale, void* stream) {
  using namespace repro_torch;
  if (b < 1 || s < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      (s + kBlock - 1) / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qq = static_cast<const unsigned short*>(q);
  const auto* kk = static_cast<const unsigned short*>(k);
  const auto* vv = static_cast<const unsigned short*>(v);
  auto* oo = static_cast<unsigned short*>(out);
  switch (d) {
    case 64: return (int)launch<64>(qq, kk, vv, oo, b, s, hq, hkv, causal, scale, st);
    case 128: return (int)launch<128>(qq, kk, vv, oo, b, s, hq, hkv, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory per CTA of a bf16 launch at head dimension d, in
// bytes (0 for a d the kernel does not take).
extern "C" int repro_flash_attention_smem_bytes_bf16(int d) {
  using namespace repro_torch;
  return d == 64 ? (int)smem_bytes<64>() : d == 128 ? (int)smem_bytes<128>() : 0;
}
