// Causal flash attention over (b, s, heads, d) tensors, grouped-query heads.
//
// Replaces flash_attention_pallas (src/repro/kernels/flash_attention.py,
// _flash_kernel) together with the head gather, transposes and padding of
// repro.kernels.ops.flash_attention: it reads q (b, s, hq, d) and k, v
// (b, s, hkv, d) in place, maps query head h to key/value head h / (hq / hkv)
// itself, and masks the ragged last block by bounds instead of padding.
//
// What it computes, per query row r: out[r] = softmax(q[r] k[c]^T * d^-1/2 over
// the visible c) v, visible meaning c < s and, when causal, c <= r. Online
// softmax as in the TPU kernel: a running max m and normaliser l in fp32 and a
// 64 x d fp32 accumulator; per key tile p = exp(s - m_new),
// corr = exp(m_prev - m_new), l = corr l + sum p, acc = corr acc + p v; at the
// end out = acc / max(l, 1e-30). Masked scores are -1e30, not -inf: a row
// whose tile so far is all masked would give -inf - (-inf) = NaN.
//
// Work split. One CTA of 256 threads per (batch x query head, 64 query rows).
// The TPU grid walks key blocks in order on one core with the statistics in
// scratch; here that sequential axis is a loop inside the CTA, from key tile 0
// to the tile holding the CTA's last row when causal (fully masked tiles are
// never visited), to the end otherwise. CTAs are issued longest first (the
// last query block has the most tiles), so the short ones fill the tail.
//
// What bounds it: operations. Per visible (row, key) pair it does 2d flops
// for q k^T and 2d for p v, in IEEE fp32 FMAs outside the tensor
// cores (no fast math); at the serving path's b = 4, s = 1,024, 32 query
// heads, d = 128 that is 34 GFLOP against 168 MB of operands, 200 flops a
// byte. The design keeps every tile in shared memory and every product in
// registers: thread (tx, ty) of a 16 x 16 grid owns rows ty + 16i (i < 4) of
// the CTA, keys tx + 16j (j < 4) of the score tile and output columns
// tx + 16j (j < d / 16). Score reads are float4 along d, with a row stride of
// d + 4 that puts the eight lanes of a float4 phase on distinct banks; a row's
// max and sum are reduced over its 16 lanes by shuffles. K and V share one
// tile buffer (84 KB of shared memory a CTA at d = 128, two CTAs an SM). No
// wgmma, no TMA: a later kernel's work.
#include <cuda_runtime.h>

namespace repro_torch {
namespace {

constexpr int kBlock = 64;          // query rows per CTA, keys per tile
constexpr int kThreads = 256;       // a 16 x 16 grid
constexpr int kPStride = kBlock + 4;  // row stride of the probability tile
constexpr float kNegInf = -1e30f;   // the reference's mask value

template <int D>
__host__ __device__ constexpr int tile_stride() { return D + 4; }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * kBlock * tile_stride<D>() + kBlock * kPStride);
}

// Rows [r0, r0 + kBlock) of head `head` of a (b, s, heads, D) tensor into a
// tile of row stride D + 4, rows past s zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int batch, int r0, int s, int heads,
                                          int head) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kBlock * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = i - r * kVec;
    const int gr = r0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (gr < s)
      val = reinterpret_cast<const float4*>(
          src + (((size_t)batch * s + gr) * heads + head) * D)[c];
    *reinterpret_cast<float4*>(dst + r * tile_stride<D>() + 4 * c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int s, int hq, int hkv, int causal, float scale) {
  constexpr int TS = tile_stride<D>();
  constexpr int CJ = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);
  float* kv = qt + kBlock * TS;  // K's tile, then V's
  float* pt = kv + kBlock * TS;

  const int nq = (s + kBlock - 1) / kBlock;
  const int qb = nq - 1 - (int)blockIdx.x;  // longest causal rows first
  const int batch = blockIdx.y / hq;
  const int head = blockIdx.y - batch * hq;
  const int kv_head = head / (hq / hkv);
  const int q0 = qb * kBlock;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  load_tile<D>(qt, q, batch, q0, s, hq, head);

  float m[4], l[4], acc[4][CJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) acc[i][j] = 0.0f;
  }

  const int ntiles = causal ? qb + 1 : nq;
  for (int kb = 0; kb < ntiles; ++kb) {
    const int k0 = kb * kBlock;
    __syncthreads();  // the previous tile's P V reads are done
    load_tile<D>(kv, k, batch, k0, s, hkv, kv_head);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qt + (ty + 16 * i) * TS + e);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(kv + (tx + 16 * j) * TS + e);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float t = fmaf(a[i].x, b[j].x, sc[i][j]);
          t = fmaf(a[i].y, b[j].y, t);
          t = fmaf(a[i].z, b[j].z, t);
          sc[i][j] = fmaf(a[i].w, b[j].w, t);
        }
    }

    // scale, mask, and the online-softmax update of rows ty + 16 i; the
    // probabilities go to shared memory for P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float val = sc[i][j] * scale;
        if (col >= s || (causal && col > row)) val = kNegInf;
        sc[i][j] = val;
        mx = fmaxf(mx, val);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(sc[i][j] - m_new);
        pt[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = corr * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // K's tile is read and P is written
    load_tile<D>(kv, v, batch, k0, s, hkv, kv_head);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBlock; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(pt + (ty + 16 * i) * kPStride + c);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vr = kv + (c + u) * TS + tx;
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          const float vv = vr[16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
            acc[i][j] = fmaf(p, vv, acc[i][j]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + (((size_t)batch * s + row) * hq + head) * D + tx;
#pragma unroll
    for (int j = 0; j < CJ; ++j) o[16 * j] = acc[i][j] / denom;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out,
                   int b, int s, int hq, int hkv, int causal, float scale,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes<D>();
  auto kernel = flash_attention_kernel<D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((s + kBlock - 1) / kBlock, b * hq);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, out, s, hq, hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q (b, s, hq, d), k and v (b, s, hkv, d) -> out (b, s, hq, d): attention of
// each query head h over key/value head h / (hq / hkv), causal or not, scores
// scaled by `scale`. All float32, contiguous, 16-byte aligned, on the current
// device. Requires b, s >= 1, hq a multiple of hkv, b * hq <= 65,535 and
// d in {64, 128}. One launch on `stream`; returns its CUDA error (0 on
// success).
extern "C" int repro_flash_attention_f32(const float* q, const float* k,
                                         const float* v, float* out, int b,
                                         int s, int hq, int hkv, int d,
                                         int causal, float scale, void* stream) {
  using namespace repro_torch;
  if (b < 1 || s < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      (long long)b * hq > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64: return (int)launch<64>(q, k, v, out, b, s, hq, hkv, causal, scale, st);
    case 128: return (int)launch<128>(q, k, v, out, b, s, hq, hkv, causal, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory per CTA of a launch at head dimension d, in bytes
// (0 for a d the kernel does not take).
extern "C" int repro_flash_attention_smem_bytes(int d) {
  using namespace repro_torch;
  return d == 64 ? (int)smem_bytes<64>() : d == 128 ? (int)smem_bytes<128>() : 0;
}
