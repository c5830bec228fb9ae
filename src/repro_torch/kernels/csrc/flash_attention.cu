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
// What bounds it on an H100: operations. Per visible (row, key) pair, 2d
// flops for q k^T and 2d for p v; at the serving path's b = 4, s = 1,024, 32
// query heads, d = 128 that is 34 GFLOP against 168 MB of operands. On the
// FMA pipe (the kernel before this design) the bound is 0.51 ms; on the
// tensor cores in the three-way TF32 split, 3 x 2 flops a product over the
// computed tiles (diagonal tiles whole), it is ~0.22 ms, and the exp of each
// score ~0.017 ms on the SFU.
//
// What the design does about it (FA2's split of the work):
//
// * One CTA of 4 warps per (batch x query head, 64 query rows); each warp
//   owns 16 query rows, so a row's max and sum reduce over the 4 lanes of a
//   quad (shuffles by 1 and 2) and its normaliser is summed once, at the end.
//   The TPU grid's sequential key axis is a loop inside the CTA, from key
//   tile 0 to the tile holding the CTA's last row when causal (fully masked
//   tiles are never visited, and on the diagonal tile a warp skips the
//   n-tiles past its own rows), to the end otherwise. The query block is
//   the grid's slow axis, so every head's longest CTAs are issued first and
//   the short ones fill the tail.
// * Both products on the tensor cores: mma.sync m16n8k8 TF32 in the
//   three-way split (gram_tile.cuh, mma_split_add: the three products summed
//   in the MMA, then added by FADD per k-step), which keeps fp32 accuracy.
//   The online softmax stays in fp32 with the full-range expf (no fast math).
// * P never touches shared memory: a thread's S accumulator of one 8-key
//   n-tile is, permuted, the A fragment of P V's k-step (k-slots t and t + 4
//   stand for keys 2t and 2t + 1, and the V fragment reads rows 2t and
//   2t + 1 in that order); the warp splits it in registers.
// * K and V land in separate tiles by 16-byte cp.async, zero-filled past s:
//   V's copy is in flight during q k^T, the next tile's K during p v.
// * Fragments are read two floats at a time: in q k^T the k-slots t and
//   t + 4 stand for adjacent columns 2t and 2t + 1 (in q and k alike), and
//   p v's n-tiles go in pairs whose columns interleave, so a lane's B entries
//   of both are adjacent; the output row is then written as float4. Row
//   strides d + 8 (q, k) and d + 4 (v) keep every read on 32 banks. The
//   B fragments of two n-tiles of q k^T are read and split before their
//   MMAs, so the loads' latency overlaps.
// * Every fragment is split into its TF32 parts as it is read: q, k and v
//   stay raw, 101 KB of shared memory at d = 128, two CTAs an SM. Splitting
//   q once per CTA and each k and v tile once as it lands (hi and lo tiles,
//   203 KB, one CTA an SM) was 1.7x slower at the serving shape (PERF.md §6).
// * No wgmma: TF32 wgmma reads B K-major, which k^T is but v, read as
//   (keys x d), is not; p v on wgmma needs v transposed into shared memory,
//   a later design's work.
#include <cuda_runtime.h>

#include "gram_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kBlock = 64;          // query rows per CTA, keys per tile
constexpr int kWarps = 4;           // 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr float kNegInf = -1e30f;   // the reference's mask value
// n-tiles of q k^T whose B fragments are read (and split) together before
// their MMAs
constexpr int kGroupQK = 2;

// Row strides: q and k are read as float2 pairs (row g, columns 2t, 2t + 1)
// by the 32 lanes, conflict-free at D + 8; v as scalars and float2 pairs
// (rows 2t, 2t + 1, columns 2g, 2g + 1), conflict-free at D + 4.
template <int D>
__host__ __device__ constexpr int qk_stride() { return D + 8; }
template <int D>
__host__ __device__ constexpr int v_tile_stride() { return D + 4; }

// Tiles of the CTA: q, k and v.
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * kBlock * (2 * qk_stride<D>() + v_tile_stride<D>());
}

// Rows [r0, r0 + kBlock) of head `head` of a (b, s, heads, D) tensor into a
// tile of row stride TS by 16-byte cp.async, rows past s zero-filled.
template <int D, int TS>
__device__ __forceinline__ void copy_tile(float* __restrict__ dst,
                                          const float* __restrict__ src, int batch,
                                          int r0, int s, int heads, int head) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < kBlock * kVec; i += kThreads) {
    const int r = i / kVec, c = i - r * kVec;
    const bool ok = r0 + r < s;
    cp_async_16(dst + r * TS + 4 * c,
                ok ? src + (((size_t)batch * s + r0 + r) * heads + head) * D + 4 * c : src,
                ok ? 16 : 0);
  }
}

// The TF32 parts of two adjacent tile elements (o even), split as read.
__device__ __forceinline__ void parts2(const float* __restrict__ tile, int o, float (&h)[2],
                                       float (&l)[2]) {
  const float2 v = *reinterpret_cast<const float2*>(tile + o);
  split_tf32(v.x, h[0], l[0]);
  split_tf32(v.y, h[1], l[1]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int s, int hq, int hkv, int causal, float scale) {
  constexpr int TQ = qk_stride<D>();
  constexpr int TV = v_tile_stride<D>();
  constexpr int NT = D / 8;  // n-tiles of p v (and k-steps of q k^T)
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // q
  float* kt = qt + kBlock * TQ;                 // k
  float* vt = kt + kBlock * TQ;                 // v

  const int nq = (s + kBlock - 1) / kBlock;
  const int qb = nq - 1 - (int)blockIdx.y;  // longest causal rows first
  const int batch = blockIdx.x / hq;
  const int head = blockIdx.x - batch * hq;
  const int kv_head = head / (hq / hkv);
  const int q0 = qb * kBlock;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 16 * warp;               // the warp's first row in the block
  const int row[2] = {q0 + wr + g, q0 + wr + g + 8};

  copy_tile<D, TQ>(qt, q, batch, q0, s, hq, head);
  copy_tile<D, TQ>(kt, k, batch, 0, s, hkv, kv_head);
  cp_async_commit();
  copy_tile<D, TV>(vt, v, batch, 0, s, hkv, kv_head);
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
    // n-tiles (and p v's k-steps) from nlim on are skipped
    const int nlim = causal && k0 == q0 ? 2 * warp + 2 : 8;
    cp_async_wait<1>();  // this k tile (and, first, q) has landed
    __syncthreads();

    // S = q k^T: 16 rows x 64 keys a warp, C layout (rows g, g + 8; keys
    // 8 n + 2 t + (e & 1)). The k-slots t and t + 4 of a k-step stand for
    // the columns kk + 2t and kk + 2t + 1, in q and in k alike: one float2
    // read each.
    float sc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.0f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 8) {
      float ahi[4], alo[4];
      {
        const int oa = (wr + g) * TQ + kk + 2 * t;
        float h0[2], l0[2], h1[2], l1[2];
        parts2(qt, oa, h0, l0);           // row g
        parts2(qt, oa + 8 * TQ, h1, l1);  // row g + 8
        ahi[0] = h0[0], ahi[1] = h1[0], ahi[2] = h0[1], ahi[3] = h1[1];
        alo[0] = l0[0], alo[1] = l1[0], alo[2] = l0[1], alo[3] = l1[1];
      }
#pragma unroll
      for (int n = 0; n < 8; n += kGroupQK) {
        if (n < nlim) {
          float bhi[kGroupQK][2], blo[kGroupQK][2];
#pragma unroll
          for (int h = 0; h < kGroupQK; ++h)
            parts2(kt, (8 * (n + h) + g) * TQ + kk + 2 * t, bhi[h], blo[h]);
#pragma unroll
          for (int h = 0; h < kGroupQK; ++h)
            if (n + h < nlim) mma_split_add(sc[n + h], ahi, alo, bhi[h], blo[h]);
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
    __syncthreads();  // v is visible, and every warp is done with k
    if (kb + 1 < ntiles) {
      copy_tile<D, TQ>(kt, k, batch, k0 + kBlock, s, hkv, kv_head);
      cp_async_commit();
    }

    // O += P V: k-step n is the 8 keys of S's n-tile n. The n-tiles go in
    // pairs (c, c + 1) over the 16 columns 8c..8c + 15: column 8c + 2j is
    // column j of n-tile c, 8c + 2j + 1 column j of n-tile c + 1, so a lane's
    // two B entries of a row are one float2 read.
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < nlim) {
        // k-slot t <-> key 2t, t + 4 <-> key 2t + 1
        const float a[4] = {sc[n][0], sc[n][2], sc[n][1], sc[n][3]};
        float ahi[4], alo[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ahi[e], alo[e]);
        const int ob = (8 * n + 2 * t) * TV + 2 * g;
#pragma unroll
        for (int c = 0; c < NT; c += 2) {
          float h0[2], l0[2], h1[2], l1[2];
          parts2(vt, ob + 8 * c, h0, l0);       // key 2t
          parts2(vt, ob + TV + 8 * c, h1, l1);  // key 2t + 1
          const float be_hi[2] = {h0[0], h1[0]}, be_lo[2] = {l0[0], l1[0]};
          const float bo_hi[2] = {h0[1], h1[1]}, bo_lo[2] = {l0[1], l1[1]};
          mma_split_add(o[c], ahi, alo, be_hi, be_lo);
          mma_split_add(o[c + 1], ahi, alo, bo_hi, bo_lo);
        }
      }
    }
    __syncthreads();  // every warp is done with v
    if (kb + 1 < ntiles) {
      copy_tile<D, TV>(vt, v, batch, k0 + kBlock, s, hkv, kv_head);
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
    // n-tiles c, c + 1 hold columns 8c + 4t + (0, 2) and (1, 3) of the row
    float* dst = out + (((size_t)batch * s + row[h]) * hq + head) * D + 4 * t;
#pragma unroll
    for (int c = 0; c < NT; c += 2)
      *reinterpret_cast<float4*>(dst + 8 * c) =
          make_float4(o[c][2 * h] / denom, o[c + 1][2 * h] / denom,
                      o[c][2 * h + 1] / denom, o[c + 1][2 * h + 1] / denom);
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
  const dim3 grid(b * hq, (s + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, bytes, stream>>>(q, k, v, out, s, hq, hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q (b, s, hq, d), k and v (b, s, hkv, d) -> out (b, s, hq, d): attention of
// each query head h over key/value head h / (hq / hkv), causal or not, scores
// scaled by `scale`. All float32, contiguous, 16-byte aligned, on the current
// device. Requires b, s >= 1, hq a multiple of hkv, ceil(s / 64) <= 65,535
// and d in {64, 128}. One launch on `stream`; returns its CUDA error (0 on
// success).
extern "C" int repro_flash_attention_f32(const float* q, const float* k,
                                         const float* v, float* out, int b,
                                         int s, int hq, int hkv, int d,
                                         int causal, float scale, void* stream) {
  using namespace repro_torch;
  if (b < 1 || s < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      (s + kBlock - 1) / kBlock > 65535)
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
