// Causal flash attention over bf16 (b, s, heads, d) tensors, grouped-query
// heads: flash_attention.cu's function for bf16 q, k and v, designed for
// Hopper's warpgroup products and tensor-memory copies.
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
// serving path's b = 4, s = 1,024, 32 query heads, d = 128, 34 GFLOP against
// 84 MB of bf16 q, k, v and output: ~0.035 ms of tensor-core time, the exp of
// each score ~0.017 ms on the SFU, 0.025 ms of bytes.
//
// The design (a TMA ring feeding wgmma, warp-specialised), item by item
// against what held back the warp-level-MMA design it replaces:
//
// * Work: a persistent CTA an SM (the shared memory below allows no second)
//   walks its items w = blockIdx.x, + gridDim.x, ...: item w is 128 query
//   rows of one batch x query head, the longest causal rows first, the heads
//   of one kv head adjacent so that their K and V tiles meet in L2. A CTA
//   computes 128 x 128 tiles (was 64 x 64 on 2,048 CTAs, each reloading its
//   q and paying its own prologue and tail).
// * Copies: a producer warpgroup gives its registers back (setmaxnreg) and
//   one of its threads issues every copy by TMA: an item's q tile once, then
//   K and V tiles of 128 keys into a ring of stages (2 at d = 128: q 32 KB +
//   2 x (K 32 + V 32) + the output's staging 32 = 192 KB; 4 at d = 64),
//   each K and each V with a "full" and an "empty" mbarrier, so a stage's K
//   is refilled once its scores are done and its V once its P V is; q has
//   its own pair, and the next item's q and tiles load while this one ends.
//   No __syncthreads after the start (was: one copy of K and V, the next
//   tile requested only after every warp was done, two __syncthreads a
//   tile). The tensor maps are 4-D over (d, heads, s, b), so the (b, s,
//   heads, d) layout is read in place; a box is 64 features (128 bytes, the
//   span of the 128-byte swizzle that wgmma reads) x 1 head x 128 rows x 1
//   batch, a d = 128 tile two boxes; rows past s are zero-filled by the copy.
//   The maps are encoded on the host for each launch, through
//   cudaGetDriverEntryPoint, so the library needs no -lcuda.
// * S = q k^T: two consumer warpgroups own 64 query rows each and raise
//   their register limit; wgmma m64n128k16, A (q) and B (K) from shared
//   memory through descriptors, both K-major, d / 16 k-steps. No fragment
//   passes through a load instruction (was: ~160 32-bit shared loads a lane
//   against 64 warp-level m16n8k16 products a 64-key tile, q re-read every
//   tile).
// * Softmax in registers: wgmma's D layout gives a thread rows g and g + 8
//   of its warp's 16, two adjacent keys of each 8-key chunk (the warp-level
//   m16n8k16 C layout), so a row's max and sum reduce over a quad's four
//   lanes by two shuffles. Scale, mask (only on a causal diagonal tile or the
//   tile that holds s), running max and normaliser are fp32; exp is exp2 of
//   the log2e-scaled scores.
// * O += P V: wgmma m64n{d}k16 with A from registers: two 8-key chunks of
//   S's accumulators, rounded to bf16 and packed, are exactly the A fragment
//   of one 16-key k-step. B is the V tile read MN-major through the
//   descriptor's transpose bit. O accumulates in wgmma's own accumulators
//   (was: each k-step into zeroed registers, then 64 FADDs a lane).
// * Overlap: a warpgroup issues tile i's scores, then tile i - 1's P V
//   behind them, and runs tile i's softmax while that P V is on the tensor
//   cores; the two warpgroups take turns to issue (named barriers 1, 2), so
//   that one's softmax runs beside the other's products.
// * Output: divided by max(l, 1e-30), rounded to bf16, staged in shared
//   memory in the swizzled layout and stored by TMA, which drops rows past s
//   (the accumulators' layout alone gives 4-byte stores, 16 bytes of a row a
//   quad).
// * Fully masked key tiles are never loaded: a causal item walks tiles 0 to
//   its own.
#include <cuda.h>  // CUtensorMap and its enums; the driver is reached at run time
#include <cuda_runtime.h>

#include <cstdint>

#include "gram_tile.cuh"

namespace repro_torch {
namespace {

constexpr int kRows = 128;      // query rows per CTA, keys per tile
constexpr int kConsumers = 2;   // warpgroups of 64 query rows
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kBox = 64;        // features a TMA box: 128 bytes, the swizzle's span
constexpr int kBoxBytes = kRows * kBox * 2;
constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
// registers a thread after setmaxnreg: 24 x 128 + 240 x 256 <= 65,536
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// the consumers take turns to issue their products (named barriers 1, 2)
constexpr bool kPingPong = true;

template <int D>
__host__ __device__ constexpr int stages() { return D == 64 ? 4 : 2; }

// bytes of a q, K or V tile (128 rows of D bf16)
template <int D>
__host__ __device__ constexpr int tile_bytes() { return kRows * D * 2; }

// the q tile, each stage's K and V, the output's staging (64 rows a
// consumer), plus 1,024 bytes to align them for the 128-byte swizzle
template <int D>
constexpr size_t smem_bytes() {
  return 1024 + (size_t)tile_bytes<D>() * (2 + 2 * stages<D>());
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}

// arrive on bar, and expect `bytes` more from the copies it tracks
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// until the phase of parity `parity` of bar has completed (no bounded poll
// that traps: its path, shared by both roles, keeps ptxas from giving the
// consumers the registers that setmaxnreg raises)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// the box at (feature c0, head c1, row c2, batch c3) of `map` into shared
// memory at dst, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the box at (c0, c1, c2, c3) of `map` from shared memory at src, in this
// thread's bulk group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A shared-memory matrix descriptor of the 128-byte swizzle: its start, the
// byte offset between 64-element column blocks (LBO: used by the MN-major V)
// and between 8-row groups (SBO).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the registers of d to this point: an asynchronous product's operands
// and results stay in their registers until the wait before it, and reads of
// its results stay after it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// named barrier `id` across one warpgroup's 128 threads
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// named barrier `id` across the two consumer warpgroups: wait for the
// other's arrival, or arrive without waiting
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ void consumers_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x 128 fp32) = A B, or D += A B where accumulate is nonzero: A (64 x 16)
// and B (16 x 128) bf16 from shared memory through their descriptors, both
// K-major.
__device__ __forceinline__ void wgmma_128_ss(float (&d)[64], uint64_t a, uint64_t b,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D (64 x 128 fp32) += A B: A (64 x 16 bf16) from registers, each warp's 16
// rows in the warp-level m16n8k16 A-fragment layout; B (16 x 128 bf16) from shared
// memory through its descriptor, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_128_rs(float (&d)[64], const unsigned (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "
      "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D (64 x 64 fp32) += A B: A (64 x 16 bf16) from registers, each warp's 16
// rows in the warp-level m16n8k16 A-fragment layout; B (16 x 64 bf16) from shared
// memory through its descriptor, MN-major (the transpose bit set).
__device__ __forceinline__ void wgmma_64_rs(float (&d)[32], const unsigned (&a)[4],
                                            uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "
      "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The online-softmax update of rows g and g + 8 over one tile's raw scores
// q k^T (sc, the wgmma D layout: rows g, g + 8; keys 8 j + 2 t + (e & 1)),
// in log2 units (sl = scale log2 e). Where `masked`, keys past s and, when
// causal, past the row take the reference's -1e30. sc becomes p = exp(x - m)
// (fp32, unrounded), l gains this lane's share of p's row sums, m the new
// running max, and corr the factor exp(m_old - m_new) of the accumulator.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl, bool masked,
                                             int k0, int s, bool causal,
                                             const int (&row)[2], int t) {
  if (masked) {
    // key k0 + 2t + c of a row is visible where c < lim: below s and, when
    // causal, at most the row
    int lim[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) lim[h] = (causal ? min(s, row[h] + 1) : s) - k0 - 2 * t;
#pragma unroll
    for (int j = 0; j < 64; ++j)
      if (8 * (j >> 2) + (j & 1) >= lim[(j >> 1) & 1]) sc[j] = kNegInf;
  }
  // four partial maxima and sums a row shorten the dependent chains
  float mx[2][4], sum[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[h][c] = kNegInf;
      sum[h][c] = 0.0f;
    }
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    float& x = mx[(j >> 1) & 1][((j >> 2) & 1) * 2 + (j & 1)];
    x = fmaxf(x, sc[j]);
  }
  float neg[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float r = fmaxf(fmaxf(mx[h][0], mx[h][1]), fmaxf(mx[h][2], mx[h][3]));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 1));
    r = fmaxf(r, __shfl_xor_sync(0xffffffffu, r, 2));
    const float m_new = fmaxf(m[h], r * sl);  // max is monotone: max(x) sl = max(x sl)
    corr[h] = exp2_approx(m[h] - m_new);
    m[h] = m_new;
    neg[h] = -m_new;
  }
#pragma unroll
  for (int j = 0; j < 64; ++j) {
    const float p = exp2_approx(fmaf(sc[j], sl, neg[(j >> 1) & 1]));
    sc[j] = p;
    sum[(j >> 1) & 1][((j >> 2) & 1) * 2 + (j & 1)] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    l[h] = corr[h] * l[h] + ((sum[h][0] + sum[h][1]) + (sum[h][2] + sum[h][3]));
}

// p rounded to bf16 and packed as the A fragments of P V's eight 16-key
// k-steps: k-step kk is S's chunks 2 kk and 2 kk + 1 (a[0] row g, keys
// 2t, 2t + 1 of the first; a[1] row g + 8; a[2], a[3] the second chunk's)
__device__ __forceinline__ void pack_p(unsigned (&pa)[32], const float (&p)[64]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) pa[i] = pack_bf16x2(p[2 * i], p[2 * i + 1]);
}

// A CTA's work item w, of b hq ceil(s / 128): query block qb of batch x
// query head bh, the longest causal rows first (w's level counted down
// from the last block), the heads of one kv head adjacent so that their K
// and V tiles meet in L2
struct Item {
  int batch, head, kv_head, q0, ntiles;
};

__device__ __forceinline__ Item item_of(int w, int b, int s, int hq, int hkv, int causal) {
  const int nq = (s + kRows - 1) / kRows;
  const int bh = w % (b * hq), level = w / (b * hq);
  const int qb = nq - 1 - level;
  Item it;
  it.batch = bh / hq;
  it.head = bh - it.batch * hq;
  it.kv_head = it.head / (hq / hkv);
  it.q0 = qb * kRows;
  it.ntiles = causal ? qb + 1 : nq;  // key tiles with a visible key
  return it;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_out, int b, int s, int hq,
                            int hkv, int causal, float scale) {
  constexpr int S = stages<D>();
  constexpr int TB = tile_bytes<D>();
  constexpr int NB = D / kBox;  // boxes a tile
  extern __shared__ unsigned char smem_raw[];
  // barriers: q full and q empty; then a stage's K full, V full, K empty and
  // V empty
  __shared__ __align__(8) uint64_t bars[2 + 4 * S];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = smem_u32(bars), q_empty = q_full + 8u;
  const int items = b * hq * ((s + kRows - 1) / kRows);
  auto k_full = [&](int st) { return q_full + 8u * (2 + st); };
  auto v_full = [&](int st) { return q_full + 8u * (2 + S + st); };
  auto k_empty = [&](int st) { return q_full + 8u * (2 + 2 * S + st); };
  auto v_empty = [&](int st) { return q_full + 8u * (2 + 3 * S + st); };
  auto k_tile = [&](int st) { return q_s + (uint32_t)TB * (1 + 2 * st); };
  auto next = [](int& st, uint32_t& phase) {
    if (++st == S) {
      st = 0;
      phase ^= 1u;
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 128 * kConsumers);
    for (int st = 0; st < S; ++st) {
      mbar_init(k_full(st), 1);
      mbar_init(v_full(st), 1);
      mbar_init(k_empty(st), 128 * kConsumers);
      mbar_init(v_empty(st), 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Both roles walk the CTA's items (w = blockIdx.x, + gridDim.x, ...) and
  // the ring's stages in the same order; the producer runs ahead into the
  // next item as soon as the consumers release q and the stages.
  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // the producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) {
      int st = 0;
      uint32_t phase = 0, q_phase = 0;
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const Item it = item_of(w, b, s, hq, hkv, causal);
        mbar_wait(q_empty, q_phase ^ 1u);  // the first item finds q empty
        q_phase ^= 1u;
        mbar_expect_tx(q_full, TB);
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_load(q_s + c * kBoxBytes, &map_q, q_full, c * kBox, it.head, it.q0, it.batch);
        for (int i = 0; i < it.ntiles; ++i) {
          const uint32_t kt = k_tile(st), vt = kt + TB;
          mbar_wait(k_empty(st), phase ^ 1u);  // the first pass over the ring finds it empty
          mbar_expect_tx(k_full(st), TB);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load(kt + c * kBoxBytes, &map_k, k_full(st), c * kBox, it.kv_head, i * kRows,
                     it.batch);
          mbar_wait(v_empty(st), phase ^ 1u);
          mbar_expect_tx(v_full(st), TB);
#pragma unroll
          for (int c = 0; c < NB; ++c)
            tma_load(vt + c * kBoxBytes, &map_v, v_full(st), c * kBox, it.kv_head, i * kRows,
                     it.batch);
          next(st, phase);
        }
      }
    }
  } else {
    // a consumer: 64 query rows of each item, 16 a warp
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const float sl = scale * kLog2e;  // scores in log2 units: exp(x) = exp2(x log2 e)
    const uint32_t qa = q_s + 64 * 128 * wg;  // the warpgroup's rows of each q box
    // the warpgroup's output staging: NB boxes of 64 rows x 128 bytes
    const uint32_t os = q_s + (uint32_t)TB * (1 + 2 * S) + (TB / 2) * wg;

    // S = q k^T: 64 rows x 128 keys, D / 16 k-steps, each 32 bytes along the
    // 128-byte swizzled rows of a box
    auto issue_qk = [&](float (&sc)[64], uint32_t kt) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
        wgmma_128_ss(sc, sw128_desc(qa + off, 16, 1024), sw128_desc(kt + off, 16, 1024), kk);
      }
      wgmma_commit();
    };
    // O += P V: 8 k-steps of 16 keys, two 8-row groups of 1,024 bytes each
    auto issue_pv = [&](float (&o)[D / 2], const unsigned (&pa)[32], uint32_t vt) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const unsigned a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3]};
        const uint64_t b = sw128_desc(vt + kk * 2048, kBoxBytes, 1024);
        if constexpr (D == 128)
          wgmma_128_rs(o, a, b);
        else
          wgmma_64_rs(o, a, b);
      }
      wgmma_commit();
    };

    // turns: warpgroup c issues after barrier 1 + c and then hands the turn
    // on; warpgroup 0 goes first
    auto my_turn = [&] {
      if constexpr (kPingPong) consumers_sync(1 + wg);
    };
    auto your_turn = [&](bool last) {
      if constexpr (kPingPong)
        if (!(last && wg == 1)) consumers_arrive(2 - wg);  // no turn follows the last
    };
    if (kPingPong && wg == 1) consumers_arrive(1);

    int st = 0;
    uint32_t phase = 0, q_phase = 0;
    for (int w = blockIdx.x; w < items; w += gridDim.x) {
      const Item it = item_of(w, b, s, hq, hkv, causal);
      const int r0 = it.q0 + 64 * wg;  // the warpgroup's first row
      const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
      // a tile needs the mask where it holds s or reaches past the
      // warpgroup's first row (a causal diagonal tile)
      auto masked = [&](int k0) { return k0 + kRows > s || (causal && k0 + kRows - 1 > r0); };

      float o[D / 2], sc[64], m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f}, corr[2];
      unsigned pa[32];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;

      // tile 0: its scores and p
      mbar_wait(q_full, q_phase);
      q_phase ^= 1u;
      mbar_wait(k_full(st), phase);
      my_turn();
      wgmma_fence();
      issue_qk(sc, k_tile(st));
      your_turn(false);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(k_empty(st));
      if (it.ntiles == 1) mbar_arrive(q_empty);  // the item's last use of q
      softmax_tile(sc, m, l, corr, sl, masked(0), 0, s, causal, row, t);
      pack_p(pa, sc);
      // tile i's scores on the tensor cores, then tile i - 1's P V behind
      // them; tile i's softmax runs beside that P V
      for (int i = 1; i < it.ntiles; ++i) {
        const int pst = st;
        const uint32_t pphase = phase;
        next(st, phase);
        mbar_wait(k_full(st), phase);
        my_turn();
        wgmma_fence();
        issue_qk(sc, k_tile(st));
        mbar_wait(v_full(pst), pphase);
        issue_pv(o, pa, k_tile(pst) + TB);
        your_turn(false);
        wgmma_wait<1>();  // the scores (committed first) have landed
        fence_regs(sc);
        mbar_arrive(k_empty(st));
        if (i == it.ntiles - 1) mbar_arrive(q_empty);
        softmax_tile(sc, m, l, corr, sl, masked(i * kRows), i * kRows, s, causal, row, t);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);  // the product has read them: pa may be rewritten
        mbar_arrive(v_empty(pst));
#pragma unroll
        for (int j = 0; j < D / 2; ++j) o[j] *= corr[(j >> 1) & 1];
        pack_p(pa, sc);
      }
      mbar_wait(v_full(st), phase);
      my_turn();
      wgmma_fence();
      issue_pv(o, pa, k_tile(st) + TB);
      your_turn(w + (int)gridDim.x >= items);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(v_empty(st));
      next(st, phase);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      }
      // the output: divided by max(l, 1e-30), rounded to bf16 and staged in
      // the swizzled layout (a quad's 16-byte chunk of 8 rows lands on 32
      // banks), then stored by TMA, which drops the rows past s
      if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      warpgroup_sync(3 + wg);  // the last item's store has read the staging
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float denom = fmaxf(l[h], 1e-30f);
        const int rr = 16 * warp + g + 8 * h;  // row in the warpgroup's 64
#pragma unroll
        for (int c = 0; c < D / 8; ++c) {
          const uint32_t dst =
              os + (c / 8) * 8192 + rr * 128 + (((c % 8) ^ (rr & 7)) << 4) + 4 * t;
          const unsigned v = pack_bf16x2(o[4 * c + 2 * h] / denom, o[4 * c + 2 * h + 1] / denom);
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      warpgroup_sync(3 + wg);
      if (tid == 0) {
#pragma unroll
        for (int c = 0; c < NB; ++c)
          tma_store(&map_out, os + c * 8192, c * kBox, it.head, r0, it.batch);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// links no -lcuda
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p,
                                                             12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a contiguous (b, s, heads, D) bf16 tensor: 4-D over
// (D, heads, s, b), boxes of 64 features x 1 head x `rows` rows x 1 batch
// in the 128-byte swizzle; out-of-bounds rows read as zeros and are not
// written.
bool encode_map(CUtensorMap* map, const void* ptr, int b, int s, int heads, int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  const cuuint64_t strides[3] = {2ull * D, 2ull * D * heads, 2ull * D * heads * s};  // bytes
  const cuuint32_t box[4] = {kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const unsigned short* q, const unsigned short* k, const unsigned short* v,
                   unsigned short* out, int b, int s, int hq, int hkv, int causal, float scale,
                   cudaStream_t stream) {
  CUtensorMap mq, mk, mv, mo;
  if (!encode_map(&mq, q, b, s, hq, D, kRows) || !encode_map(&mk, k, b, s, hkv, D, kRows) ||
      !encode_map(&mv, v, b, s, hkv, D, kRows) || !encode_map(&mo, out, b, s, hq, D, 64))
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes<D>();
  auto kernel = flash_attention_bf16_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess)
    return err;
  // one CTA an SM (its shared memory allows no second), each walking its
  // items
  const int items = b * hq * ((s + kRows - 1) / kRows);
  kernel<<<items < sms ? items : sms, kThreads, bytes, stream>>>(mq, mk, mv, mo, b, s, hq,
                                                                  hkv, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// repro_flash_attention_f32's contract (flash_attention.cu) on bf16 tensors:
// q (b, s, hq, d), k and v (b, s, hkv, d) -> out (b, s, hq, d), all bf16,
// contiguous, 16-byte aligned, on the current device; scores scaled by
// `scale` in fp32. Requires b, s >= 1, hq a multiple of hkv,
// ceil(s / 128) <= 65,535 and d in {64, 128}. One launch on `stream`; returns
// its CUDA error (0 on success; cudaErrorInvalidValue also where a tensor map
// cannot be encoded).
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v,
                                          void* out, int b, int s, int hq, int hkv, int d,
                                          int causal, float scale, void* stream) {
  using namespace repro_torch;
  if (b < 1 || s < 1 || hkv < 1 || hq < hkv || hq % hkv != 0 ||
      (s + kRows - 1) / kRows > 65535 ||
      (long long)b * hq * ((s + kRows - 1) / kRows) > 0x7fffffff)
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
