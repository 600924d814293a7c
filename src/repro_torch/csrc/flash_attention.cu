// K4 flash_attention (prefill) and K5 flash_decode (paged decode).
//
// K4 replaces repro/kernels/flash_attention.py:flash_attention_kernel.
//   q, k, v (BH, S, D) f32|bf16 -> out (BH, S, D) in q's dtype; online softmax
//   in f32, causal or not, keys >= S masked in the kernel (no padding of S),
//   scale D^-0.5.  Both products run on the bf16 tensor cores (wgmma, f32
//   accumulation) fed by TMA, on one of two paths that the host plan
//   (kernels/flash_attention.py:plan_attention) picks from the type alone
//   and passes in, with its tiles:
//
//   * wgmma (bf16, every head dim: the serving path).  What bounds it on an
//     H100: at the prefill shapes (S 128, D 128, BH 128) the bytes, 16.8 MB
//     in 0.0050 ms, against 0.54 GFLOP that bf16 tensor cores do in 0.00055
//     ms but the FP32 pipes only in 0.0081 ms; at S 513 the operations come
//     close (17.25 GFLOP, 0.0174 ms).  One block a (q tile, bh), with one or
//     two consumer warpgroups of 64 query rows (block_q 64 or 128; the plan
//     takes 64 rows by 64 keys, the fastest in chip_smoke.py's attn_sweep,
//     and head dim 256 only that) and one producer warp.  The producer loads
//     the q tile once and streams K and V tiles of block_k keys through a
//     two-stage ring by TMA, from 3-D tensor maps over (BH, S, D) in the
//     swizzle of the row: boxes of 64 columns in 128-byte rows from head dim
//     64 up, whole rows of 64 or 32 bytes (the 64- and 32-byte swizzle) at 32
//     and 16; rows past S arrive as zeros and a tile never reads the next
//     head's rows; each stage's arrival is counted on an mbarrier, and the
//     consumers free it on another, so the next tile's copy is in flight
//     while this one computes.  A warpgroup computes S = Q K^T with wgmma
//     m64n{block_k}k16 (Q and K both K-major in shared memory), then the
//     softmax in registers on the accumulator's own layout (a thread holds
//     parts of two rows; a row's max and sum take two shuffles within the
//     four lanes that share it; log2(e) folded into the scale, exp2), masks
//     only on the causal diagonal's and the ragged last tile, rescales its
//     f32 O accumulator (m64n{D}: 128 registers a thread at D 256), converts
//     P to bf16 in place as the register A operand of wgmma m64n{D}k16 and
//     adds P V, V read MN-major from shared memory.  The key loop stops at
//     the causal diagonal of the q tile (the pl.when skip of the Pallas
//     body); a warpgroup whose rows end before a tile skips it.  The
//     epilogue normalises by max(l, 1e-30), writes bf16 into the
//     warpgroup's q tile (the same swizzle) and stores it with TMA, which
//     drops rows >= S.
//   * split (f32, every head dim).  One bf16 product misses the reference's
//     2e-4 (5e-3 in a float64-checked emulation), and the FP32 pipes run at
//     67 TFLOP/s against the tensor cores' 989.  So each f32 operand x is
//     split as hi = bf16(x), lo = bf16(x - hi) (16 bits of x; x - hi is
//     exact), and each product is three bf16 wgmma chains into one f32
//     accumulator: S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T and O +=
//     P_hi V_hi + P_hi V_lo + P_lo V_hi (lo lo, about 2^-16 of a product,
//     is left out: the outputs stay within ~3e-5; every cheaper mix, P as a
//     single bf16 among them, misses 2e-4).  What bounds it on an H100: the
//     f32 bytes, 33.5 MB in 0.0100 ms at the prefill shape (the three
//     products: 1.6 GFLOP, 0.0016 ms); at S 513 non-causal the three
//     products (51.7 GFLOP, 0.052 ms) against the bytes' 0.040 ms.  In
//     practice shared memory: a block moves ~480 KB through it per 128
//     rows x 64 keys (TMA, the split, the operands of S and P V) against
//     12.6 MFLOP, and at S 513 the kernel runs at ~30% of its bound (PERF.md
//     section 6).  One block a (q tile, bh): one or two consumer
//     warpgroups of 64 query rows and one producer warp.  The producer
//     lands the f32 q tile by TMA, then, key tile by key tile, the f32 K
//     and V tiles of block_k keys (unswizzled [keys][D] boxes, rows past S
//     as zeros) into one stage.  The consumers split every tile
//     themselves, all 128 or 256 threads at once between named barriers
//     (bar.sync 1, n), into bf16 hi and lo tiles in the wgmma path's
//     swizzled layout (q and K K-major, V MN-major through the transpose
//     bit), which frees the f32 stage: the next tile's copy overlaps this
//     tile's products, the split tiles serving as the second buffer (a
//     second f32 stage, and splitting V and the next K while the products
//     run, were both slower in attn_sweep).  P is split in registers into
//     two A-fragment sets in the layout pack_bf16 gives.  No tile is split
//     twice: two warpgroups share one split of each key tile, which also
//     halves the L2 reads of K and V against blocks of one.  The split
//     reads a tile's f32 bytes once from shared memory and writes them back
//     as two bf16 tiles (16-byte loads and 8-byte stores, neither with a
//     bank conflict), about 16 instructions a float4.  No branch surrounds
//     a wgmma (ptxas would serialise it), so with two warpgroups the first
//     also runs, fully masked, the key tiles past its causal diagonal.
//     Shared memory (FsTiles): q hi and lo (the f32 output tile at the
//     end), the four split tiles (the f32 q tile before them), the f32
//     stage; the plan's tile at D 128 is two warpgroups by 64 keys, 192 KB
//     and one block an SM.  The epilogue normalises by max(l, 1e-30) and
//     stores f32 by TMA from a swizzled tile over q's bytes (64- or
//     128-byte rows), dropping rows >= S.
//
//   Neither path has an atomic, and every sum runs in a fixed order:
//   repeated launches are bit-identical.
//
// K5 replaces repro/kernels/flash_attention.py:flash_decode_kernel.
//   One query token per slot, q (B, KV, G, hd) grouped under its KV head,
//   against a shared page pool (N_pool, page, KV, hd) f32|bf16 through a
//   per-slot page table (B, n_pmax) int32 and lengths (B,) int32.  Returns the
//   unnormalised partials acc (B, KV, G, hd), m and l (B, KV, G, 1) in f32.
//   Bound on an H100: bytes of the pages each slot owns (one pass over them),
//   with the f32 FMA work (4 G hd flops a token, on the CUDA cores: bf16 or
//   TF32 tensor cores would break the 1e-4 tolerance on an f32 pool) close
//   behind at G 8.  At serving shapes the bytes are well under a microsecond,
//   so parallelism and latency set the time.
//   Design: the TPU's sequential page axis is split across the blocks of a
//   thread-block cluster.  Grid (split, KV x G / GB, B), cluster (split, 1,
//   1): block r of (KV head, GB queries, slot) takes pages [r * ppb,
//   (r + 1) * ppb).  split, ppb and GB come from a host plan that reads only
//   shapes (kernels/flash_attention.py:plan_decode: about two blocks an SM,
//   at most 12 a cluster, above 8 as a non-portable cluster), so nothing
//   syncs with the host.  The block first compacts its range's valid pages
//   (entry >= 0 and starting before the length) with a block-wide scan, so
//   neither a -1 entry nor a page past the length is ever read from the
//   pool, and no step of the walk waits on the table.  A ring of 2-8
//   shared-memory stages of 16 or 32 token rows (K, then V) is filled by
//   16-byte cp.async copies, a token's head row contiguous across threads,
//   so the next stages stream while one is computed; tokens past the length
//   are not copied.  Each of the 8 warps takes rows w, w + 8, ... of a stage
//   and keeps its own online softmax: lane l holds q[g][hd/32 elements] of
//   the GB (at most 8) queries in registers, pre-scaled, and acc[g][same
//   elements]; a row's GB partial dots meet in a butterfly that scatters
//   the sums over the lanes (GB - 1 + 5 - log2 GB shuffles, not 5 GB); the
//   lanes of query g take its softmax step and share p and the correction
//   through a few words of shared memory.  Then the warps' partials merge in
//   a fixed order, and the cluster's blocks merge through distributed shared
//   memory: block r stores its (m, l) into every block and slice q of its acc
//   into block q (stores do not wait on the peer), and after one cluster
//   barrier each block sums what it received in rank order.  No atomics and
//   no memset, so repeated launches are bit-identical.  Every block reaches
//   the cluster barriers, also one whose range holds no token: it
//   contributes m = -1e30, l = 0, acc = 0, and a slot with no valid page
//   returns exactly that, as the reference does.  No G padding beyond a
//   power of two: the reference pads G to 8 only for the TPU's sublanes.

#include <cooperative_groups.h>

#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers (shared with K3)

namespace cg = cooperative_groups;

namespace {

// Raise a kernel's dynamic shared-memory limit when a launch needs more than
// it was last given (one driver call per kernel and size, not per launch, so
// launches can also be captured in a CUDA graph once warmed up).
template <auto Kernel>
cudaError_t raise_smem_limit(size_t smem) {
  static size_t granted = 48 * 1024;  // per kernel; the default needs no call
  if (smem <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) granted = smem;
  return err;
}

// ------------------------------------------------------------------ K4
enum AttnPath : int { ATTN_WGMMA = 0, ATTN_SPLIT = 1 };  // kernels/flash_attention.py: ATTN_PATHS
constexpr int FW_STAGES = 2;  // the wgmma path's K/V ring

// Bytes of a swizzled row of a bf16 tile of head dim D: 128 (boxes of 64
// columns) from D 64 up, else the whole row (64 bytes at D 32, 32 at D 16).
__host__ __device__ constexpr int bf16_row_bytes(int D) { return D >= 64 ? 128 : 2 * D; }

constexpr CUtensorMapSwizzle tma_swizzle(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// Descriptor of k16 step kk of a K-major bf16 tile of ROWS rows in boxes of
// RB-byte swizzled rows (Q and K of S = Q K^T): RB / 32 steps a row, the
// next box ROWS * RB bytes on.
template <int RB, int ROWS>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int kk) {
  constexpr int KPR = RB / 32;
  return gmma_desc<RB>(base + (kk / KPR) * (ROWS * RB) + (kk % KPR) * 32, 16, 8 * RB);
}

// Descriptor of k16 step kk of an MN-major bf16 tile (V of P V, ROWS keys):
// 16 rows a step, boxes of RB / 2 columns ROWS * RB bytes apart.
template <int RB, int ROWS>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t base, int kk) {
  return gmma_desc<RB>(base + kk * 16 * RB, ROWS * RB, 8 * RB);
}

__device__ __forceinline__ float minus_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (a, b) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi) (a in the low
// halves): x - hi is exact in f32, so hi + lo carries 16 bits of x.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// One key tile's online-softmax step on a warpgroup's score accumulator sc
// (register 4j + {0,1}: row ``row``, keys k0 + 8j + 2(lane % 4) + {0,1};
// 4j + {2,3}: the same keys of row + 8; r0 is the warpgroup's first row):
// masks keys >= S and, under the causal mask, keys past the row, on the
// ragged or diagonal tile only; updates the running maxima m (scaled by
// log2 e) and this thread's shares l of the row sums; rescales O; leaves
// P = exp2(s scale_log2 - m) in sc.
template <int BK, int D>
__device__ __forceinline__ void softmax_step(float (&sc)[BK / 2], float (&o)[D / 2], float& m0,
                                             float& m1, float& l0, float& l1, int k0, int r0,
                                             int row, int lane, int S, int causal,
                                             float scale_log2) {
  if (k0 + BK > S || (causal && k0 + BK - 1 > r0)) {  // the ragged or diagonal tile
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + 2 * (lane % 4) + e;
        if (key >= S || (causal && key > row)) sc[4 * j + e] = minus_inf();
        if (key >= S || (causal && key > row + 8)) sc[4 * j + 2 + e] = minus_inf();
      }
  }
  float mx0 = minus_inf(), mx1 = minus_inf();
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off <= 2; off *= 2) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // key 0 is valid for every row and tile 0 comes first, so the new maxima
  // are finite and exp2(m - m_new) never sees -inf - -inf
  const float mn0 = fmaxf(m0, mx0 * scale_log2), mn1 = fmaxf(m1, mx1 * scale_log2);
  const float c0 = fast_exp2(m0 - mn0), c1 = fast_exp2(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j] = fast_exp2(fmaf(sc[4 * j], scale_log2, -mn0));
    sc[4 * j + 1] = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -mn0));
    sc[4 * j + 2] = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -mn1));
    sc[4 * j + 3] = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -mn1));
    ps0 += sc[4 * j] + sc[4 * j + 1];
    ps1 += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l0 = fmaf(l0, c0, ps0);  // this thread's share of the row sums
  l1 = fmaf(l1, c1, ps1);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    o[4 * j] *= c0;
    o[4 * j + 1] *= c0;
    o[4 * j + 2] *= c1;
    o[4 * j + 3] *= c1;
  }
}

// The row sums: the four lanes that share a row add their shares.
__device__ __forceinline__ float row_sum(float l) {
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  return l + __shfl_xor_sync(0xffffffffu, l, 2);
}

// ------------------------------------------------- K4, the wgmma path (bf16)
// Shared memory of one block (kernels/flash_attention.py:attention_smem_bytes
// mirrors it): the q tile, [warpgroup][box][64 rows][RB bytes]; the ring's K
// and V tiles, each [box][BK rows][RB bytes]; the full and empty barriers
// of the ring and the q tile's barrier.  A box is RB / 2 columns: 64 at
// head dim 64 and up, the whole row at 16 and 32.  Every tile is a whole
// number of 1024-byte blocks.
template <int D, int WGS, int BK>
struct FwTiles {
  static constexpr int BQ = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int RB = bf16_row_bytes(D);    // swizzled row bytes
  static constexpr int COLS = RB / 2;             // columns a box
  static constexpr int CHUNKS = D / COLS;         // boxes of a row
  static constexpr int WG_Q_BYTES = 64 * D * 2;   // one warpgroup's q (then o) tile
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + WGS * WG_Q_BYTES;
  static constexpr int V_OFF = K_OFF + FW_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + FW_STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * FW_STAGES + 1) * 8 + 1024;  // + alignment slack
  // two blocks an SM where their shared memory fits (one warpgroup each)
  static constexpr int MIN_BLOCKS = WGS == 1 && 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert((D % 64 == 0 || D == 16 || D == 32) && BK % 16 == 0 && K_OFF % 1024 == 0 &&
                KV_BYTES % 1024 == 0, "tiles of whole 1024-byte blocks");
};

// grid (q tiles, BH); the q tile of block x is n_tiles - 1 - x, so that the
// longest causal rows start first.  Warpgroup w owns q rows [q0 + 64 w,
// q0 + 64 w + 64); the producer warp comes after the warpgroups.
template <int D, int WGS, int BK>
__global__ void __launch_bounds__(FwTiles<D, WGS, BK>::THREADS, FwTiles<D, WGS, BK>::MIN_BLOCKS)
flash_attention_wgmma(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, int S, int causal,
                      float scale_log2) {
  using T = FwTiles<D, WGS, BK>;
  constexpr int RB = T::RB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem<1024>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + FW_STAGES;
  uint64_t* qbar = empty + FW_STAGES;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BQ;
  const int kend = causal ? min(S, q0 + T::BQ) : S;  // keys this block reads
  const int n_tiles = (kend + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // producer
    if (lane == 0) {
      // the warpgroups whose rows start before S (a box wholly past S is not read)
      const int live = min(WGS, (S - q0 + 63) / 64);
      mbar_expect_tx(qbar, live * T::WG_Q_BYTES);
      for (int w = 0; w < live; ++w)
        for (int c = 0; c < T::CHUNKS; ++c)
          tma_load_3d(smem + T::Q_OFF + w * T::WG_Q_BYTES + c * 64 * RB, &qmap, qbar,
                      c * T::COLS, q0 + 64 * w, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % FW_STAGES;
        if (t >= FW_STAGES) mbar_wait(&empty[s], ((t / FW_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * T::KV_BYTES);
        for (int c = 0; c < T::CHUNKS; ++c) {
          tma_load_3d(smem + T::K_OFF + s * T::KV_BYTES + c * BK * RB, &kmap, &full[s],
                      c * T::COLS, t * BK, bh);
          tma_load_3d(smem + T::V_OFF + s * T::KV_BYTES + c * BK * RB, &vmap, &full[s],
                      c * T::COLS, t * BK, bh);
        }
      }
    }
    return;
  }

  // consumers
  const int wg = threadIdx.x / 128;
  const int r0 = q0 + 64 * wg;                      // this warpgroup's first row
  const int lr = (warp % 4) * 16 + lane / 4;        // the thread's rows: lr and lr + 8
  const int row = r0 + lr;
  // tiles this warpgroup computes: none if its rows all lie past S; under
  // the causal mask, those up to its last row's diagonal
  const int my_tiles = r0 >= S ? 0 : causal ? (min(S, r0 + 64) + BK - 1) / BK : n_tiles;
  uint8_t* qs = smem + T::Q_OFF + wg * T::WG_Q_BYTES;
  const uint32_t qa = smem_u32(qs);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  fence_regs(o);
  float m0 = minus_inf(), m1 = minus_inf(), l0 = 0.f, l1 = 0.f;  // rows lr, lr + 8 (scaled by log2 e)
  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % FW_STAGES;
    mbar_wait(&full[s], (t / FW_STAGES) & 1);
    if (t < my_tiles) {
      // S = Q K^T: A = q tile, B = K tile, both K-major
      const uint32_t ka = smem_u32(smem + T::K_OFF + s * T::KV_BYTES);
      float sc[BK / 2];
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16<BK, 0>(sc, kmajor_desc<RB, 64>(qa, kk), kmajor_desc<RB, BK>(ka, kk), kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(sc);
      softmax_step<BK, D>(sc, o, m0, m1, l0, l1, t * BK, r0, row, lane, S, causal, scale_log2);
      // P as bf16 A fragments: k16 slice kk of the scores is registers
      // [8 kk, 8 kk + 8), in the order the A operand takes them
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      // O += P V: B = V tile, MN-major
      const uint32_t va = smem_u32(smem + T::V_OFF + s * T::KV_BYTES);
      fence_regs(o);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_bf16<D>(o, pa[kk], mnmajor_desc<RB, BK>(va, kk));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }
  if (my_tiles == 0) return;

  // o / max(l, 1e-30) as bf16 into this warpgroup's q tile (no longer read),
  // in the q tile's swizzle, then one TMA store a box; rows >= S fall
  // outside the tensor and are dropped
  const float inv0 = 1.f / fmaxf(row_sum(l0), 1e-30f), inv1 = 1.f / fmaxf(row_sum(l1), 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    // rows lr and lr + 8 share the swizzle: 8 rows are a whole atom
    uint8_t* p = qs + swizzle<RB>((col / T::COLS) * (64 * RB) + lr * RB + (col % T::COLS) * 2);
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(p + 8 * RB) = pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < T::CHUNKS; ++c)
      tma_store_3d(&omap, qs + c * 64 * RB, c * T::COLS, r0, bh);
    tma_store_wait();
  }
}

template <int D, int WGS, int BK>
cudaError_t launch_fw(const void* q, const void* k, const void* v, void* out, int BH, int S,
                      int causal, cudaStream_t stream) {
  using T = FwTiles<D, WGS, BK>;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (bases % 16 != 0 || BH > 65535) return cudaErrorInvalidValue;  // TMA bases; grid.y
  const int q_tiles = (S + T::BQ - 1) / T::BQ;
  cudaError_t err = raise_smem_limit<flash_attention_wgmma<D, WGS, BK>>(T::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap qmap, kmap, vmap, omap;
  const auto bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const auto sw = tma_swizzle(T::RB);
  if (!tensor_map_3d(&qmap, bf16, 2, q, BH, S, D, 64, T::COLS, sw) ||
      !tensor_map_3d(&kmap, bf16, 2, k, BH, S, D, BK, T::COLS, sw) ||
      !tensor_map_3d(&vmap, bf16, 2, v, BH, S, D, BK, T::COLS, sw) ||
      !tensor_map_3d(&omap, bf16, 2, out, BH, S, D, 64, T::COLS, sw))
    return cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_attention_wgmma<D, WGS, BK><<<dim3(q_tiles, BH), T::THREADS, T::SMEM, stream>>>(
      qmap, kmap, vmap, omap, S, causal, scale_log2);
  return cudaGetLastError();
}

// (block_q, block_k) of the plan: 64 or 128 query rows (one or two
// warpgroups) by 64 or 128 keys a tile at D 64 and 128.  D 256 takes 64 by
// 64 only: its O accumulator holds 128 registers a thread, and a block of
// two warpgroups and a producer warp is given registers as three
// warpgroups (168 a thread).  D 16 adds 128 by 64 (faster at S 128 on an
// H100), D 32 takes the plan's 64 by 64 alone.
template <int D>
cudaError_t dispatch_fw_tile(int block_q, int block_k, const void* q, const void* k,
                             const void* v, void* out, int BH, int S, int causal,
                             cudaStream_t st) {
  if (block_q == 64 && block_k == 64) return launch_fw<D, 1, 64>(q, k, v, out, BH, S, causal, st);
  if constexpr (D == 16 || D == 64 || D == 128) {
    if (block_q == 128 && block_k == 64)
      return launch_fw<D, 2, 64>(q, k, v, out, BH, S, causal, st);
  }
  if constexpr (D == 64 || D == 128) {
    if (block_q == 64 && block_k == 128)
      return launch_fw<D, 1, 128>(q, k, v, out, BH, S, causal, st);
    if (block_q == 128 && block_k == 128)
      return launch_fw<D, 2, 128>(q, k, v, out, BH, S, causal, st);
  }
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_fw(const void* q, const void* k, const void* v, void* out, int BH, int S,
                        int D, int causal, int block_q, int block_k, cudaStream_t st) {
  switch (D) {
    case 16: return dispatch_fw_tile<16>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 32: return dispatch_fw_tile<32>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 64: return dispatch_fw_tile<64>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 128: return dispatch_fw_tile<128>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 256: return dispatch_fw_tile<256>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- K4, the split path (f32)
// Shared memory of one block (kernels/flash_attention.py:attention_smem_bytes
// mirrors it), each region on a 1024-byte boundary:
//   Q_OFF    q hi, then q lo, bf16 [box][BQ rows][RB bytes] in the swizzle of
//            the wgmma path (warpgroup w's A operand starts at row 64 w); at
//            the end the f32 output tile, [box][BQ rows][ORB bytes]
//            swizzled, over the same bytes
//   S_OFF    K hi, K lo, V hi, V lo, bf16 [box][BK rows][RB bytes]; before
//            the first key tile, the f32 q tile [BQ][D] as TMA lands it
//   F_OFF    the f32 K and V tiles of the next key tile, [BK][D] each: one
//            stage, the split tiles being the second buffer (a second f32
//            stage was slower in every row of attn_sweep)
//   BAR_OFF  the f32 tiles' full and empty barriers, the q tile's barrier
template <int D, int WGS, int BK>
struct FsTiles {
  static constexpr int BQ = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;    // + one producer warp
  static constexpr int RB = bf16_row_bytes(D);
  static constexpr int ORB = D >= 32 ? 128 : 4 * D; // an f32 output row's swizzled bytes
  static constexpr int Q_BF = BQ * D * 2;           // q hi or q lo
  static constexpr int KV_BF = BK * D * 2;          // K hi, K lo, V hi or V lo
  static constexpr int KV_F32 = BK * D * 4;         // an f32 K or V tile
  static constexpr int SPLIT_BYTES = 4 * KV_BF > BQ * D * 4 ? 4 * KV_BF : BQ * D * 4;
  static constexpr int Q_OFF = 0;
  static constexpr int S_OFF = Q_OFF + 2 * Q_BF;
  static constexpr int F_OFF = S_OFF + SPLIT_BYTES;
  static constexpr int BAR_OFF = F_OFF + 2 * KV_F32;
  static constexpr int SMEM = BAR_OFF + 3 * 8 + 1024;  // + alignment slack
  static constexpr int MIN_BLOCKS = WGS == 1 && 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(BK % 16 == 0 && Q_BF % 1024 == 0 && KV_BF % 1024 == 0 && SMEM <= 232448,
                "tiles of whole 1024-byte blocks, within a block's shared memory");
};

template <int N>
__device__ __forceinline__ void consumers_sync() {  // the N consumer threads only
  asm volatile("bar.sync 1, %0;\n" :: "n"(N) : "memory");
}

// An f32 tile (ROWS x D, row-major, as TMA lands it) split into bf16 hi and
// lo tiles in the swizzled layout the products read ([box][ROWS][RB]).  The
// NT consumer threads take float4 tid, tid + NT, ...: a quarter warp loads
// 128 consecutive bytes, and a half warp stores 8 bytes a thread into 128
// bytes that the swizzle only permutes, so neither side has a bank conflict.
// Rows from ``rows_in`` on are not read and split as zeros.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void split_tile(const float* src, uint8_t* hi, uint8_t* lo, int tid,
                                           int rows_in = ROWS) {
  constexpr int RB = bf16_row_bytes(D), COLS = RB / 2, N4 = ROWS * D / 4;
#pragma unroll
  for (int it = 0; it < (N4 + NT - 1) / NT; ++it) {
    const int i = tid + NT * it;
    if (N4 % NT != 0 && i >= N4) break;
    const int r = 4 * i / D, c = 4 * i % D;
    const float4 x = r < rows_in ? reinterpret_cast<const float4*>(src)[i]
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
    const uint32_t off = swizzle<RB>((c / COLS) * (ROWS * RB) + r * RB + (c % COLS) * 2);
    uint2 h, l;
    split_bf16(x.x, x.y, h.x, l.x);
    split_bf16(x.z, x.w, h.y, l.y);
    *reinterpret_cast<uint2*>(hi + off) = h;
    *reinterpret_cast<uint2*>(lo + off) = l;
  }
}

// grid (q tiles, BH), the longest causal rows first as on the wgmma path.
// WGS consumer warpgroups own 64 q rows each, [q0 + 64 w, q0 + 64 w + 64),
// and share every key tile (two warpgroups read K and V from L2 half as
// often as two blocks of one); the producer warp streams f32 tiles by TMA.
// Per key tile all consumers split K and V together, which frees the f32
// tiles for the next tile's copy; then a warpgroup computes S = Q_hi
// K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T (three wgmma chains into one f32
// accumulator), the online softmax, P split in registers, and O += P_hi
// V_hi + P_hi V_lo + P_lo V_hi.
template <int D, int WGS, int BK>
__global__ void __launch_bounds__(FsTiles<D, WGS, BK>::THREADS, FsTiles<D, WGS, BK>::MIN_BLOCKS)
flash_attention_split(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      const __grid_constant__ CUtensorMap omap, int S, int causal,
                      float scale_log2) {
  using T = FsTiles<D, WGS, BK>;
  constexpr int RB = T::RB, ORB = T::ORB, OC = ORB / 4;  // OC: f32 columns an output box
  constexpr int NT = T::CONSUMERS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem<1024>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + 1;
  uint64_t* qbar = full + 2;
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * T::BQ;
  const int kend = causal ? min(S, q0 + T::BQ) : S;  // keys this block reads
  const int n_tiles = (kend + BK - 1) / BK;
  const int live = min(WGS, (S - q0 + 63) / 64);     // warpgroups whose rows start before S
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    mbar_init(full, 1);
    mbar_init(empty, 4 * WGS);  // one arrival per consumer warp
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  uint8_t* kf = smem + T::F_OFF;  // the f32 K tile, then the V tile
  if (warp == 4 * WGS) {  // producer
    if (lane == 0) {
      // the live warpgroups' q boxes (a box wholly past S is not read)
      mbar_expect_tx(qbar, live * 64 * D * 4);
      for (int w = 0; w < live; ++w)
        tma_load_3d(smem + T::S_OFF + w * 64 * D * 4, &qmap, qbar, 0, q0 + 64 * w, bh);
      for (int t = 0; t < n_tiles; ++t) {
        if (t > 0) mbar_wait(empty, (t - 1) & 1);
        mbar_expect_tx(full, 2 * T::KV_F32);
        tma_load_3d(kf, &kmap, full, 0, t * BK, bh);
        tma_load_3d(kf + T::KV_F32, &vmap, full, 0, t * BK, bh);
      }
    }
    return;
  }

  // the consumers.  Every warpgroup computes every key tile of the block:
  // a branch around wgmma makes ptxas serialise it (C7518), so under the
  // causal mask the first warpgroup's tiles past its diagonal run, fully
  // masked (P = 0, the correction 1), and a warpgroup whose rows all lie
  // past S computes, on a zero q, rows that are not stored
  const int tid = threadIdx.x, wg = tid / 128;
  const int r0 = q0 + 64 * wg;                  // this warpgroup's first row
  const int lr = (warp % 4) * 16 + lane / 4;    // the thread's rows: lr and lr + 8
  const int row = r0 + lr;
  uint8_t* qs = smem + T::Q_OFF;                // q hi, q lo; at the end the output
  uint8_t* ks = smem + T::S_OFF;                // K hi, K lo, V hi, V lo
  const uint32_t qh = smem_u32(qs) + wg * 64 * RB, ql = qh + T::Q_BF;
  const uint32_t kh = smem_u32(ks), kl = kh + T::KV_BF, vh = kl + T::KV_BF, vl = vh + T::KV_BF;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  fence_regs(o);
  float m0 = minus_inf(), m1 = minus_inf(), l0 = 0.f, l1 = 0.f;  // rows lr, lr + 8 (scaled by log2 e)
  mbar_wait(qbar, 0);
  split_tile<D, T::BQ, NT>(reinterpret_cast<const float*>(ks), qs, qs + T::Q_BF, tid, 64 * live);
  for (int t = 0; t < n_tiles; ++t) {
    mbar_wait(full, t & 1);
    consumers_sync<NT>();  // the f32 q tile (t = 0) or the last tile's split tiles are read
    split_tile<D, BK, NT>(reinterpret_cast<const float*>(kf), ks, ks + T::KV_BF, tid);
    split_tile<D, BK, NT>(reinterpret_cast<const float*>(kf + T::KV_F32), ks + 2 * T::KV_BF,
                          ks + 3 * T::KV_BF, tid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for wgmma's reads
    consumers_sync<NT>();
    __syncwarp();
    if (lane == 0) mbar_arrive(empty);  // the f32 tiles may be refilled
    // S = Q_hi K_hi^T + Q_hi K_lo^T + Q_lo K_hi^T, all K-major
    float sc[BK / 2];
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16<BK, 0>(sc, kmajor_desc<RB, T::BQ>(qh, kk), kmajor_desc<RB, BK>(kh, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16<BK, 0>(sc, kmajor_desc<RB, T::BQ>(qh, kk), kmajor_desc<RB, BK>(kl, kk));
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_bf16<BK, 0>(sc, kmajor_desc<RB, T::BQ>(ql, kk), kmajor_desc<RB, BK>(kh, kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(sc);
    softmax_step<BK, D>(sc, o, m0, m1, l0, l1, t * BK, r0, row, lane, S, causal, scale_log2);
    // P = P_hi + P_lo as bf16 A fragments (k16 slice kk: registers [8 kk, 8 kk + 8))
    uint32_t ph[BK / 16][4], pl[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1], ph[kk][i], pl[kk][i]);
    // O += P_hi V_hi + P_hi V_lo + P_lo V_hi, V MN-major
    fence_regs(o);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_bf16<D>(o, ph[kk], mnmajor_desc<RB, BK>(vh, kk));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_bf16<D>(o, ph[kk], mnmajor_desc<RB, BK>(vl, kk));
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_bf16<D>(o, pl[kk], mnmajor_desc<RB, BK>(vh, kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(o);
  }

  // o / max(l, 1e-30) in f32 over q hi and lo (every warp's products are
  // done with them after the barrier), [box of OC columns][BQ rows][ORB
  // bytes] swizzled, then one TMA store a box and warpgroup; rows >= S
  // are dropped
  const float inv0 = 1.f / fmaxf(row_sum(l0), 1e-30f), inv1 = 1.f / fmaxf(row_sum(l1), 1e-30f);
  consumers_sync<NT>();
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    // rows lr and lr + 8 share the swizzle: 8 rows are a whole atom
    uint8_t* p = qs + swizzle<ORB>((col / OC) * (T::BQ * ORB) + (64 * wg + lr) * ORB +
                                   (col % OC) * 4);
    *reinterpret_cast<float2*>(p) = make_float2(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<float2*>(p + 8 * ORB) = make_float2(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  consumers_sync<NT>();
  if (tid % 128 == 0 && r0 < S) {
    for (int c = 0; c < D / OC; ++c)
      tma_store_3d(&omap, qs + c * T::BQ * ORB + 64 * wg * ORB, c * OC, r0, bh);
    tma_store_wait();
  }
}

template <int D, int WGS, int BK>
cudaError_t launch_fs(const void* q, const void* k, const void* v, void* out, int BH, int S,
                      int causal, cudaStream_t stream) {
  using T = FsTiles<D, WGS, BK>;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(out);
  if (bases % 16 != 0 || BH > 65535) return cudaErrorInvalidValue;  // TMA bases; grid.y
  cudaError_t err = raise_smem_limit<flash_attention_split<D, WGS, BK>>(T::SMEM);
  if (err != cudaSuccess) return err;
  // q, K and V land unswizzled ([rows][D] f32; a box row is at most 256
  // floats); the output leaves through the swizzle of its smem tile
  CUtensorMap qmap, kmap, vmap, omap;
  const auto f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const auto none = CU_TENSOR_MAP_SWIZZLE_NONE;
  if (!tensor_map_3d(&qmap, f32, 4, q, BH, S, D, 64, D, none) ||
      !tensor_map_3d(&kmap, f32, 4, k, BH, S, D, BK, D, none) ||
      !tensor_map_3d(&vmap, f32, 4, v, BH, S, D, BK, D, none) ||
      !tensor_map_3d(&omap, f32, 4, out, BH, S, D, 64, T::ORB / 4, tma_swizzle(T::ORB)))
    return cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_attention_split<D, WGS, BK>
      <<<dim3((S + T::BQ - 1) / T::BQ, BH), T::THREADS, T::SMEM, stream>>>(
          qmap, kmap, vmap, omap, S, causal, scale_log2);
  return cudaGetLastError();
}

// (block_q, block_k) of the plan (kernels/flash_attention.py:
// ATTN_SPLIT_TILES): one warpgroup of 64 query rows by 64 or 32 keys up to
// head dim 64, two warpgroups (128 rows) by 64 keys at 64 and 128, one by
// 32 keys at 128 and 256 (a 64-key tile does not fit at 256).
template <int D>
cudaError_t dispatch_fs_tile(int block_q, int block_k, const void* q, const void* k,
                             const void* v, void* out, int BH, int S, int causal,
                             cudaStream_t st) {
#define REPRO_FS_TILE(BQ, BK)                                                                 \
  if (block_q == BQ && block_k == BK)                                                          \
    return launch_fs<D, BQ / 64, BK>(q, k, v, out, BH, S, causal, st)
  REPRO_FS_TILE(64, 32);
  if constexpr (D <= 64) REPRO_FS_TILE(64, 64);
  if constexpr (D == 64 || D == 128) REPRO_FS_TILE(128, 64);
#undef REPRO_FS_TILE
  return cudaErrorInvalidValue;
}

cudaError_t dispatch_fs(const void* q, const void* k, const void* v, void* out, int BH, int S,
                        int D, int causal, int block_q, int block_k, cudaStream_t st) {
  switch (D) {
    case 16: return dispatch_fs_tile<16>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 32: return dispatch_fs_tile<32>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 64: return dispatch_fs_tile<64>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 128: return dispatch_fs_tile<128>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 256: return dispatch_fs_tile<256>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- K5
constexpr int FD_WARPS = 8;
constexpr int FD_THREADS = 32 * FD_WARPS;
constexpr int FD_T = 16;                  // tokens of one step (a page of 16)
constexpr int FD_RING_BYTES = 96 * 1024;  // the cp.async ring: 2-8 stages
constexpr int FD_GROUP = 8;               // queries a block takes at most
constexpr int FD_MAXG = 16;               // queries per KV head
constexpr int FD_MAX_SPLIT = 16;          // blocks of a cluster (above 8: non-portable)
constexpr int FD_MAX_PAGES = 512;         // pages a block's range holds at most
constexpr int FD_MAX_SMEM = 232448;
// 4-byte words of the small arrays: the range's valid pages (pool row and
// table index) [FD_MAX_PAGES] each and the scan's warp counts
// [FD_WARPS]; the warps' m, l and merge weights [FD_WARPS][FD_GROUP] and
// their corrections and p [FD_WARPS][5][FD_GROUP]; the ranks' m and l
// [FD_MAX_SPLIT][FD_GROUP] and their merge weights, the same
constexpr int FD_SMALL_WORDS =
    2 * FD_MAX_PAGES + FD_WARPS + 8 * FD_WARPS * FD_GROUP + 3 * FD_MAX_SPLIT * FD_GROUP;

// Rows a ring stage holds: 32 (two steps) when a head row is at most 512
// bytes, else 16.
__host__ __device__ constexpr int fd_stage_rows(int hd, int es) {
  return hd * es <= 512 ? 2 * FD_T : FD_T;
}

__host__ __device__ constexpr int fd_stages(int hd, int es) {
  const int n = FD_RING_BYTES / (2 * fd_stage_rows(hd, es) * hd * es);
  return n < 2 ? 2 : n > 8 ? 8 : n;
}

// Dynamic shared memory of one block (kernels/flash_attention.py:
// decode_smem_bytes mirrors it): the ring of K and V stages, which the
// warps' partial accumulators reuse once the pages are done; the slices
// of the outputs the cluster's blocks send this one (GB x hd floats and one
// float4 a rank to spare); the small arrays.
__host__ __device__ constexpr size_t fd_smem_bytes(int group, int hd, int es) {
  const size_t ring = (size_t)fd_stages(hd, es) * 2 * fd_stage_rows(hd, es) * hd * es;
  const size_t warps = (size_t)FD_WARPS * group * hd * 4;
  return (ring > warps ? ring : warps) + 4 * ((size_t)group * hd + 4 * FD_MAX_SPLIT) +
         4 * (size_t)FD_SMALL_WORDS;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// N adjacent elements of a staged row (N * sizeof(T) bytes, aligned to
// that size) as floats; bf16 widens exactly
template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&f)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      f[i] = v.x; f[i + 1] = v.y; f[i + 2] = v.z; f[i + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x; f[1] = v.y;
  } else {
    f[0] = *p;
  }
}
template <int N>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&f)[N]) {
  if constexpr (N % 2 == 0) {
    uint32_t w[N / 2];
    if constexpr (N % 8 == 0) {
#pragma unroll
      for (int i = 0; i < N / 2; i += 4) {
        const uint4 v = *reinterpret_cast<const uint4*>(p + 2 * i);
        w[i] = v.x; w[i + 1] = v.y; w[i + 2] = v.z; w[i + 3] = v.w;
      }
    } else if constexpr (N == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
    f[0] = __bfloat162float(*p);
  }
}

// Sums v[g] over the warp's 32 lanes for NV = 2^K values at once: K
// halving steps (each lane keeps one half and trades the other with its
// partner), then 5 - K full steps: NV - 1 + 5 - K shuffles instead of
// 5 NV.  Returns, in every lane, the total of v[lane >> (5 - K)].
template <int NV>
__device__ __forceinline__ float warp_reduce_scatter(float (&v)[NV], int lane) {
  constexpr int K = NV == 1 ? 0 : NV == 2 ? 1 : NV == 4 ? 2 : NV == 8 ? 3 : 4;
  static_assert(NV == 1 << K, "a power of two up to 16 values");
#pragma unroll
  for (int step = 0; step < K; ++step) {
    const int h = NV >> (step + 1), off = 16 >> step;
    const bool up = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const float send = up ? v[i] : v[i + h];
      const float keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float r = v[0];
#pragma unroll
  for (int off = 16 >> K; off >= 1; off /= 2) r += __shfl_xor_sync(0xffffffffu, r, off);
  return r;
}

// grid (split, KV * ceil(G / GB), B), cluster (split, 1, 1): block r of the
// cluster of (KV head h, queries [g0, g0 + GB), slot b) takes pages
// [r * pages_per_block, (r + 1) * pages_per_block) of the slot's table.
// Lane l holds elements [l * EPL, (l + 1) * EPL) of every head row.
template <typename PT, int HD, int GB>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_split(const void* __restrict__ q, int q_bf16, const PT* __restrict__ k_pages,
                   const PT* __restrict__ v_pages, const int* __restrict__ page_table,
                   const int* __restrict__ lengths, float* __restrict__ acc_out,
                   float* __restrict__ m_out, float* __restrict__ l_out, int KV, int G, int page,
                   int n_pmax, int pages_per_block, float scale) {
  constexpr int ES = static_cast<int>(sizeof(PT));
  constexpr int UNITS = HD * ES / 16;             // 16-byte units of a head row
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;     // row elements a lane
  constexpr int ACTIVE = HD / EPL;                // lanes that hold elements
  constexpr int RS = fd_stage_rows(HD, ES);       // rows a stage
  constexpr int STEPS = RS / FD_T;                // steps a stage
  constexpr int TOK = RS / FD_WARPS;              // rows a warp takes in a stage
  constexpr int RPS = FD_T / FD_WARPS;            // of them in one step
  constexpr int TPR = GB * EPL <= 32 ? TOK : 2;   // rows a round (registers)
  constexpr int STAGES = fd_stages(HD, ES);
  constexpr int SH = GB == 1 ? 5 : GB == 2 ? 4 : GB == 4 ? 3 : 2;
  static_assert((UNITS & (UNITS - 1)) == 0 && GB <= FD_GROUP && (GB & (GB - 1)) == 0 &&
                TOK % TPR == 0, "shapes");
  extern __shared__ __align__(16) uint8_t fd_smem[];
  // this block has started: a peer may write into its shared memory once
  // the matching wait (before the merge) returns
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int csize = static_cast<int>(cluster.num_blocks());
  const int ngh = (G + GB - 1) / GB;
  const int h = blockIdx.y / ngh, g0 = (blockIdx.y % ngh) * GB, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int e0 = lane * EPL;                      // this lane's row slice
  const bool active = lane < ACTIVE;
  const size_t ring_bytes = (size_t)STAGES * 2 * RS * HD * ES;
  const size_t warp_bytes = (size_t)FD_WARPS * GB * HD * 4;
  uint4* ring = reinterpret_cast<uint4*>(fd_smem);
  float* wacc = reinterpret_cast<float*>(fd_smem);  // after the pages: [warp][g][HD]
  // the output slices the ranks send this block: [rank][per] float4s
  float4* racc = reinterpret_cast<float4*>(fd_smem + (ring_bytes > warp_bytes ? ring_bytes
                                                                              : warp_bytes));
  int* vpid = reinterpret_cast<int*>(racc + GB * HD / 4 + FD_MAX_SPLIT);
  int* vj = vpid + FD_MAX_PAGES;
  int* wcount = vj + FD_MAX_PAGES;
  float* wm = reinterpret_cast<float*>(wcount + FD_WARPS);  // [warp][FD_GROUP]
  float* wl = wm + FD_WARPS * FD_GROUP;
  float* ww = wl + FD_WARPS * FD_GROUP;           // the warps' merge weights
  float* wp = ww + FD_WARPS * FD_GROUP;           // [warp][corr, p of 4 rows][FD_GROUP]
  float* rm = wp + FD_WARPS * 5 * FD_GROUP;       // [rank][FD_GROUP]: the ranks' m, l
  float* rl = rm + FD_MAX_SPLIT * FD_GROUP;
  float* wq = rl + FD_MAX_SPLIT * FD_GROUP;       // the ranks' merge weights
  float* my_p = wp + warp * 5 * FD_GROUP;

  const size_t qrow = ((size_t)b * KV + h) * G + g0;  // row of (b, h, g0)
  // q for this block's queries in registers, pre-scaled
  float qr[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      float v = 0.f;
      if (active && g0 + g < G) {
        const size_t i = (qrow + g) * HD + e0 + e;
        v = q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(q)[i])
                   : static_cast<const float*>(q)[i];
      }
      qr[g][e] = v * scale;
    }
  }

  // The range's valid pages, in order: allocated (entry >= 0) and starting
  // before the length; neither a -1 entry nor a page past the length is
  // ever read from the pool.  A block-wide scan compacts them into vpid
  // (pool row) and vj (table index); every page but the last is full.
  const int len = lengths[b];
  const int* pt_row = page_table + (size_t)b * n_pmax;
  const int j0 = rank * pages_per_block, j1 = min(n_pmax, j0 + pages_per_block);
  int n_pages = 0;
  for (int base = j0; base < j1; base += FD_THREADS) {
    const int j = base + tid;
    const int pid = j < j1 && j * page < len ? pt_row[j] : -1;
    const unsigned ballot = __ballot_sync(0xffffffffu, pid >= 0);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < FD_WARPS; ++w) {
      before += w < warp ? wcount[w] : 0;
      total += wcount[w];
    }
    if (pid >= 0) {
      const int i = n_pages + before + __popc(ballot & ((1u << lane) - 1));
      vpid[i] = pid;
      vj[i] = j;
    }
    n_pages += total;
    __syncthreads();  // wcount is read; vpid, vj are written
  }
  // step s: tokens [t0, t0 + 16) of valid page s / spp (spp steps a page)
  const int spp = (page + FD_T - 1) / FD_T;
  const int n_steps =
      n_pages == 0 ? 0
                   : (n_pages - 1) * spp +
                         (min(page, len - vj[n_pages - 1] * page) + FD_T - 1) / FD_T;
  auto step_tokens = [&](int st) {
    const int p = st / spp, t0 = (st - p * spp) * FD_T;
    return st < n_steps ? min(FD_T, min(page - t0, len - vj[p] * page - t0)) : 0;
  };
  const int n_iter = (n_steps + STEPS - 1) / STEPS;  // ring stages to compute

  // stage ``it`` (steps [it * STEPS, (it + 1) * STEPS)) into ring slot ``s``,
  // step k into rows [16 k, 16 k + 16): 16-byte copies, a token's row
  // contiguous across threads; tokens past the length are not copied
  auto issue = [&](int it, int s) {
    uint4* dst = ring + s * 2 * RS * UNITS;
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
      const int st = it * STEPS + k, n = step_tokens(st);
      if (n == 0) break;
      const int p = st / spp;
      const size_t row0 = (size_t)vpid[p] * page + (st - p * spp) * FD_T;
      for (int i = tid; i < n * UNITS; i += FD_THREADS) {
        const int t = i / UNITS, u = i % UNITS;
        const size_t src = ((row0 + t) * KV + h) * HD + u * (16 / ES);
        cp_async16(dst + k * FD_T * UNITS + i, k_pages + src);
        cp_async16(dst + (RS + k * FD_T) * UNITS + i, v_pages + src);
      }
    }
  };
  for (int s = 0; s < STAGES - 1; ++s) {  // one group a stage, empty or not
    if (s < n_iter) issue(s, s);
    cp_async_commit();
  }

  // Each warp keeps its own online softmax over the rows it takes (warp w
  // takes rows w, w + FD_WARPS, ... of every stage): m and l of query
  // lane >> SH in every lane, acc[g][EPL] of every query in every lane.
  float m_r = NEG_INF, l_r = 0.f;
  float acc[GB][EPL];
#pragma unroll
  for (int g = 0; g < GB; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int s = it % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage it landed; the slot refilled next was consumed
    if (it + STAGES - 1 < n_iter) issue(it + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    int n[STEPS];  // tokens of each step in this stage
#pragma unroll
    for (int k = 0; k < STEPS; ++k) n[k] = step_tokens(it * STEPS + k);
    bool mine = false;  // warp-uniform: a row of this warp holds a token
#pragma unroll
    for (int k = 0; k < STEPS; ++k) mine |= warp < n[k];
    if (mine) {
      const PT* ks = reinterpret_cast<const PT*>(ring + s * 2 * RS * UNITS);
      const PT* vs = ks + RS * HD;
#pragma unroll
      for (int r0 = 0; r0 < TOK; r0 += TPR) {
        bool valid[TPR];
        float sc[TPR];
#pragma unroll
        for (int j = 0; j < TPR; ++j) {
          const int row = warp + (r0 + j) * FD_WARPS;  // of step (r0 + j) / RPS
          valid[j] = ((r0 + j) % RPS) * FD_WARPS + warp < n[(r0 + j) / RPS];
          float part[GB];
#pragma unroll
          for (int g = 0; g < GB; ++g) part[g] = 0.f;
          if (active && valid[j]) {
            float kf[EPL];
            load_row<EPL>(ks + row * HD + e0, kf);
#pragma unroll
            for (int g = 0; g < GB; ++g)
#pragma unroll
              for (int e = 0; e < EPL; ++e) part[g] = fmaf(qr[g][e], kf[e], part[g]);
          }
          sc[j] = warp_reduce_scatter<GB>(part, lane);
        }
        // the softmax of query lane >> SH over the warp's rows so far
        float m_new = m_r;
#pragma unroll
        for (int j = 0; j < TPR; ++j)
          if (valid[j]) m_new = fmaxf(m_new, sc[j]);
        const float corr = expf(m_r - m_new);
        float psum = 0.f;
        __syncwarp();  // the previous round's p and corrections are read
        const bool writer = (lane & ((1 << SH) - 1)) == 0;
#pragma unroll
        for (int j = 0; j < TPR; ++j) {
          const float p = valid[j] ? expf(sc[j] - m_new) : 0.f;
          psum += p;
          if (writer) my_p[(1 + j) * FD_GROUP + (lane >> SH)] = p;
        }
        if (writer) my_p[lane >> SH] = corr;
        l_r = fmaf(l_r, corr, psum);
        m_r = m_new;
        __syncwarp();
        // every query's correction and p, read back as broadcasts
        float cv[GB];
        load_row<GB>(my_p, cv);
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] *= cv[g];
#pragma unroll
        for (int j = 0; j < TPR; ++j) {
          if (!valid[j]) continue;  // warp-uniform
          float vf[EPL];
#pragma unroll
          for (int e = 0; e < EPL; ++e) vf[e] = 0.f;
          if (active) load_row<EPL>(vs + (warp + (r0 + j) * FD_WARPS) * HD + e0, vf);
          float pv[GB];
          load_row<GB>(my_p + (1 + j) * FD_GROUP, pv);
#pragma unroll
          for (int g = 0; g < GB; ++g)
#pragma unroll
            for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pv[g], vf[e], acc[g][e]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the ring; its memory is reused

  // Merge the warps' partials (fixed order) into the block's, then the
  // cluster's.  A warp, or a whole block, that saw no token holds m =
  // -1e30, l = 0, acc = 0 and adds nothing (exp(-1e30 - m) = 0); a slot
  // with no token at all gives exactly that, as the reference does.
  if ((lane & ((1 << SH) - 1)) == 0) {
    wm[warp * FD_GROUP + (lane >> SH)] = m_r;
    wl[warp * FD_GROUP + (lane >> SH)] = l_r;
  }
  if (active) {
#pragma unroll
    for (int g = 0; g < GB; ++g)
#pragma unroll
      for (int e = 0; e < EPL; ++e) wacc[(warp * GB + g) * HD + e0 + e] = acc[g][e];
  }
  __syncthreads();
  // Block r sends every block of the cluster its partial m and l, and block
  // q the slice q of its partial acc (stores into distributed shared memory
  // do not wait on the peer); after one cluster barrier each block merges
  // what it received, in rank order.  Every block reaches both cluster
  // barriers, whether its range held a token or not.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // every peer has started
  if (tid < GB) {
    float mv = NEG_INF;
    for (int w = 0; w < FD_WARPS; ++w) mv = fmaxf(mv, wm[w * FD_GROUP + tid]);
    float lv = 0.f;
    for (int w = 0; w < FD_WARPS; ++w) {
      const float c = expf(wm[w * FD_GROUP + tid] - mv);
      ww[w * FD_GROUP + tid] = c;
      lv = fmaf(wl[w * FD_GROUP + tid], c, lv);
    }
    for (int r = 0; r < csize; ++r) {
      cluster.map_shared_rank(rm, r)[rank * FD_GROUP + tid] = mv;
      cluster.map_shared_rank(rl, r)[rank * FD_GROUP + tid] = lv;
    }
  }
  __syncthreads();
  const int total4 = GB * HD / 4, per = (total4 + csize - 1) / csize;
  for (int o = tid; o < total4; o += FD_THREADS) {
    const int g = o / (HD / 4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < FD_WARPS; ++w) {
      const float c = ww[w * FD_GROUP + g];
      const float4 v = reinterpret_cast<const float4*>(wacc + w * GB * HD)[o];
      a.x = fmaf(v.x, c, a.x);
      a.y = fmaf(v.y, c, a.y);
      a.z = fmaf(v.z, c, a.z);
      a.w = fmaf(v.w, c, a.w);
    }
    const int dst = o / per;
    cluster.map_shared_rank(racc, dst)[rank * per + o - dst * per] = a;
  }
  cluster.sync();  // every block's m, l and acc slices have arrived
  if (tid < GB) {
    float mv = NEG_INF;
    for (int r = 0; r < csize; ++r) mv = fmaxf(mv, rm[r * FD_GROUP + tid]);
    float lv = 0.f;
    for (int r = 0; r < csize; ++r) {
      const float c = expf(rm[r * FD_GROUP + tid] - mv);
      wq[r * FD_GROUP + tid] = c;
      lv = fmaf(rl[r * FD_GROUP + tid], c, lv);
    }
    if (rank == 0 && g0 + tid < G) {
      m_out[qrow + tid] = mv;
      l_out[qrow + tid] = lv;
    }
  }
  __syncthreads();
  const int gq4 = min(GB, G - g0) * HD / 4;  // this block's queries' outputs
  for (int o = rank * per + tid; o < min(gq4, (rank + 1) * per); o += FD_THREADS) {
    const int g = o / (HD / 4);
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < csize; ++r) {
      const float c = wq[r * FD_GROUP + g];
      const float4 v = racc[r * per + o - rank * per];
      a.x = fmaf(v.x, c, a.x);
      a.y = fmaf(v.y, c, a.y);
      a.z = fmaf(v.z, c, a.z);
      a.w = fmaf(v.w, c, a.w);
    }
    reinterpret_cast<float4*>(acc_out + qrow * HD)[o] = a;
  }
}

template <typename PT, int HD, int GB>
cudaError_t launch_fd(const void* q, int q_bf16, const void* kp, const void* vp,
                      const void* pt, const void* len, void* acc, void* m, void* l, int B,
                      int KV, int G, int page, int n_pmax, int split, int pages_per_block,
                      cudaStream_t stream) {
  const int ngh = (G + GB - 1) / GB;
  const bool covers = n_pmax > 0 ? ((long long)split * pages_per_block >= n_pmax &&
                                    (long long)(split - 1) * pages_per_block < n_pmax)
                                 : split == 1;
  if (G < 1 || G > FD_MAXG || page < 1 || split < 1 || split > FD_MAX_SPLIT ||
      pages_per_block < 1 || pages_per_block > FD_MAX_PAGES || !covers || (long long)KV * ngh > 65535 || B > 65535 ||
      reinterpret_cast<uintptr_t>(kp) % 16 != 0 || reinterpret_cast<uintptr_t>(vp) % 16 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = fd_smem_bytes(GB, HD, static_cast<int>(sizeof(PT)));
  if (smem > FD_MAX_SMEM) return cudaErrorInvalidValue;
  cudaError_t err = raise_smem_limit<flash_decode_split<PT, HD, GB>>(smem);
  if (err != cudaSuccess) return err;
  static bool non_portable = false;  // clusters of 9-16 blocks, asked for once
  if (split > 8 && !non_portable) {
    err = cudaFuncSetAttribute(flash_decode_split<PT, HD, GB>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, KV * ngh, B);
  cfg.blockDim = dim3(FD_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, flash_decode_split<PT, HD, GB>, q, q_bf16,
                            static_cast<const PT*>(kp), static_cast<const PT*>(vp),
                            static_cast<const int*>(pt), static_cast<const int*>(len),
                            static_cast<float*>(acc), static_cast<float*>(m),
                            static_cast<float*>(l), KV, G, page, n_pmax, pages_per_block,
                            1.f / sqrtf(static_cast<float>(HD)));
}

// the queries a block takes (the plan's group): 1, 2, 4 or 8, whose q and
// accumulators live in registers
template <typename PT, int HD>
cudaError_t dispatch_group(int group, const void* q, int q_bf16, const void* kp,
                           const void* vp, const void* pt, const void* len, void* acc,
                           void* m, void* l, int B, int KV, int G, int page, int n_pmax,
                           int split, int ppb, cudaStream_t st) {
#define REPRO_FD_GROUP(GB)                                                                   \
  case GB:                                                                                   \
    return launch_fd<PT, HD, GB>(q, q_bf16, kp, vp, pt, len, acc, m, l, B, KV, G, page,      \
                                 n_pmax, split, ppb, st)
  switch (group) {
    REPRO_FD_GROUP(1);
    REPRO_FD_GROUP(2);
    REPRO_FD_GROUP(4);
    REPRO_FD_GROUP(8);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FD_GROUP
}

template <typename PT>
cudaError_t dispatch_fd(int hd, int group, const void* q, int q_bf16, const void* kp,
                        const void* vp, const void* pt, const void* len, void* acc, void* m,
                        void* l, int B, int KV, int G, int page, int n_pmax, int split,
                        int ppb, cudaStream_t st) {
#define REPRO_FD_HD(HD)                                                                      \
  case HD:                                                                                   \
    return dispatch_group<PT, HD>(group, q, q_bf16, kp, vp, pt, len, acc, m, l, B, KV, G,    \
                                  page, n_pmax, split, ppb, st)
  switch (hd) {
    REPRO_FD_HD(16);
    REPRO_FD_HD(32);
    REPRO_FD_HD(64);
    REPRO_FD_HD(128);
    REPRO_FD_HD(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_FD_HD
}

}  // namespace

// dtype: DT_F32 | DT_BF16 (q, k, v and out share it); path, block_q,
// block_k: the plan (kernels/flash_attention.py:plan_attention): bf16 on
// the wgmma path, f32 on the split path.  A plan the kernels do not take
// returns cudaErrorInvalidValue.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int BH, int S, int D, int causal,
                                     void* stream, int path, int block_q, int block_k) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == ATTN_WGMMA && dtype == DT_BF16)
    return dispatch_fw(q, k, v, out, BH, S, D, causal, block_q, block_k, st);
  if (path == ATTN_SPLIT && dtype == DT_F32)
    return dispatch_fs(q, k, v, out, BH, S, D, causal, block_q, block_k, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q_dtype, pool_dtype: DT_F32 | DT_BF16; split, pages_per_block, group: the
// plan (kernels/flash_attention.py:plan_decode).  Returns a cudaError_t.
extern "C" int repro_flash_decode(const void* q, int q_dtype, const void* k_pages,
                                  const void* v_pages, int pool_dtype, const void* page_table,
                                  const void* lengths, void* acc, void* m, void* l, int B,
                                  int KV, int G, int hd, int page, int n_pmax, void* stream,
                                  int split, int pages_per_block, int group) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype != DT_F32 && q_dtype != DT_BF16) return static_cast<int>(cudaErrorInvalidValue);
  const int q_bf16 = q_dtype == DT_BF16;
  if (pool_dtype == DT_F32)
    return dispatch_fd<float>(hd, group, q, q_bf16, k_pages, v_pages, page_table, lengths,
                              acc, m, l, B, KV, G, page, n_pmax, split, pages_per_block, st);
  if (pool_dtype == DT_BF16)
    return dispatch_fd<__nv_bfloat16>(hd, group, q, q_bf16, k_pages, v_pages, page_table,
                                      lengths, acc, m, l, B, KV, G, page, n_pmax, split,
                                      pages_per_block, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
