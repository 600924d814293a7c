// K4 flash_attention (prefill) and K5 flash_decode (paged decode).
//
// K4 replaces repro/kernels/flash_attention.py:flash_attention_kernel.
//   q, k, v (BH, S, D) f32|bf16 -> out (BH, S, D) in q's dtype; online softmax
//   in f32, causal or not, keys >= S masked in the kernel (no padding of S),
//   scale D^-0.5.  Two paths, picked from the shapes alone by the host plan
//   (kernels/flash_attention.py:plan_attention) and passed in:
//
//   * wgmma (bf16 at D 64, 128, 256: the serving path).  What bounds it on an
//     H100: at the prefill shapes (S 128, D 128, BH 128) the bytes, 16.8 MB
//     in 0.0050 ms, against 0.54 GFLOP that bf16 tensor cores do in 0.00055
//     ms but the FP32 pipes only in 0.0081 ms; at S 513 the operations come
//     close (17.25 GFLOP, 0.0174 ms).  So both products run on the tensor
//     cores with f32 accumulation.  One block a (q tile, bh), with one or two
//     consumer warpgroups of 64 query rows (block_q 64 or 128; the plan takes
//     64 rows by 64 keys, the fastest in chip_smoke.py's attn_sweep, and head
//     dim 256 only that) and one producer warp.  The producer loads the q
//     tile once and streams K and V tiles of block_k keys through a
//     two-stage ring by TMA, from 3-D tensor maps over (BH, S, D) in the
//     128-byte swizzle: rows past S arrive as zeros and a tile never reads
//     the next head's rows; each stage's arrival is counted on an mbarrier,
//     and the consumers free it on another, so the next tile's copy is in
//     flight while this one computes.  A warpgroup
//     computes S = Q K^T with wgmma m64n{block_k}k16 (Q and K both K-major
//     in shared memory), then the softmax in registers on the accumulator's
//     own layout (a thread holds parts of two rows; a row's max and sum take
//     two shuffles within the four lanes that share it; log2(e) folded into
//     the scale, exp2), masks only on the causal diagonal's and the ragged
//     last tile, rescales its f32 O accumulator (m64n{D}: 128 registers a
//     thread at D 256), converts P to bf16 in place as the register A operand
//     of wgmma m64n{D}k16 and adds P V, V read MN-major from shared memory.
//     The key loop stops at the causal diagonal of the q tile (the pl.when
//     skip of the Pallas body); a warpgroup whose rows end before a tile
//     skips it.  The epilogue normalises by max(l, 1e-30), writes bf16 into
//     the warpgroup's q tile (the same swizzle) and stores it with TMA, which
//     drops rows >= S.  No atomics: repeated launches are bit-identical.
//   * simt (f32 at every D; bf16 at D 16 and 32): scores and P@V on the FP32
//     pipes.  One block of 8 warps per (q tile of 64 rows, bh) stages 32 keys
//     and values at a time in shared memory as f32 (K rows padded to D + 1
//     floats); each warp owns 8 query rows, lane j scores key j, the warp
//     reduces the row max and sum with shuffles, and each lane accumulates
//     D/32 output columns.  f32 inputs would need split TF32 on the tensor
//     cores to keep the reference's 2e-4; that is not done yet.
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

// ------------------------------------ K4, the simt path (f32; bf16 at D 16, 32)
constexpr int FA_BQ = 64;
constexpr int FA_BK = 32;
constexpr int FA_WARPS = 8;
constexpr int FA_RPW = FA_BQ / FA_WARPS;  // query rows per warp

template <int D>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * ((size_t)FA_BQ * D + (size_t)FA_BK * (D + 1) + (size_t)FA_BK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_attention_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    T* __restrict__ out, int S, int causal, float scale) {
  constexpr int DPL = (D + 31) / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* qs = smem;                       // FA_BQ x D, pre-scaled
  float* ks = qs + FA_BQ * D;             // FA_BK x (D + 1)
  float* vs = ks + FA_BK * (D + 1);       // FA_BK x D
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * FA_BQ;
  const size_t base = (size_t)blockIdx.y * S * D;

  for (int i = tid; i < FA_BQ * D; i += FA_WARPS * 32) {
    const int r = i / D, d = i % D, qi = q0 + r;
    qs[i] = qi < S ? to_f32(q[base + (size_t)qi * D + d]) * scale : 0.f;
  }

  float m_r[FA_RPW], l_r[FA_RPW], acc[FA_RPW][DPL];
#pragma unroll
  for (int rr = 0; rr < FA_RPW; ++rr) {
    m_r[rr] = NEG_INF;
    l_r[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[rr][i] = 0.f;
  }

  const int kend = causal ? min(S, q0 + FA_BQ) : S;
  for (int k0 = 0; k0 < kend; k0 += FA_BK) {
    __syncthreads();  // previous K/V tile consumed (and the q tile staged)
    for (int i = tid; i < FA_BK * D; i += FA_WARPS * 32) {
      const int r = i / D, d = i % D, kj = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (kj < S) {
        kv = to_f32(k[base + (size_t)kj * D + d]);
        vv = to_f32(v[base + (size_t)kj * D + d]);
      }
      ks[r * (D + 1) + d] = kv;
      vs[r * D + d] = vv;
    }
    __syncthreads();
    const int kj = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < FA_RPW; ++rr) {
      const int r = warp * FA_RPW + rr, qi = q0 + r;
      const bool valid = kj < S && (!causal || kj <= qi);
      float s = NEG_INF;
      if (valid) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot = fmaf(qs[r * D + d], ks[lane * (D + 1) + d], dot);
        s = dot;
      }
      const float m_new = fmaxf(m_r[rr], warp_max(s));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float corr = expf(m_r[rr] - m_new);
      l_r[rr] = l_r[rr] * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[rr][i] *= corr;
#pragma unroll 8
      for (int j = 0; j < FA_BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] = fmaf(pj, vs[j * D + d], acc[rr][i]);
        }
      }
      m_r[rr] = m_new;
    }
  }

#pragma unroll
  for (int rr = 0; rr < FA_RPW; ++rr) {
    const int qi = q0 + warp * FA_RPW + rr;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l_r[rr], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) out[base + (size_t)qi * D + d] = from_f32<T>(acc[rr][i] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch_fa(const void* q, const void* k, const void* v, void* out, int BH, int S,
                      int causal, cudaStream_t stream) {
  const size_t smem = fa_smem_bytes<D>();
  auto kern = flash_attention_fwd<T, D>;
  cudaError_t err = raise_smem_limit<flash_attention_fwd<T, D>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + FA_BQ - 1) / FA_BQ, BH);
  kern<<<grid, FA_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, causal, 1.f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

// f32 at every head dim; bf16 at 16 and 32 (the wgmma path takes the rest)
template <typename T>
cudaError_t dispatch_fa(const void* q, const void* k, const void* v, void* out, int BH, int S,
                        int D, int causal, cudaStream_t st) {
  switch (D) {
    case 16: return launch_fa<T, 16>(q, k, v, out, BH, S, causal, st);
    case 32: return launch_fa<T, 32>(q, k, v, out, BH, S, causal, st);
  }
  if constexpr (sizeof(T) == 4) {
    switch (D) {
      case 64: return launch_fa<T, 64>(q, k, v, out, BH, S, causal, st);
      case 128: return launch_fa<T, 128>(q, k, v, out, BH, S, causal, st);
      case 256: return launch_fa<T, 256>(q, k, v, out, BH, S, causal, st);
    }
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------- K4, the wgmma path (bf16)
enum AttnPath : int { ATTN_SIMT = 0, ATTN_WGMMA = 1 };  // kernels/flash_attention.py: ATTN_PATHS
constexpr int FW_STAGES = 2;  // the K/V ring

// Shared memory of one block (kernels/flash_attention.py:attention_smem_bytes
// mirrors it): the q tile, [warpgroup][64-column chunk][64 rows][128 bytes];
// the ring's K and V tiles, each [chunk][BK rows][128 bytes]; the full and
// empty barriers of the ring and the q tile's barrier.  Every tile is a
// whole number of 1024-byte swizzle atoms.
template <int D, int WGS, int BK>
struct FwTiles {
  static constexpr int BQ = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;  // + one producer warp
  static constexpr int CHUNKS = D / 64;           // 128-byte boxes of a row
  static constexpr int WG_Q_BYTES = 64 * D * 2;   // one warpgroup's q (then o) tile
  static constexpr int KV_BYTES = BK * D * 2;     // one K or V tile
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + WGS * WG_Q_BYTES;
  static constexpr int V_OFF = K_OFF + FW_STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + FW_STAGES * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + (2 * FW_STAGES + 1) * 8 + 1024;  // + alignment slack
  // two blocks an SM where their shared memory fits (one warpgroup each)
  static constexpr int MIN_BLOCKS = WGS == 1 && 2 * (SMEM + 1024) <= 233472 ? 2 : 1;
  static_assert(D % 64 == 0 && BK % 16 == 0 && K_OFF % 1024 == 0 && KV_BYTES % 1024 == 0,
                "tiles of whole swizzle atoms");
};

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
          tma_load_3d(smem + T::Q_OFF + w * T::WG_Q_BYTES + c * 8192, &qmap, qbar, c * 64,
                      q0 + 64 * w, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % FW_STAGES;
        if (t >= FW_STAGES) mbar_wait(&empty[s], ((t / FW_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * T::KV_BYTES);
        for (int c = 0; c < T::CHUNKS; ++c) {
          tma_load_3d(smem + T::K_OFF + s * T::KV_BYTES + c * BK * 128, &kmap, &full[s], c * 64,
                      t * BK, bh);
          tma_load_3d(smem + T::V_OFF + s * T::KV_BYTES + c * BK * 128, &vmap, &full[s], c * 64,
                      t * BK, bh);
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
      // S = Q K^T: A = q tile, B = K tile, both K-major (128-byte swizzle):
      // a k16 step is 32 bytes into a row, a 64-column chunk further on
      const uint32_t ka = smem_u32(smem + T::K_OFF + s * T::KV_BYTES);
      float sc[BK / 2];
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_bf16<BK, 0>(sc, gmma_desc(qa + (kk / 4) * 8192 + (kk % 4) * 32, 16, 1024),
                          gmma_desc(ka + (kk / 4) * (BK * 128) + (kk % 4) * 32, 16, 1024),
                          kk > 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(sc);
      // register 4j + {0,1}: row lr, keys k0 + 8j + 2(lane % 4) + {0,1};
      // 4j + {2,3}: the same keys of row lr + 8
      const int k0 = t * BK;
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
      // key 0 is valid for every row and tile 0 comes first, so the new
      // maxima are finite and exp2(m - m_new) never sees -inf - -inf
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
      // P as bf16 A fragments: k16 slice kk of the scores is registers
      // [8 kk, 8 kk + 8), in the order the A operand takes them
      uint32_t pa[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      // O += P V: B = V tile, MN-major (a k16 step is 16 rows of 128 bytes,
      // 64-column chunks BK * 128 bytes apart, 8 rows 1024 bytes apart)
      const uint32_t va = smem_u32(smem + T::V_OFF + s * T::KV_BYTES);
      fence_regs(o);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_bf16<D>(o, pa[kk], gmma_desc(va + kk * 16 * 128, BK * 128, 1024));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
  }
  if (my_tiles == 0) return;

  // o / max(l, 1e-30) as bf16 into this warpgroup's q tile (no longer read),
  // chunk j % 8 of row r at chunk (j % 8) ^ (r % 8), then one TMA store a
  // 64-column chunk; rows >= S fall outside the tensor and are dropped
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    uint8_t* line = qs + (j / 8) * 8192 + lr * 128 + (lane % 4) * 4;
    const int ch = ((j % 8) ^ (lr % 8)) << 4;  // rows lr and lr + 8 share the swizzle
    *reinterpret_cast<uint32_t*>(line + ch) = pack_bf16(o[4 * j] * inv0, o[4 * j + 1] * inv0);
    *reinterpret_cast<uint32_t*>(line + 8 * 128 + ch) =
        pack_bf16(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int c = 0; c < T::CHUNKS; ++c) tma_store_3d(&omap, qs + c * 8192, c * 64, r0, bh);
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
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  if (!tensor_map_3d(&qmap, bf16, 2, q, BH, S, D, 64, 64, sw) ||
      !tensor_map_3d(&kmap, bf16, 2, k, BH, S, D, BK, 64, sw) ||
      !tensor_map_3d(&vmap, bf16, 2, v, BH, S, D, BK, 64, sw) ||
      !tensor_map_3d(&omap, bf16, 2, out, BH, S, D, 64, 64, sw))
    return cudaErrorInvalidValue;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  flash_attention_wgmma<D, WGS, BK><<<dim3(q_tiles, BH), T::THREADS, T::SMEM, stream>>>(
      qmap, kmap, vmap, omap, S, causal, scale_log2);
  return cudaGetLastError();
}

// (block_q, block_k) of the plan: 64 or 128 query rows (one or two
// warpgroups) by 64 or 128 keys a tile.  D 256 takes 64 by 64 only: its O
// accumulator holds 128 registers a thread, and a block of two warpgroups
// and a producer warp is given registers as three warpgroups (168 a thread)
template <int D>
cudaError_t dispatch_fw_tile(int block_q, int block_k, const void* q, const void* k,
                             const void* v, void* out, int BH, int S, int causal,
                             cudaStream_t st) {
  if (block_q == 64 && block_k == 64) return launch_fw<D, 1, 64>(q, k, v, out, BH, S, causal, st);
  if constexpr (D <= 128) {
    if (block_q == 128 && block_k == 64)
      return launch_fw<D, 2, 64>(q, k, v, out, BH, S, causal, st);
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
    case 64: return dispatch_fw_tile<64>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 128: return dispatch_fw_tile<128>(block_q, block_k, q, k, v, out, BH, S, causal, st);
    case 256: return dispatch_fw_tile<256>(block_q, block_k, q, k, v, out, BH, S, causal, st);
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
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
// block_k: the plan (kernels/flash_attention.py:plan_attention).  A plan the
// kernels do not take returns cudaErrorInvalidValue.  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int BH, int S, int D, int causal,
                                     void* stream, int path, int block_q, int block_k) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (path == ATTN_WGMMA && dtype == DT_BF16)
    return dispatch_fw(q, k, v, out, BH, S, D, causal, block_q, block_k, st);
  if (path != ATTN_SIMT || block_q != FA_BQ || block_k != FA_BK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == DT_F32) return dispatch_fa<float>(q, k, v, out, BH, S, D, causal, st);
  if (dtype == DT_BF16) return dispatch_fa<__nv_bfloat16>(q, k, v, out, BH, S, D, causal, st);
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
