// K3 quant_matmul: out (M,N) f32 = x (M,K) f32|bf16 @ (codes (K,N) int8|int16 * scale).
//
// Replaces the Pallas kernel repro/kernels/quant_matmul.py:quant_matmul_kernel.
// The weight streams from device memory as int8/int16 codes and becomes a
// float only on chip; sums are kept in f32 and the scalar scale (a device
// tensor, so no host sync per call) multiplies each finished sum once
// (x @ codes * s == x @ (codes * s) up to f32 rounding).
//
// What bounds it on an H100: decode (M <= 16) reads K*N code bytes for
// 2*M*K*N operations, far below the ~295 ops/byte ridge, so it is bound by
// the weight bytes.  Prefill (M = 4 slots x bucket) is bound by operations.
//
// The path and its tile are chosen in Python (kernels/quant_matmul.py:plan)
// and passed in, so the CPU tests pin the choice.  Every path is
// deterministic: one launch, no memset, no atomics, and a fixed order of
// every f32 sum, so the same inputs give bit-identical outputs.
//
//  * cluster (M <= 16, decode, operands TMA can address).  K is split
//    across the blocks of one thread-block cluster (at most 8, the portable
//    size); a block covers a column tile of `lanes` x CPL columns.  One producer warp streams the
//    block's code rows, and x over the same rows, through a ring of
//    shared-memory stages with TMA, so the bytes in flight (what sets this
//    path's speed) do not depend on registers.  256 consumer threads keep
//    64 accumulators each, MAXM rows (4, 8 or 16) by CPL = 64/MAXM adjacent
//    columns; codes become floats by byte splicing (exact) instead of the
//    conversion pipe.  The row groups' sums meet in a shared-memory tree
//    (fixed pairing); each block leaves its partial (MAXM, cols) tile in
//    shared memory and, after a cluster barrier, block r sums slice r of
//    the tile over the cluster's tiles in rank order through distributed
//    shared memory, scales it and stores it with plain stores.  The plan
//    sizes tiles and clusters for about 1.5 blocks an SM and never fewer
//    than one, so even the narrow k/v projection (N 512) fills the card.
//  * wgmma (M > 16, bf16 x, int8 codes: prefill on the serving path).  One
//    producer warp keeps a ring of STAGES shared-memory stages full through
//    TMA (x tile bf16 K-major with the 128-byte swizzle; int8 code tile
//    unswizzled), each stage's arrival counted on an mbarrier.  Consumer
//    warpgroups (64 rows each) convert the stage's codes to bf16 (exact:
//    int8 spliced into an f32, whose high half is the bf16) into one of
//    three bf16 tiles, written MN-major in the 128-byte swizzle that wgmma
//    reads with its transpose bit set, so every conversion store is a
//    contiguous 16 bytes; then fence.proxy.async and wgmma.mma_async
//    m64nBNk16 (bf16 x bf16 -> f32 in registers), keeping one k-step of
//    wgmma in flight while the next tile converts.  Three bf16 tiles let one
//    named barrier a k-step order the warpgroups' conversions against each
//    other's wgmma reads.  The epilogue scales and writes f32.  Tiles are
//    128 x 256, 128 x 128 (two warpgroups), 64 x 128 or 64 x 64 (one),
//    picked by the plan for the fewest waves of work; M <= 64 takes one.
//  * ragged (M <= 16 where TMA cannot address the operands: code rows that
//    are no multiple of 16 bytes, such as mamba2's 50,280- and seamless-m4t's
//    256,206-byte vocabularies and a tp shard's 12-byte w_dt rows; x rows
//    that are not; an x or code base off the 16-byte grid).  Decode as the
//    cluster path does it, with no TMA: MAXM rows of accumulators, K split
//    over the blocks of a cluster, the same tree and the same merge through
//    distributed shared memory.  It is bound by the code bytes too.  A row of
//    codes starts at any byte, so a producer warp copies the aligned 16-byte
//    chunks that cover the tile's span of each row with cp.async (one chunk
//    more than the span, at full width whatever the row's offset) into a
//    ring of 8 stages of >= 8 KB on full/empty mbarriers, as many bytes in
//    flight as the cluster path's ring; each consumer lane takes its codes
//    at the row's offset from shared memory with aligned loads, a branch or
//    selects on the word skip, and funnel shifts.  Only the buffer's first
//    and last chunks, where they stick out of it, are copied element by
//    element, so nothing outside the buffer is read.  x streams through
//    shared memory as f32 in chunks of whole stages.  The plan counts waves
//    of clusters at two blocks an SM, the narrowest column tile one lane
//    wide, so a 12-column shape still splits K over up to 8 blocks.
//  * tiled (M > 16 with f32 x or int16 codes, or operands TMA cannot
//    address).  A 128x128 output tile per block of 256 threads on the FP32
//    pipes, each thread 8x8, K in steps of 8; codes are dequantized as the
//    tile lands in shared memory, as the Pallas body does per tile.  int16
//    codes above 256 are not exact in bf16, so they cannot take the bf16
//    wgmma path.
//  Ragged M/N/K are masked in the loads (TMA fills with zeros) or at the
//  stores; nothing is padded in memory.  TMA needs 16-byte aligned bases and
//  row strides.

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"  // TMA, mbarrier and wgmma helpers (shared with K4)

namespace cg = cooperative_groups;

namespace {

// Path tags of the plan (kernels/quant_matmul.py: PATHS).
enum Path : int { PATH_CLUSTER = 0, PATH_WGMMA = 1, PATH_TILED = 2, PATH_RAGGED = 3 };

// Four signed int8 codes packed in a word -> exact floats, on the integer and
// FP32 pipes rather than the slower conversion pipe: bias each byte to
// unsigned, splice it under the exponent of 2^23, subtract 2^23 + 128.
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80808080u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  out[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  out[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// Two signed int16 codes -> exact floats, the same way (2^23 + 2^15 bias).
__device__ __forceinline__ void i16x2_to_f32(uint32_t w, float* out) {
  const uint32_t u = w ^ 0x80008000u;
  out[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7510)) - 8421376.f;
  out[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7532)) - 8421376.f;
}

// ---------------------------------------------------------------- decode
constexpr int CL_THREADS = 256;                 // consumer threads
constexpr int CL_BLOCK = CL_THREADS + 32;       // + one producer warp
constexpr int CL_ACC = 64;                      // accumulators a thread: MAXM rows x CPL columns
constexpr int CL_MAX_CLUSTER = 8;
constexpr int CL_STAGES = 8;                    // stages in flight a block
constexpr int CL_STAGE_BYTES = 8192;            // the stage size the rows aim at
constexpr int CL_TREE_BYTES = CL_ACC * (CL_THREADS / 2) * 4;  // the row groups' tree
constexpr int CL_MAX_SMEM = 200 * 1024;

// CPL codes at ``p`` in shared memory (aligned to their size), as floats.
template <typename CT, int CPL>
__device__ __forceinline__ void smem_codes(const CT* p, float (&w)[CPL]) {
  constexpr int BYTES = CPL * static_cast<int>(sizeof(CT));
  uint32_t u[BYTES / 4];
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[c];
      u[4 * c] = v.x; u[4 * c + 1] = v.y; u[4 * c + 2] = v.z; u[4 * c + 3] = v.w;
    }
  } else if constexpr (BYTES == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    u[0] = v.x; u[1] = v.y;
  } else {
    u[0] = *reinterpret_cast<const uint32_t*>(p);
  }
#pragma unroll
  for (int i = 0; i < BYTES / 4; ++i) {
    if constexpr (sizeof(CT) == 1) i8x4_to_f32(u[i], &w[4 * i]);
    else i16x2_to_f32(u[i], &w[2 * i]);
  }
}

// The consumers' row groups sum their accumulators in a shared-memory tree
// (fixed pairing: groups [h, 2h) hand theirs to groups [0, h)), then group 0
// leaves the block's partial (MAXM, cols) tile in ``red`` as [m][c][lane]:
// element (m * CPL + c) * lanes + l.  The CL_THREADS consumers call it
// (named barrier 1); ``red`` holds CL_TREE_BYTES.
template <int MAXM, int CPL>
__device__ __forceinline__ void tree_to_partial(float (&acc)[MAXM][CPL], float* red, int tid,
                                                int g, int l, int lanes, int groups) {
  for (int h = groups / 2; h >= 1; h >>= 1) {
    asm volatile("bar.sync 1, %0;\n" :: "n"(CL_THREADS) : "memory");
    if (g >= h && g < 2 * h) {
      const int w = tid - h * lanes;
#pragma unroll
      for (int m = 0; m < MAXM; ++m)
#pragma unroll
        for (int c = 0; c < CPL; ++c) red[(m * CPL + c) * (CL_THREADS / 2) + w] = acc[m][c];
    }
    asm volatile("bar.sync 1, %0;\n" :: "n"(CL_THREADS) : "memory");
    if (g < h) {
#pragma unroll
      for (int m = 0; m < MAXM; ++m)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[m][c] += red[(m * CPL + c) * (CL_THREADS / 2) + tid];
    }
  }
  asm volatile("bar.sync 1, %0;\n" :: "n"(CL_THREADS) : "memory");
  if (g == 0) {
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
#pragma unroll
      for (int c = 0; c < CPL; ++c) red[(m * CPL + c) * lanes + l] = acc[m][c];
  }
}

// Every thread of the block: after a cluster barrier (every block's partial
// tile in place), block r sums slice r of the tile over the cluster's blocks
// in rank order through distributed shared memory, scales it and stores it
// with plain stores; a second barrier keeps every block until its peers have
// read its tile.
template <int MAXM, int CPL>
__device__ __forceinline__ void merge_cluster(cg::cluster_group& cluster, const float* part,
                                              const float* __restrict__ scale,
                                              float* __restrict__ out, int M, int N, int lanes,
                                              int tile0) {
  cluster.sync();
  const int tid = threadIdx.x;
  if (tid < CL_THREADS) {
    const int rank = static_cast<int>(cluster.block_rank());
    const int csize = static_cast<int>(cluster.num_blocks());
    const float s = *scale;
    const int tile = MAXM * lanes * CPL, per = (tile + csize - 1) / csize;
    for (int i = rank * per + tid; i < min(tile, (rank + 1) * per); i += CL_THREADS) {
      float v = 0.f;
      for (int q = 0; q < csize; ++q) v += cluster.map_shared_rank(part, q)[i];
      const int mc = i / lanes, m = mc / CPL;
      const int n = tile0 + (i % lanes) * CPL + mc % CPL;
      if (m < M && n < N) out[(size_t)m * N + n] = v * s;
    }
  }
  cluster.sync();
}

// The accumulators' update from one row of K: MAXM rows of x (``xcol[m *
// stride]``, rows past M skipped) times the lane's CPL codes ``w``.
template <int MAXM, int CPL, typename T>
__device__ __forceinline__ void fma_row(float (&acc)[MAXM][CPL], const float (&w)[CPL],
                                        const T* xcol, int stride, int M) {
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < M) {
      const float xv = to_f32(xcol[m * stride]);
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
    }
  }
}

// grid (cluster size, column tiles), cluster (cluster size, 1, 1): block r
// of a cluster takes rows [r * k_per_block, (r + 1) * k_per_block) of K.  A
// stage holds ``rows`` rows of K as TMA lands them: the block's code columns
// in boxes of ``box_cols`` columns, each dense [rows][box_cols], then x's
// M rows over those K rows, dense [M][rows].  Dynamic shared memory: the
// stage ring (afterwards the tree and the partial tile), then the barriers.
template <typename XT, typename CT, int MAXM>
__global__ void __launch_bounds__(CL_BLOCK, 2)
qmm_cluster(const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap xmap,
            const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N,
            int lanes, int k_per_block, int rows, int box_cols, int area) {
  constexpr int CPL = CL_ACC / MAXM;  // columns per lane
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem<128>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + area);
  uint64_t* empty = full + CL_STAGES;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = CL_THREADS / lanes;
  const int g = tid / lanes, l = tid % lanes;
  const int cols = lanes * CPL;
  const int code_bytes = rows * cols * static_cast<int>(sizeof(CT));
  const int x_bytes = M * rows * static_cast<int>(sizeof(XT));
  const int stage_bytes = code_bytes + ((x_bytes + 127) & ~127);
  const int tile0 = blockIdx.y * cols;
  const int kb0 = rank * k_per_block;
  const int kn = max(0, min(K, kb0 + k_per_block) - kb0);  // this block's rows
  const int n_stages = (kn + rows - 1) / rows;
  if (tid == 0) {
    for (int s = 0; s < CL_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CL_THREADS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CL_THREADS / 32) {  // producer
    if (lane == 0) {
      for (int t = 0; t < n_stages; ++t) {
        const int s = t % CL_STAGES;
        if (t >= CL_STAGES) mbar_wait(&empty[s], ((t / CL_STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], code_bytes + x_bytes);
        uint8_t* dst = smem + s * stage_bytes;
        const int k0 = kb0 + t * rows;
        for (int b = 0; b * box_cols < cols; ++b)
          tma_load_2d(dst + b * rows * box_cols * static_cast<int>(sizeof(CT)), &cmap, &full[s],
                      tile0 + b * box_cols, k0);
        tma_load_2d(dst + code_bytes, &xmap, &full[s], k0, 0);
      }
    }
    __syncwarp();
  } else {
    float acc[MAXM][CPL];
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;
    // this lane's CPL columns within a stage: box, then column within the box
    const int off = ((l * CPL) / box_cols) * rows * box_cols + (l * CPL) % box_cols;
    for (int t = 0; t < n_stages; ++t) {
      const int s = t % CL_STAGES;
      mbar_wait(&full[s], (t / CL_STAGES) & 1);
      const CT* st = reinterpret_cast<const CT*>(smem + s * stage_bytes) + off;
      const XT* xt = reinterpret_cast<const XT*>(smem + s * stage_bytes + code_bytes);
      const int r_end = min(rows, kn - t * rows);
#pragma unroll 4
      for (int r = g; r < r_end; r += groups) {
        float w[CPL];
        smem_codes<CT, CPL>(st + r * box_cols, w);
        fma_row<MAXM, CPL>(acc, w, xt + r, rows, M);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the stages are all consumed, so the tree reuses their memory
    tree_to_partial<MAXM, CPL>(acc, reinterpret_cast<float*>(smem), tid, g, l, lanes, groups);
  }
  merge_cluster<MAXM, CPL>(cluster, reinterpret_cast<const float*>(smem), scale, out, M, N,
                           lanes, tile0);
}

// The cluster path's stage geometry (kernels/quant_matmul.py:cluster_layout
// mirrors it; repro_quant_matmul_smem reports its smem)
struct ClusterGeom {
  int rows, k_per_block, stage_bytes, area, smem;
};

ClusterGeom cluster_geom(int M, int K, int cols, int csize, int lanes, int sz, int xsz) {
  ClusterGeom g;
  const int groups = CL_THREADS / lanes;
  // rows a stage: about CL_STAGE_BYTES of codes, a multiple of the row
  // groups (so x's box row is a multiple of 16 bytes), at most 256 (TMA's
  // box limit)
  g.rows = CL_STAGE_BYTES / (cols * sz);
  g.rows = max(groups, min(256, g.rows)) / groups * groups;
  // a block's rows, a whole number of stages: every TMA box of x then starts
  // on a 16-byte boundary, as TMA requires
  g.k_per_block = ((K + csize - 1) / csize + g.rows - 1) / g.rows * g.rows;
  g.stage_bytes = g.rows * cols * sz + ((M * g.rows * xsz + 127) & ~127);
  g.area = max(CL_STAGES * g.stage_bytes, CL_TREE_BYTES);
  g.smem = 128 + g.area + 2 * CL_STAGES * 8;
  return g;
}

template <typename XT, typename CT, int MAXM>
cudaError_t launch_cluster(const XT* x, const CT* codes, const float* scale, float* out,
                           int M, int K, int N, int cols, int csize, cudaStream_t stream) {
  constexpr int CPL = CL_ACC / MAXM;
  constexpr int SZ = static_cast<int>(sizeof(CT)), XSZ = static_cast<int>(sizeof(XT));
  const int lanes = cols / CPL;
  if (M > MAXM || cols % CPL != 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      cols * SZ % 16 != 0 || csize < 1 || csize > CL_MAX_CLUSTER ||
      (size_t)N * SZ % 16 != 0 || (size_t)K * XSZ % 16 != 0 ||
      reinterpret_cast<uintptr_t>(codes) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorInvalidValue;
  const int tiles = (N + cols - 1) / cols;
  const ClusterGeom g = cluster_geom(M, K, cols, csize, lanes, SZ, XSZ);
  const int rows = g.rows, k_per_block = g.k_per_block, area = g.area, smem = g.smem;
  const int box_cols = min(cols, 256);
  if (tiles > 65535 || smem > CL_MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_cluster<XT, CT, MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize, CL_MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap cmap, xmap;
  if (!tensor_map(&cmap, SZ == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16,
                  SZ, codes, K, N, rows, box_cols, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&xmap, XSZ == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                  : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                  XSZ, x, M, K, M, rows, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, tiles);
  cfg.blockDim = dim3(CL_BLOCK);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qmm_cluster<XT, CT, MAXM>, cmap, xmap, scale, out, M, K, N,
                            lanes, k_per_block, rows, box_cols, area);
}

// ---------------------------------------------------------------- ragged
constexpr int RG_STAGES = 8;           // cp.async stages in flight a block
constexpr int RG_STAGE_BYTES = 8192;   // the code bytes a stage holds at least
constexpr int RG_X_BYTES = 16384;      // x's chunk in shared memory (f32) at most

// ``bar`` counts one arrival of this thread once its cp.async copies so far land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// u = the B bytes of w's words from word S on, shifted down by ``sh`` bits
template <int B, int S, int NW>
__device__ __forceinline__ void splice_words(const uint32_t (&w)[NW], unsigned sh,
                                             uint32_t (&u)[B / 4]) {
#pragma unroll
  for (int j = 0; j < B / 4; ++j) u[j] = __funnelshift_r(w[j + S], w[j + S + 1], sh);
}

// B bytes (4, 8, 16 or 32) at byte offset ``o`` of a staged row, at any
// alignment, as B / 4 words: aligned loads of min(B, 16) bytes that cover
// them, then the words the offset skips dropped and the rest spliced by
// funnel shifts.  ``uniform``: every lane of the warp has the same offset
// within a load (one row a warp), so the skip is a branch, not selects.
// ``row`` is 16-byte aligned; the loads end by (o & ~(VEC - 1)) + B + VEC.
template <int B>
__device__ __forceinline__ void smem_window(const uint8_t* row, int o, bool uniform,
                                            uint32_t (&u)[B / 4]) {
  constexpr int VEC = B < 16 ? B : 16;
  constexpr int NW = (B + VEC) / 4;  // words loaded
  uint32_t w[NW];
  const uint8_t* p = row + (o & ~(VEC - 1));
#pragma unroll
  for (int v = 0; v < NW * 4 / VEC; ++v) {
    if constexpr (VEC == 16) {
      const uint4 q = reinterpret_cast<const uint4*>(p)[v];
      w[4 * v] = q.x; w[4 * v + 1] = q.y; w[4 * v + 2] = q.z; w[4 * v + 3] = q.w;
    } else if constexpr (VEC == 8) {
      const uint2 q = reinterpret_cast<const uint2*>(p)[v];
      w[2 * v] = q.x; w[2 * v + 1] = q.y;
    } else {
      w[v] = reinterpret_cast<const uint32_t*>(p)[v];
    }
  }
  const int skip = (o & (VEC - 1)) >> 2;  // whole words before the first byte
  const unsigned sh = static_cast<unsigned>(o & 3) * 8u;
  if constexpr (VEC == 16) {
    if (uniform) {
      if (skip == 0) splice_words<B, 0>(w, sh, u);
      else if (skip == 1) splice_words<B, 1>(w, sh, u);
      else if (skip == 2) splice_words<B, 2>(w, sh, u);
      else splice_words<B, 3>(w, sh, u);
      return;
    }
  }
#pragma unroll
  for (int bit = VEC / 8; bit >= 1; bit >>= 1) {
    const bool take = (skip & bit) != 0;
#pragma unroll
    for (int j = 0; j + bit < NW; ++j) w[j] = take ? w[j + bit] : w[j];
  }
  splice_words<B, 0>(w, sh, u);
}

// grid (cluster size, column tiles), cluster (cluster size, 1, 1): the
// cluster path's split of K, consumer threads, tree and merge, with a
// producer warp that copies the stages by cp.async instead of TMA, so code
// rows may start at any byte.  A staged row is the aligned 16-byte chunks
// that cover the tile's codes in that row (``pitch`` bytes: one chunk more
// than the codes need); lane pairs of the producer take a row each, the
// two lanes of a pair every other chunk.  The buffer's first and last
// chunks, where they stick out of it, are copied
// element by element.  A stage is full when each producer lane's copies
// have landed (cp.async.mbarrier.arrive) and its plain stores are released
// (mbarrier.arrive): 64 arrivals.  x streams through shared memory as f32
// in chunks of ``xc`` rows of K (whole stages), loaded by the consumers.
// Dynamic shared memory: the stage ring (afterwards the tree and the
// partial tile), x's chunk, the barriers.
template <typename XT, typename CT, int MAXM>
__global__ void __launch_bounds__(CL_BLOCK, 2)
qmm_ragged(const XT* __restrict__ x, const CT* __restrict__ codes,
           const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N,
           int lanes, int k_per_block, int rows, int pitch, int xc, int area) {
  constexpr int CPL = CL_ACC / MAXM;                  // columns per lane
  constexpr int SZ = static_cast<int>(sizeof(CT));
  constexpr int B = CPL * SZ;                         // a lane's code bytes in a row
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem<16>(smem_raw);
  float* xs = reinterpret_cast<float*>(smem + area);  // [MAXM][xc]
  uint64_t* full = reinterpret_cast<uint64_t*>(xs + MAXM * xc);
  uint64_t* empty = full + RG_STAGES;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = CL_THREADS / lanes;
  const int g = tid / lanes, l = tid % lanes;
  const int cols = lanes * CPL;
  const int tile0 = blockIdx.y * cols;
  const int kb0 = rank * k_per_block;
  const int kn = max(0, min(K, kb0 + k_per_block) - kb0);  // this block's rows
  const int n_stages = (kn + rows - 1) / rows;
  const int stage_bytes = rows * pitch;
  // code row k of the tile starts at t_lo + k * row_bytes
  const size_t row_bytes = static_cast<size_t>(N) * SZ;
  const uintptr_t c_lo = reinterpret_cast<uintptr_t>(codes);
  const uintptr_t t_lo = c_lo + static_cast<size_t>(tile0) * SZ;
  if (tid == 0) {
    for (int s = 0; s < RG_STAGES; ++s) {
      mbar_init(&full[s], 64);                // 32 lanes' copies, 32 lanes' stores
      mbar_init(&empty[s], CL_THREADS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CL_THREADS / 32) {  // producer
    const uintptr_t c_hi = c_lo + static_cast<size_t>(K) * row_bytes;
    const uintptr_t span = static_cast<uintptr_t>(min(N - tile0, cols)) * SZ;
    // lane pairs take a row each, the two lanes of a pair every other chunk
    // (32-byte sectors whole): 16 rows a warp instruction
    const int sub = lane >> 1, half = lane & 1;
    for (int t = 0; t < n_stages; ++t) {
      const int s = t % RG_STAGES;
      if (t >= RG_STAGES) mbar_wait(&empty[s], ((t / RG_STAGES) - 1) & 1);
      uint8_t* dst = smem + s * stage_bytes;
      const int k0 = kb0 + t * rows, nr = min(rows, kn - t * rows);
      for (int r = sub; r < nr; r += 16) {
        const uintptr_t lo = t_lo + static_cast<size_t>(k0 + r) * row_bytes;
        const uintptr_t a0 = lo & ~static_cast<uintptr_t>(15), a_end = lo + span;
        uint8_t* d = dst + r * pitch;
        if (a0 >= c_lo && ((a_end + 15) & ~static_cast<uintptr_t>(15)) <= c_hi) {
          for (uintptr_t a = a0 + 16 * half; a < a_end; a += 32)
            cp_async16(d + (a - a0), reinterpret_cast<const void*>(a));
        } else {
          for (uintptr_t a = a0 + 16 * half; a < a_end; a += 32) {
            if (a >= c_lo && a + 16 <= c_hi) {
              cp_async16(d + (a - a0), reinterpret_cast<const void*>(a));
            } else {  // the chunk sticks out of the buffer: its elements inside it only
              const uintptr_t b0 = a > c_lo ? a : c_lo, b1 = a + 16 < c_hi ? a + 16 : c_hi;
              for (uintptr_t b = b0; b < b1; b += SZ)
                *reinterpret_cast<CT*>(d + (b - a0)) = *reinterpret_cast<const CT*>(b);
            }
          }
        }
      }
      cp_async_arrive(&full[s]);
      mbar_arrive(&full[s]);
    }
    __syncwarp();
  } else {
    float acc[MAXM][CPL];
#pragma unroll
    for (int m = 0; m < MAXM; ++m)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;
    // the offset of a row's first tile byte in its staged row: the low bits
    // of t_lo + k * row_bytes
    const uint32_t mis0 = static_cast<uint32_t>(t_lo), rb = static_cast<uint32_t>(row_bytes);
    const bool uniform = lanes == 32;
    for (int t = 0; t < n_stages; ++t) {
      const int s = t % RG_STAGES;
      const int xo = (t * rows) % xc;
      if (xo == 0) {  // x's next chunk: rows [kb0 + t * rows, + xc) of K, as f32
        const int kx = kb0 + t * rows, nx = min(xc, kn - t * rows);
        asm volatile("bar.sync 1, %0;\n" :: "n"(CL_THREADS) : "memory");
        for (int i = tid; i < M * xc; i += CL_THREADS) {
          const int m = i / xc, j = i - m * xc;
          if (j < nx) xs[i] = to_f32(x[static_cast<size_t>(m) * K + kx + j]);
        }
        asm volatile("bar.sync 1, %0;\n" :: "n"(CL_THREADS) : "memory");
      }
      mbar_wait(&full[s], (t / RG_STAGES) & 1);
      const uint8_t* st = smem + s * stage_bytes;
      const int r_end = min(rows, kn - t * rows);
#pragma unroll 2
      for (int r = g; r < r_end; r += groups) {
        const uint32_t k = static_cast<uint32_t>(kb0 + t * rows + r);
        const int o = static_cast<int>((mis0 + k * rb) & 15u) + l * B;
        uint32_t u[B / 4];
        smem_window<B>(st + r * pitch, o, uniform, u);
        float w[CPL];
#pragma unroll
        for (int i = 0; i < B / 4; ++i) {
          if constexpr (SZ == 1) i8x4_to_f32(u[i], &w[4 * i]);
          else i16x2_to_f32(u[i], &w[2 * i]);
        }
        fma_row<MAXM, CPL>(acc, w, xs + xo + r, xc, M);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the stages are all consumed, so the tree reuses their memory
    tree_to_partial<MAXM, CPL>(acc, reinterpret_cast<float*>(smem), tid, g, l, lanes, groups);
  }
  merge_cluster<MAXM, CPL>(cluster, reinterpret_cast<const float*>(smem), scale, out, M, N,
                           lanes, tile0);
}

// The ragged path's geometry (kernels/quant_matmul.py:ragged_layout mirrors
// it; repro_quant_matmul_smem reports its smem)
struct RaggedGeom {
  int pitch, rows, k_per_block, xc, area, smem;
};

RaggedGeom ragged_geom(int K, int cols, int csize, int lanes, int sz, int maxm) {
  RaggedGeom g;
  const int groups = CL_THREADS / lanes;
  // a staged row: the 16-byte chunks that cover cols codes at any offset
  g.pitch = 16 * ((cols * sz + 15) / 16 + 1);
  // rows a stage: RG_STAGE_BYTES at least, a multiple of the row groups
  g.rows = ((RG_STAGE_BYTES + g.pitch - 1) / g.pitch + groups - 1) / groups * groups;
  g.k_per_block = (K + csize - 1) / csize;
  // x's chunk: whole stages, RG_X_BYTES at most, no more than the block's
  // stages
  const int cap = max(1, RG_X_BYTES / (4 * maxm) / g.rows) * g.rows;
  g.xc = min(cap, (g.k_per_block + g.rows - 1) / g.rows * g.rows);
  g.area = max(RG_STAGES * g.rows * g.pitch, CL_TREE_BYTES);
  g.smem = 16 + g.area + 4 * maxm * g.xc + 2 * RG_STAGES * 8;
  return g;
}

template <typename XT, typename CT, int MAXM>
cudaError_t launch_ragged(const XT* x, const CT* codes, const float* scale, float* out,
                          int M, int K, int N, int cols, int csize, cudaStream_t stream) {
  constexpr int CPL = CL_ACC / MAXM;
  constexpr int SZ = static_cast<int>(sizeof(CT)), XSZ = static_cast<int>(sizeof(XT));
  const int lanes = cols / CPL;
  if (M > MAXM || cols % CPL != 0 || lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) ||
      csize < 1 || csize > CL_MAX_CLUSTER || reinterpret_cast<uintptr_t>(codes) % SZ != 0 ||
      reinterpret_cast<uintptr_t>(x) % XSZ != 0)
    return cudaErrorInvalidValue;
  const int tiles = (N + cols - 1) / cols;
  const RaggedGeom g = ragged_geom(K, cols, csize, lanes, SZ, MAXM);
  if (tiles > 65535 || g.smem > CL_MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_ragged<XT, CT, MAXM>, cudaFuncAttributeMaxDynamicSharedMemorySize, CL_MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, tiles);
  cfg.blockDim = dim3(CL_BLOCK);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, qmm_ragged<XT, CT, MAXM>, x, codes, scale, out, M, K, N,
                            lanes, g.k_per_block, g.rows, g.pitch, g.xc, g.area);
}

// ---------------------------------------------------------------- tiled
constexpr int TB_M = 128, TB_N = 128, TB_K = 8, T_M = 8, T_N = 8;
constexpr int TB_THREADS = (TB_M / T_M) * (TB_N / T_N);  // 256

template <typename XT, typename CT>
__global__ void __launch_bounds__(TB_THREADS)
qmm_tiled(const XT* __restrict__ x, const CT* __restrict__ codes,
          const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) float As[TB_K][TB_M];  // x tile, transposed
  __shared__ __align__(16) float Bs[TB_K][TB_N];  // dequantized code tile
  const int tid = threadIdx.x;
  const int tx = tid % (TB_N / T_N), ty = tid / (TB_N / T_N);
  const int m0 = blockIdx.y * TB_M, n0 = blockIdx.x * TB_N;
  const float s = *scale;

  float acc[T_M][T_N];
#pragma unroll
  for (int i = 0; i < T_M; ++i)
#pragma unroll
    for (int j = 0; j < T_N; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += TB_K) {
    for (int i = tid; i < TB_M * TB_K; i += TB_THREADS) {
      const int r = i / TB_K, kk = i % TB_K;
      const int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? to_f32(x[(size_t)m * K + k]) : 0.f;
    }
    for (int i = tid; i < TB_K * TB_N; i += TB_THREADS) {
      const int kk = i / TB_N, c = i % TB_N;
      const int k = k0 + kk, n = n0 + c;
      Bs[kk][c] = (k < K && n < N) ? to_f32(codes[(size_t)k * N + n]) * s : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TB_K; ++kk) {
      float a[T_M], b[T_N];
#pragma unroll
      for (int i = 0; i < T_M; i += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&As[kk][ty * T_M + i]);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < T_N; j += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[kk][tx * T_N + j]);
        b[j] = v.x; b[j + 1] = v.y; b[j + 2] = v.z; b[j + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < T_M; ++i)
#pragma unroll
        for (int j = 0; j < T_N; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < T_M; ++i) {
    const int m = m0 + ty * T_M + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < T_N; ++j) {
      const int n = n0 + tx * T_N + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// ----------------------------------------------------------------- wgmma
constexpr int WG_BK = 64;    // K per stage: one 128-byte swizzle row of bf16 x
constexpr int WG_BBUF = 3;   // bf16 code tiles (see the consumer loop)

template <int WGS, int BN, int STAGES>
struct WgTiles {
  static constexpr int BM = 64 * WGS;
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;     // + one producer warp
  static constexpr int X_BYTES = BM * WG_BK * 2;      // a stage's x tile
  static constexpr int C_BYTES = WG_BK * BN;          // a stage's int8 code tile
  static constexpr int B_BYTES = WG_BK * BN * 2;      // a bf16 code tile
  static constexpr int ATOM = WG_BK * 128;            // bytes of 64 columns of a bf16 tile
  static constexpr int X_OFF = 0;
  static constexpr int C_OFF = X_OFF + STAGES * X_BYTES;
  static constexpr int B_OFF = C_OFF + STAGES * C_BYTES;
  static constexpr int BAR_OFF = B_OFF + WG_BBUF * B_BYTES;
  static constexpr int SMEM = BAR_OFF + 2 * STAGES * 8 + 1024;  // + alignment slack
  static_assert(C_OFF % 1024 == 0 && B_OFF % 1024 == 0, "swizzled tiles need 1024-byte alignment");
};

// int8 code tile [WG_BK][BN] (row-major, as TMA lands it) -> bf16 tile,
// MN-major 128-byte swizzle: 64-column atoms of WG_BK rows x 128 bytes, the
// 16-byte chunk j of row k stored at chunk j ^ (k % 8).  A thread takes 16
// codes (two chunks); threads of odd atoms store their two chunks in the
// other order, so the 8 threads of a store phase hit 8 distinct bank groups.
template <int WGS, int BN>
__device__ __forceinline__ void convert_codes(const uint8_t* cs, uint8_t* bt, int ctid) {
  constexpr int PER_ROW = BN / 16, PER_THREAD = WG_BK * BN / 16 / (WGS * 128);
#pragma unroll
  for (int it = 0; it < PER_THREAD; ++it) {
    const int i = ctid + it * WGS * 128;
    const int k = i / PER_ROW, gi = i % PER_ROW;
    const uint4 v = *reinterpret_cast<const uint4*>(cs + i * 16);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t p[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float f[4];
      i8x4_to_f32(w[j], f);
      p[2 * j] = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
      p[2 * j + 1] = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
    }
    const int atom = gi / 4, ch = 2 * (gi % 4);
    uint8_t* line = bt + atom * (WG_BK * 128) + k * 128;
    const uint4 lo = make_uint4(p[0], p[1], p[2], p[3]);
    const uint4 hi = make_uint4(p[4], p[5], p[6], p[7]);
    uint4* dlo = reinterpret_cast<uint4*>(line + ((ch ^ (k & 7)) << 4));
    uint4* dhi = reinterpret_cast<uint4*>(line + (((ch + 1) ^ (k & 7)) << 4));
    if (atom & 1) { *dhi = hi; *dlo = lo; }
    else { *dlo = lo; *dhi = hi; }
  }
}

// grid (M tiles, N tiles): the blocks of one N tile run side by side and
// share its codes in L2.  Needs K % 8 == 0, N % 16 == 0 (TMA strides).
template <int WGS, int BN, int STAGES>
__global__ void __launch_bounds__(WgTiles<WGS, BN, STAGES>::THREADS, 1)
qmm_wgmma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap cmap,
          const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
  using T = WgTiles<WGS, BN, STAGES>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align_smem<1024>(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::BAR_OFF);
  uint64_t* empty = full + STAGES;
  const int m0 = blockIdx.x * T::BM, n0 = blockIdx.y * BN;
  const int k_steps = (K + WG_BK - 1) / WG_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * WGS);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * WGS) {  // producer
    if (lane == 0) {
      for (int t = 0; t < k_steps; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], ((t / STAGES) - 1) & 1);
        mbar_expect_tx(&full[s], T::X_BYTES + T::C_BYTES);
        tma_load_2d(smem + T::X_OFF + s * T::X_BYTES, &xmap, &full[s], t * WG_BK, m0);
        tma_load_2d(smem + T::C_OFF + s * T::C_BYTES, &cmap, &full[s], n0, t * WG_BK);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the tile
  const int ctid = threadIdx.x, wg = ctid / 128;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  for (int t = 0; t < k_steps; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    // Tile t % 3 was last read by the wgmma of step t - 3, which every
    // warpgroup waited for (wait_group 1 at step t - 2) before it reached
    // the barrier of step t - 1, so it is free here.
    uint8_t* bt = smem + T::B_OFF + (t % WG_BBUF) * T::B_BYTES;
    convert_codes<WGS, BN>(smem + T::C_OFF + s * T::C_BYTES, bt, ctid);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync 1, %0;\n" :: "n"(T::CONSUMERS) : "memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t xa = smem_u32(smem + T::X_OFF + s * T::X_BYTES + wg * 64 * 128);
    const uint32_t ba = smem_u32(bt);
    // A (x, K-major): a k16 step is 32 bytes into the swizzled row, 8 rows
    // of 128 bytes apart.  B (codes, MN-major): a k16 step is 16 rows of 128
    // bytes, 64-column atoms ATOM bytes apart, 8 K rows 1024 bytes apart.
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk)
      wgmma_bf16<BN>(acc, gmma_desc(xa + kk * 32, 16, 1024),
                     gmma_desc(ba + kk * 16 * 128, T::ATOM, 1024));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    // step t - 1's wgmma is done: its stage may be refilled
    if (t > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_regs(acc);

  // accumulator layout of m64nBN: register 4j + {0,1} is row r, columns
  // 8j + 2(lane % 4) + {0,1}; 4j + {2,3} the same columns of row r + 8
  const float sc = *scale;
  const int r = m0 + wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    if (col >= N) continue;  // N % 16 == 0: col + 1 < N too
    if (r < M)
      *reinterpret_cast<float2*>(out + (size_t)r * N + col) =
          make_float2(acc[4 * j] * sc, acc[4 * j + 1] * sc);
    if (r + 8 < M)
      *reinterpret_cast<float2*>(out + (size_t)(r + 8) * N + col) =
          make_float2(acc[4 * j + 2] * sc, acc[4 * j + 3] * sc);
  }
}

template <int WGS, int BN, int STAGES>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const int8_t* codes, const float* scale,
                         float* out, int M, int K, int N, cudaStream_t stream) {
  using T = WgTiles<WGS, BN, STAGES>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        qmm_wgmma<WGS, BN, STAGES>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  CUtensorMap xmap, cmap;
  if (!tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, T::BM, WG_BK,
                  CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&cmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, K, N, WG_BK, BN,
                  CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const dim3 grid((M + T::BM - 1) / T::BM, (N + BN - 1) / BN);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  qmm_wgmma<WGS, BN, STAGES><<<grid, T::THREADS, T::SMEM, stream>>>(xmap, cmap, scale, out,
                                                                     M, K, N);
  return cudaGetLastError();
}

template <typename XT, typename CT>
cudaError_t launch(const void* x, const void* codes, const void* scale, void* out,
                   int M, int K, int N, cudaStream_t stream, int path, int tile_m, int tile_n,
                   int split) {
  const XT* xp = static_cast<const XT*>(x);
  const CT* cp = static_cast<const CT*>(codes);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (path == PATH_CLUSTER) {
    if (tile_m == 4) return launch_cluster<XT, CT, 4>(xp, cp, sp, op, M, K, N, tile_n, split, stream);
    if (tile_m == 8) return launch_cluster<XT, CT, 8>(xp, cp, sp, op, M, K, N, tile_n, split, stream);
    if (tile_m == 16)
      return launch_cluster<XT, CT, 16>(xp, cp, sp, op, M, K, N, tile_n, split, stream);
    return cudaErrorInvalidValue;
  }
  if (path == PATH_WGMMA) {
    if constexpr (std::is_same<XT, __nv_bfloat16>::value && std::is_same<CT, int8_t>::value) {
      if (split != 1 || K % 8 != 0 || N % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
          reinterpret_cast<uintptr_t>(codes) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 8 != 0)
        return cudaErrorInvalidValue;
      if (tile_m == 128 && tile_n == 256)
        return launch_wgmma<2, 256, 3>(xp, cp, sp, op, M, K, N, stream);
      if (tile_m == 128 && tile_n == 128)
        return launch_wgmma<2, 128, 4>(xp, cp, sp, op, M, K, N, stream);
      if (tile_m == 64 && tile_n == 128)
        return launch_wgmma<1, 128, 3>(xp, cp, sp, op, M, K, N, stream);
      if (tile_m == 64 && tile_n == 64)
        return launch_wgmma<1, 64, 4>(xp, cp, sp, op, M, K, N, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (path == PATH_RAGGED) {
    if (tile_m == 4) return launch_ragged<XT, CT, 4>(xp, cp, sp, op, M, K, N, tile_n, split, stream);
    if (tile_m == 8) return launch_ragged<XT, CT, 8>(xp, cp, sp, op, M, K, N, tile_n, split, stream);
    if (tile_m == 16)
      return launch_ragged<XT, CT, 16>(xp, cp, sp, op, M, K, N, tile_n, split, stream);
    return cudaErrorInvalidValue;
  }
  if (path == PATH_TILED) {
    const dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
    qmm_tiled<XT, CT><<<grid, TB_THREADS, 0, stream>>>(xp, cp, sp, op, M, K, N);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// The shared memory a block of repro_quant_matmul's launch takes with this
// plan (dynamic on the cluster and wgmma paths, static on the tiled one), by
// the launch's own arithmetic; -1 for a plan the launcher does not take.
extern "C" int repro_quant_matmul_smem(int x_dtype, int code_dtype, int M, int K, int N,
                                       int path, int tile_m, int tile_n, int split) {
  const int xsz = x_dtype == DT_BF16 ? 2 : 4, sz = code_dtype == DT_I16 ? 2 : 1;
  if (path == PATH_CLUSTER) {
    if (tile_m != 4 && tile_m != 8 && tile_m != 16) return -1;
    const int lanes = tile_n / (CL_ACC / tile_m);
    if (lanes < 1 || lanes > 32) return -1;
    return cluster_geom(M, K, tile_n, split, lanes, sz, xsz).smem;
  }
  if (path == PATH_WGMMA) {
    if (tile_m == 128 && tile_n == 256) return WgTiles<2, 256, 3>::SMEM;
    if (tile_m == 128 && tile_n == 128) return WgTiles<2, 128, 4>::SMEM;
    if (tile_m == 64 && tile_n == 128) return WgTiles<1, 128, 3>::SMEM;
    if (tile_m == 64 && tile_n == 64) return WgTiles<1, 64, 4>::SMEM;
    return -1;
  }
  if (path == PATH_RAGGED) {
    if (tile_m != 4 && tile_m != 8 && tile_m != 16) return -1;
    const int lanes = tile_n / (CL_ACC / tile_m);
    if (lanes < 1 || lanes > 32 || split < 1) return -1;
    return ragged_geom(K, tile_n, split, lanes, sz, tile_m).smem;
  }
  if (path == PATH_TILED) return static_cast<int>(sizeof(float)) * TB_K * (TB_M + TB_N);
  return -1;
}

// x_dtype: DT_F32 | DT_BF16; code_dtype: DT_I8 | DT_I16.  (path, tile_m,
// tile_n, split) is the plan of kernels/quant_matmul.py:plan; a plan the
// kernels do not take returns cudaErrorInvalidValue.  Returns a cudaError_t.
extern "C" int repro_quant_matmul(const void* x, int x_dtype, const void* codes, int code_dtype,
                                  const void* scale, void* out, int M, int K, int N,
                                  void* stream, int path, int tile_m, int tile_n, int split) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == DT_F32 && code_dtype == DT_I8)
    return launch<float, int8_t>(x, codes, scale, out, M, K, N, st, path, tile_m, tile_n, split);
  if (x_dtype == DT_F32 && code_dtype == DT_I16)
    return launch<float, int16_t>(x, codes, scale, out, M, K, N, st, path, tile_m, tile_n, split);
  if (x_dtype == DT_BF16 && code_dtype == DT_I8)
    return launch<__nv_bfloat16, int8_t>(x, codes, scale, out, M, K, N, st, path, tile_m, tile_n,
                                         split);
  if (x_dtype == DT_BF16 && code_dtype == DT_I16)
    return launch<__nv_bfloat16, int16_t>(x, codes, scale, out, M, K, N, st, path, tile_m, tile_n,
                                          split);
  return static_cast<int>(cudaErrorInvalidValue);
}
