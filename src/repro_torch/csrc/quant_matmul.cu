// K3 quant_matmul: out (M,N) f32 = x (M,K) f32|bf16 @ (codes (K,N) int8|int16 * scale).
//
// Replaces the Pallas kernel repro/kernels/quant_matmul.py:quant_matmul_kernel.
// The weight streams from device memory as int8/int16 codes and is converted
// to f32 only on chip; sums are kept in f32.  The scalar scale is a device
// tensor read inside the kernel (no host sync per call).
//
// What bounds it on an H100: decode (M <= 16) reads K*N code bytes for
// 2*M*K*N operations, far below the ~295 ops/byte ridge, so it is bound by
// the weight bytes.  Prefill (M = 4 x bucket) is bound by operations.
//
// Design:
//  * small M (decode, M <= 16): a thread keeps 64 accumulators, MAXM rows
//    (4, 8 or 16, picked from M) by 64/MAXM adjacent columns, so at M <= 4
//    a lane reads 16 int8 codes of a row with one 16-byte load (512 columns
//    per warp) and the unrolled row loop keeps several such loads in flight:
//    the bytes in flight, not the arithmetic, set the speed of this path.
//    Codes become floats by byte splicing (exact) instead of the conversion
//    pipe.  Eight warps of a block split the K rows of the block's chunk,
//    and blocks split K again (grid.y) until about two blocks per SM are in
//    flight; partial sums meet through conflict-free shared-memory atomics
//    and one global atomic per output, into an output the launcher zeroes
//    first.  The
//    scale multiplies the partial sum once (x @ codes * s == x @ (codes * s)
//    up to f32 rounding).
//  * large M, bf16 x and int8 codes (prefill on the serving path): tensor
//    cores.  A 128x128 output tile per block of 8 warps, K in steps of 32;
//    codes become bf16 (exact for int8) as their tile lands in shared memory,
//    and mma.sync m16n8k16 accumulates in f32.  Single-stage (no cp.async
//    pipeline, no wgmma): a first tensor-core path, not a tuned one.
//  * large M otherwise (f32 x, int16 codes, unaligned shapes): a 128x128
//    output tile per block of 256 threads on the FP32 pipes, each thread 8x8,
//    K in steps of 8.  Codes are dequantized (code * scale, f32) as the tile
//    lands in shared memory, as the Pallas body does per tile.
//  Ragged M/N/K are masked in the loads; nothing is padded in memory.

#include <type_traits>

#include "common.cuh"

namespace {

// ---------------------------------------------------------------- small M
constexpr int SM_THREADS = 256;
constexpr int SM_WARPS = SM_THREADS / 32;
constexpr int SM_KTILE = 128;  // rows of x staged in shared memory at a time
constexpr int SM_ACC = 64;     // accumulators per thread: MAXM rows x CPL columns

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

// CPL adjacent codes of one row, as floats.  ``vec``: every row start is
// aligned for the vector loads (checked by the launcher).
template <typename CT, int CPL>
__device__ __forceinline__ void load_codes(const CT* __restrict__ row, int n0, int N, bool vec,
                                           float (&w)[CPL]) {
  constexpr int BYTES = CPL * static_cast<int>(sizeof(CT));
  constexpr int WORDS = BYTES / 4;
  if (vec && n0 + CPL <= N) {
    const char* p = reinterpret_cast<const char*>(row + n0);
    uint32_t u[WORDS];
    if constexpr (BYTES % 16 == 0) {
#pragma unroll
      for (int c = 0; c < BYTES / 16; ++c) {
        const uint4 v = __ldg(reinterpret_cast<const uint4*>(p) + c);
        u[4 * c] = v.x; u[4 * c + 1] = v.y; u[4 * c + 2] = v.z; u[4 * c + 3] = v.w;
      }
    } else if constexpr (BYTES == 8) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      u[0] = v.x; u[1] = v.y;
    } else {
      u[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
    }
#pragma unroll
    for (int i = 0; i < WORDS; ++i) {
      if constexpr (sizeof(CT) == 1) i8x4_to_f32(u[i], &w[4 * i]);
      else i16x2_to_f32(u[i], &w[2 * i]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c) w[c] = (n0 + c < N) ? static_cast<float>(row[n0 + c]) : 0.f;
  }
}

template <typename XT, typename CT, int MAXM>
__global__ void __launch_bounds__(SM_THREADS)
qmm_small_m(const XT* __restrict__ x, const CT* __restrict__ codes,
            const float* __restrict__ scale, float* __restrict__ out,
            int M, int K, int N, int k_per_block, int vec) {
  constexpr int CPL = SM_ACC / MAXM;  // columns per lane
  constexpr int COLS = 32 * CPL;      // columns per block
  __shared__ float xs[MAXM][SM_KTILE];
  // partial sums of the block's warps, [m][c][lane]: a warp's 32 lanes add
  // into 32 consecutive words, free of bank conflicts
  __shared__ float red[MAXM][CPL][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * COLS + lane * CPL;
  const int kb0 = blockIdx.y * k_per_block;
  const int kb1 = min(K, kb0 + k_per_block);

  for (int i = threadIdx.x; i < MAXM * COLS; i += SM_THREADS) (&red[0][0][0])[i] = 0.f;

  float acc[MAXM][CPL];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[m][c] = 0.f;

  for (int kt = kb0; kt < kb1; kt += SM_KTILE) {
    const int kn = min(SM_KTILE, kb1 - kt);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < M * SM_KTILE; i += SM_THREADS) {
      const int m = i / SM_KTILE, kk = i % SM_KTILE;
      xs[m][kk] = kk < kn ? to_f32(x[(size_t)m * K + kt + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = warp; kk < kn; kk += SM_WARPS) {
      float w[CPL];
      load_codes<CT, CPL>(codes + (size_t)(kt + kk) * N, n0, N, vec != 0, w);
#pragma unroll
      for (int m = 0; m < MAXM; ++m) {
        if (m < M) {
          const float xv = xs[m][kk];
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[m][c] = fmaf(xv, w[c], acc[m][c]);
        }
      }
    }
  }
  __syncthreads();  // red is initialised (also when this block had no rows)
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < M) {
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (n0 + c < N) atomicAdd(&red[m][c][lane], acc[m][c]);
    }
  }
  __syncthreads();
  const float s = *scale;
  for (int i = threadIdx.x; i < M * COLS; i += SM_THREADS) {
    const int m = i / COLS, col = i % COLS;  // column col is lane col / CPL's
    const int n = blockIdx.x * COLS + col;
    if (n < N) atomicAdd(&out[(size_t)m * N + n], red[m][col % CPL][col / CPL] * s);
  }
}

template <typename XT, typename CT, int MAXM>
cudaError_t launch_small_m(const XT* x, const CT* codes, const float* scale, float* out,
                           int M, int K, int N, cudaStream_t stream, int num_sms) {
  constexpr int CPL = SM_ACC / MAXM;
  constexpr int COLS = 32 * CPL;
  constexpr int ALIGN = CPL * static_cast<int>(sizeof(CT)) < 16
                            ? CPL * static_cast<int>(sizeof(CT)) : 16;
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float) * (size_t)M * N, stream);
  if (err != cudaSuccess) return err;
  const int col_blocks = (N + COLS - 1) / COLS;
  // split K until about two blocks per SM are in flight (<= 128 registers a
  // thread lets two share an SM), keeping >= 64 rows a block; each split
  // adds one atomic per output element
  int splits = (2 * num_sms + col_blocks - 1) / col_blocks;
  splits = max(1, min(splits, (K + 63) / 64));
  const int k_per_block = (K + splits - 1) / splits;
  splits = (K + k_per_block - 1) / k_per_block;
  const int vec = ((size_t)N * sizeof(CT) % ALIGN == 0 &&
                   reinterpret_cast<uintptr_t>(codes) % ALIGN == 0) ? 1 : 0;
  qmm_small_m<XT, CT, MAXM><<<dim3(col_blocks, splits), SM_THREADS, 0, stream>>>(
      x, codes, scale, out, M, K, N, k_per_block, vec);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- large M
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

// ------------------------------------------- large M, bf16 x, int8 codes
// Tensor cores: mma.sync m16n8k16 bf16 x bf16 -> f32.  int8 codes are exact
// in bf16 and bf16 x int8 products are exact in f32, so only the order of the
// f32 sums differs from the plain version; the scale multiplies the sum.
constexpr int MM_BM = 128, MM_BN = 128, MM_BK = 32, MM_PAD = 8;
constexpr int MM_THREADS = 256;  // 8 warps: 2 (M) x 4 (N), 64 x 32 outputs each

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(const __nv_bfloat16& lo, const __nv_bfloat16& hi) {
  return static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&lo)) |
         (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}

// Needs K % 8 == 0, N % 16 == 0 and 16-byte aligned x and codes (the
// launcher checks); ragged M, N and K tiles are masked in the loads.
__global__ void __launch_bounds__(MM_THREADS)
qmm_mma_bf16_i8(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
                const float* __restrict__ scale, float* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 As[MM_BM][MM_BK + MM_PAD];   // x tile
  __shared__ __align__(16) __nv_bfloat16 Bs[MM_BK][MM_BN + MM_PAD];   // codes tile, bf16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / 4, wn = warp % 4;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MM_BK) {
    // x: 128 rows x 32 k, 16-byte chunks of 8 bf16
    for (int i = tid; i < MM_BM * MM_BK / 8; i += MM_THREADS) {
      const int r = i / (MM_BK / 8), c = (i % (MM_BK / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < K) v = *reinterpret_cast<const uint4*>(x + (size_t)m * K + k);
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    // codes: 32 k x 128 n, one 16-byte chunk per thread, converted to bf16
    {
      const int kk = tid / (MM_BN / 16), c = (tid % (MM_BN / 16)) * 16;
      const int k = k0 + kk, n = n0 + c;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && n < N) v = __ldg(reinterpret_cast<const uint4*>(codes + (size_t)k * N + n));
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
      uint32_t packed[8];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        float f[4];
        i8x4_to_f32(words[w], f);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
        packed[2 * w] = *reinterpret_cast<const uint32_t*>(&lo);
        packed[2 * w + 1] = *reinterpret_cast<const uint32_t*>(&hi);
      }
      uint4* dst = reinterpret_cast<uint4*>(&Bs[kk][c]);
      dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
      dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MM_BK; ks += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int r = wm * 64 + mi * 16 + g;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 2 * t]);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 2 * t]);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(&As[r][ks + 2 * t + 8]);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = wn * 32 + ni * 8 + g;
        b[ni][0] = pack_bf16(Bs[ks + 2 * t][c], Bs[ks + 2 * t + 1][c]);
        b[ni][1] = pack_bf16(Bs[ks + 2 * t + 8][c], Bs[ks + 2 * t + 9][c]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16_16816(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }
  const float s = *scale;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm * 64 + mi * 16 + g;
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;   // N % 16 == 0: col + 1 < N too
      if (col >= N) continue;
      if (row < M) {
        out[(size_t)row * N + col] = acc[mi][ni][0] * s;
        out[(size_t)row * N + col + 1] = acc[mi][ni][1] * s;
      }
      if (row + 8 < M) {
        out[(size_t)(row + 8) * N + col] = acc[mi][ni][2] * s;
        out[(size_t)(row + 8) * N + col + 1] = acc[mi][ni][3] * s;
      }
    }
  }
}

template <typename XT, typename CT>
cudaError_t launch(const void* x, const void* codes, const void* scale, void* out,
                   int M, int K, int N, cudaStream_t stream, int num_sms) {
  const XT* xp = static_cast<const XT*>(x);
  const CT* cp = static_cast<const CT*>(codes);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (M <= 4) return launch_small_m<XT, CT, 4>(xp, cp, sp, op, M, K, N, stream, num_sms);
  if (M <= 8) return launch_small_m<XT, CT, 8>(xp, cp, sp, op, M, K, N, stream, num_sms);
  if (M <= 16) return launch_small_m<XT, CT, 16>(xp, cp, sp, op, M, K, N, stream, num_sms);
  if constexpr (std::is_same<XT, __nv_bfloat16>::value && std::is_same<CT, int8_t>::value) {
    if (K % 8 == 0 && N % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(codes) % 16 == 0) {
      const dim3 grid((N + MM_BN - 1) / MM_BN, (M + MM_BM - 1) / MM_BM);
      qmm_mma_bf16_i8<<<grid, MM_THREADS, 0, stream>>>(xp, cp, sp, op, M, K, N);
      return cudaGetLastError();
    }
  }
  const dim3 grid((N + TB_N - 1) / TB_N, (M + TB_M - 1) / TB_M);
  qmm_tiled<XT, CT><<<grid, TB_THREADS, 0, stream>>>(xp, cp, sp, op, M, K, N);
  return cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

}  // namespace

// x_dtype: DT_F32 | DT_BF16; code_dtype: DT_I8 | DT_I16.  Returns a cudaError_t.
extern "C" int repro_quant_matmul(const void* x, int x_dtype, const void* codes, int code_dtype,
                                  const void* scale, void* out, int M, int K, int N,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sms = sm_count();
  if (x_dtype == DT_F32 && code_dtype == DT_I8)
    return launch<float, int8_t>(x, codes, scale, out, M, K, N, st, sms);
  if (x_dtype == DT_F32 && code_dtype == DT_I16)
    return launch<float, int16_t>(x, codes, scale, out, M, K, N, st, sms);
  if (x_dtype == DT_BF16 && code_dtype == DT_I8)
    return launch<__nv_bfloat16, int8_t>(x, codes, scale, out, M, K, N, st, sms);
  if (x_dtype == DT_BF16 && code_dtype == DT_I16)
    return launch<__nv_bfloat16, int16_t>(x, codes, scale, out, M, K, N, st, sms);
  return static_cast<int>(cudaErrorInvalidValue);
}
