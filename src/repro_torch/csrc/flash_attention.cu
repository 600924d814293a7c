// K4 flash_attention (prefill) and K5 flash_decode (paged decode).
//
// K4 replaces repro/kernels/flash_attention.py:flash_attention_kernel.
//   q, k, v (BH, S, D) f32|bf16 -> out (BH, S, D) in q's dtype; online softmax
//   in f32, causal or not, keys >= S masked in the kernel (no padding of S).
//   Bound on an H100: at the prefill shapes (S <= 256, D = 128) the work is
//   small next to the projections; per block it is bound by the FP32 pipes
//   (scores and P@V are computed with FMAs, not tensor cores).
//   Design: one block of 8 warps per (q-tile of 64 rows, bh).  The block
//   stages 32 keys and values at a time in shared memory as f32 (K rows padded
//   to D+1 floats so that lane j reading key j is free of bank conflicts).
//   Each warp owns 8 query rows; lane j scores key j, the warp reduces the
//   row max and sum with shuffles, and each lane accumulates D/32 output
//   columns.  The key loop stops at the causal diagonal of the q-tile (the
//   pl.when skip of the Pallas body).  Shared memory exceeds 48 KB at D = 128,
//   so it is dynamic and the launcher raises the per-kernel limit.
//
// K5 replaces repro/kernels/flash_attention.py:flash_decode_kernel.
//   One query token per slot, q (B, KV, G, hd) grouped under its KV head,
//   against a shared page pool (N_pool, page, KV, hd) f32|bf16 through a
//   per-slot page table (B, n_pmax) int32 and lengths (B,) int32.  Returns the
//   unnormalised partials acc (B, KV, G, hd), m and l (B, KV, G, 1) in f32.
//   Bound on an H100: bytes of the pages each slot owns (one pass over them).
//   Design: one block of 8 warps per (KV head, slot).  The TPU's sequential
//   page axis and its scratch carry become 8 page walks in parallel inside
//   the block: warp w takes pages w, w+8, ..., stages each page's K and V
//   (16 tokens at a time) in its own shared-memory buffer with only warp
//   barriers, and keeps its own online softmax for all G queries; at the end
//   the warps' (m, l, acc) are merged as the reference's sequence-parallel
//   path merges shards.  A warp reads page_table[b, j] itself and skips the
//   page WITHOUT touching the pool when the entry is -1 or the page starts
//   at or past the slot's length (the Pallas index map instead clamps -1 to
//   page 0 and masks); tokens past the length are neither scored nor read.
//   A slot with no valid page returns m = -1e30, l = 0, acc = 0, as the
//   reference does.  No G padding: the reference pads G to 8 only for the
//   TPU's sublanes.  At the yi-6b decode shape this is 4 x 4 = 16 blocks on
//   132 SMs; splitting pages across blocks as well is later work.

#include "common.cuh"

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

// ---------------------------------------------------------------- K4
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

template <typename T>
cudaError_t dispatch_fa(const void* q, const void* k, const void* v, void* out, int BH, int S,
                        int D, int causal, cudaStream_t st) {
  switch (D) {
    case 16: return launch_fa<T, 16>(q, k, v, out, BH, S, causal, st);
    case 32: return launch_fa<T, 32>(q, k, v, out, BH, S, causal, st);
    case 64: return launch_fa<T, 64>(q, k, v, out, BH, S, causal, st);
    case 128: return launch_fa<T, 128>(q, k, v, out, BH, S, causal, st);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------- K5
constexpr int FD_WARPS = 8;
constexpr int FD_MAXG = 16;   // queries per KV head a warp keeps in registers
constexpr int FD_CHUNK = 16;  // tokens a warp stages in shared memory at a time

// Shared-memory floats of one launch: q, then either the warps' page buffers
// or, after the page loop, the warps' partial (m, l, acc) for the merge.
__host__ __device__ constexpr size_t fd_smem_floats(int G, int HD) {
  const size_t pages = (size_t)FD_WARPS * FD_CHUNK * (2 * HD + 1);
  const size_t merge = (size_t)FD_WARPS * G * (HD + 2);
  return (size_t)G * HD + (pages > merge ? pages : merge);
}

template <typename QT, typename PT, int HD>
__global__ void __launch_bounds__(FD_WARPS * 32)
flash_decode(const QT* __restrict__ q, const PT* __restrict__ k_pages,
             const PT* __restrict__ v_pages, const int* __restrict__ page_table,
             const int* __restrict__ lengths, float* __restrict__ acc_out,
             float* __restrict__ m_out, float* __restrict__ l_out,
             int KV, int G, int page, int n_pmax, float scale) {
  constexpr int DPL = (HD + 31) / 32;
  extern __shared__ float smem[];
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t qbase = ((size_t)b * KV + h) * G;
  float* qs = smem;                                               // G x HD, pre-scaled
  float* ks = qs + G * HD + (size_t)warp * FD_CHUNK * (2 * HD + 1);  // FD_CHUNK x (HD+1)
  float* vs = ks + FD_CHUNK * (HD + 1);                            // FD_CHUNK x HD

  for (int i = tid; i < G * HD; i += FD_WARPS * 32)
    qs[i] = to_f32(q[qbase * HD + i]) * scale;
  __syncthreads();

  float m_r[FD_MAXG], l_r[FD_MAXG], acc[FD_MAXG][DPL];
#pragma unroll
  for (int g = 0; g < FD_MAXG; ++g) {
    m_r[g] = NEG_INF;
    l_r[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
  }

  // warp w walks pages w, w + FD_WARPS, ... with its own online softmax
  const int len = lengths[b];
  for (int j = warp; j < n_pmax; j += FD_WARPS) {
    const int pid = page_table[(size_t)b * n_pmax + j];
    if (pid < 0 || j * page >= len) continue;  // never read the pool for it
    for (int t0 = 0; t0 < page && j * page + t0 < len; t0 += FD_CHUNK) {
      const int n_tok = min(FD_CHUNK, page - t0);
      __syncwarp();  // the previous chunk is consumed
      for (int i = lane; i < n_tok * HD; i += 32) {
        const int t = i / HD, d = i % HD;
        const size_t off = (((size_t)pid * page + t0 + t) * KV + h) * HD + d;
        ks[t * (HD + 1) + d] = to_f32(k_pages[off]);
        vs[t * HD + d] = to_f32(v_pages[off]);
      }
      __syncwarp();
      const bool valid = lane < n_tok && j * page + t0 + lane < len;
#pragma unroll
      for (int g = 0; g < FD_MAXG; ++g) {
        if (g < G) {  // warp-uniform
          float s = NEG_INF;
          if (valid) {
            float dot = 0.f;
#pragma unroll 16
            for (int d = 0; d < HD; ++d) dot = fmaf(qs[g * HD + d], ks[lane * (HD + 1) + d], dot);
            s = dot;
          }
          const float m_new = fmaxf(m_r[g], warp_max(s));
          const float p = valid ? expf(s - m_new) : 0.f;
          const float corr = expf(m_r[g] - m_new);
          l_r[g] = l_r[g] * corr + warp_sum(p);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] *= corr;
          for (int jj = 0; jj < n_tok; ++jj) {
            const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
              const int d = lane + 32 * i;
              if (d < HD) acc[g][i] = fmaf(pj, vs[jj * HD + d], acc[g][i]);
            }
          }
          m_r[g] = m_new;
        }
      }
    }
  }

  // merge the warps' partials (a warp that saw no page holds m = -1e30,
  // l = 0, acc = 0 and adds nothing; with no page at all the result is that)
  __syncthreads();  // the page buffers are free
  float* pm = smem + G * HD;              // FD_WARPS x G
  float* pl = pm + FD_WARPS * G;          // FD_WARPS x G
  float* pa = pl + FD_WARPS * G;          // FD_WARPS x G x HD
#pragma unroll
  for (int g = 0; g < FD_MAXG; ++g) {
    if (g < G) {
      if (lane == 0) {
        pm[warp * G + g] = m_r[g];
        pl[warp * G + g] = l_r[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) pa[((size_t)warp * G + g) * HD + d] = acc[g][i];
      }
    }
  }
  __syncthreads();
  for (int g = warp; g < G; g += FD_WARPS) {
    float mx = NEG_INF;
    for (int w = 0; w < FD_WARPS; ++w) mx = fmaxf(mx, pm[w * G + g]);
    float lsum = 0.f, a[DPL];
#pragma unroll
    for (int i = 0; i < DPL; ++i) a[i] = 0.f;
    for (int w = 0; w < FD_WARPS; ++w) {
      const float c = expf(pm[w * G + g] - mx);
      lsum = fmaf(pl[w * G + g], c, lsum);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < HD) a[i] = fmaf(pa[((size_t)w * G + g) * HD + d], c, a[i]);
      }
    }
    const size_t row = qbase + g;
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < HD) acc_out[row * HD + d] = a[i];
    }
    if (lane == 0) {
      m_out[row] = mx;
      l_out[row] = lsum;
    }
  }
}

template <typename QT, typename PT, int HD>
cudaError_t launch_fd(const void* q, const void* kp, const void* vp, const void* pt,
                      const void* len, void* acc, void* m, void* l, int B, int KV, int G,
                      int page, int n_pmax, cudaStream_t stream) {
  if (G > FD_MAXG) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * fd_smem_floats(G, HD);
  auto kern = flash_decode<QT, PT, HD>;
  cudaError_t err = raise_smem_limit<flash_decode<QT, PT, HD>>(smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(KV, B), FD_WARPS * 32, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const PT*>(kp), static_cast<const PT*>(vp),
      static_cast<const int*>(pt), static_cast<const int*>(len), static_cast<float*>(acc),
      static_cast<float*>(m), static_cast<float*>(l), KV, G, page, n_pmax,
      1.f / sqrtf(static_cast<float>(HD)));
  return cudaGetLastError();
}

template <typename QT, typename PT>
cudaError_t dispatch_fd(const void* q, const void* kp, const void* vp, const void* pt,
                        const void* len, void* acc, void* m, void* l, int B, int KV, int G,
                        int hd, int page, int n_pmax, cudaStream_t st) {
  switch (hd) {
    case 16: return launch_fd<QT, PT, 16>(q, kp, vp, pt, len, acc, m, l, B, KV, G, page, n_pmax, st);
    case 32: return launch_fd<QT, PT, 32>(q, kp, vp, pt, len, acc, m, l, B, KV, G, page, n_pmax, st);
    case 64: return launch_fd<QT, PT, 64>(q, kp, vp, pt, len, acc, m, l, B, KV, G, page, n_pmax, st);
    case 128: return launch_fd<QT, PT, 128>(q, kp, vp, pt, len, acc, m, l, B, KV, G, page, n_pmax, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: DT_F32 | DT_BF16 (q, k, v and out share it).  Returns a cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     int dtype, int BH, int S, int D, int causal,
                                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return dispatch_fa<float>(q, k, v, out, BH, S, D, causal, st);
  if (dtype == DT_BF16) return dispatch_fa<__nv_bfloat16>(q, k, v, out, BH, S, D, causal, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q_dtype, pool_dtype: DT_F32 | DT_BF16.  Returns a cudaError_t.
extern "C" int repro_flash_decode(const void* q, int q_dtype, const void* k_pages,
                                  const void* v_pages, int pool_dtype, const void* page_table,
                                  const void* lengths, void* acc, void* m, void* l, int B,
                                  int KV, int G, int hd, int page, int n_pmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (q_dtype == DT_F32 && pool_dtype == DT_F32)
    return dispatch_fd<float, float>(q, k_pages, v_pages, page_table, lengths, acc, m, l, B,
                                     KV, G, hd, page, n_pmax, st);
  if (q_dtype == DT_F32 && pool_dtype == DT_BF16)
    return dispatch_fd<float, __nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, acc, m,
                                             l, B, KV, G, hd, page, n_pmax, st);
  if (q_dtype == DT_BF16 && pool_dtype == DT_F32)
    return dispatch_fd<__nv_bfloat16, float>(q, k_pages, v_pages, page_table, lengths, acc, m,
                                             l, B, KV, G, hd, page, n_pmax, st);
  if (q_dtype == DT_BF16 && pool_dtype == DT_BF16)
    return dispatch_fd<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, page_table, lengths,
                                                     acc, m, l, B, KV, G, hd, page, n_pmax, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
