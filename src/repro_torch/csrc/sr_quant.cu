// K1: fused stochastic-rounding quantization (paper Eq. 1) for Hopper.
//
// Replaces the Pallas kernel repro/kernels/sr_quant.py:sr_quant_fake_kernel
// (t = w/step; (floor(t) + [u < t - floor(t)]) * step; step == 0 returns w)
// together with the clip to [-s, s] its callers apply.  The TPU kernel
// quantizes one (M, N) tensor at one step; this one quantizes every
// (client, leaf) segment of an FL round in a single launch:
//
//   w (P,) f32          the round's quantizable leaves, concatenated
//   offsets (L+1,) i32  leaf l is w[offsets[l] : offsets[l+1]]
//   s (L,) f32          per-leaf scale, computed outside the kernel
//   d (C,) f32          per-client resolution Delta
//   u (C, P) f32        uniforms, drawn outside the kernel
//   out (C, P) f32
//
// Per element: step = s_l * d_c (as core/quantization.sr_quantize computes
// it); q rounded as above and clipped to [-s_l, s_l]; step > 0 ? q : w; and
// in STE mode the value w + (q - w), the reference's straight-through
// forward value (ops.sr_quantize_fused takes q itself).  Every
// operation is an IEEE round-to-nearest intrinsic (no contraction, no fast
// math), so the result is bit-equal to the plain PyTorch version for the
// same u.
//
// Bound: bytes.  Each element does ~10 FP32 operations for 8 bytes read
// (w is read once per client, from L2 after the first) and 4 written; the
// H100 needs ~20 FP32 operations per byte to be compute-bound.  Consecutive
// threads take consecutive elements, so every load and store is coalesced;
// blockIdx.y is the client and a grid-stride loop covers P.  A thread finds
// its leaf by binary search over the offsets (L1-resident; no search when
// L = 1).  The trainer's inline entry (one tensor, uniforms drawn in the
// kernel) follows the segment entry.

#include "common.cuh"

namespace {

// Eq. 1 at pitch `step` for one element, clipped to [-s, s] (as jnp.clip:
// a NaN passes through); step > 0 ? q : w.  IEEE round-to-nearest
// intrinsics only, so every caller is bit-equal to the plain version.
__device__ __forceinline__ float sr_round(float wv, float u, float s, float step) {
  if (!(step > 0.0f)) return wv;
  const float t = __fdiv_rn(wv, step);
  const float lower = floorf(t);
  const float bern = (u < __fsub_rn(t, lower)) ? 1.0f : 0.0f;
  float q = __fmul_rn(__fadd_rn(lower, bern), step);
  q = q < -s ? -s : q;
  q = q > s ? s : q;
  return q;
}

// The reference's straight-through forward value w + (q - w).
__device__ __forceinline__ float ste(float wv, float q) {
  return __fadd_rn(wv, __fsub_rn(q, wv));
}

__global__ void __launch_bounds__(256)
sr_quant_kernel(const float* __restrict__ w, const int* __restrict__ offsets,
                const float* __restrict__ s, const float* __restrict__ d,
                const float* __restrict__ u, float* __restrict__ out, int P, int L,
                int ste_out) {
  const int c = blockIdx.y;
  const float dc = __ldg(d + c);
  const float* uc = u + static_cast<int64_t>(c) * P;
  float* oc = out + static_cast<int64_t>(c) * P;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < P;
       p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int lo = 0, hi = L;  // the leaf l with offsets[l] <= p < offsets[l+1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(offsets + mid) <= p) lo = mid; else hi = mid;
    }
    const float sl = __ldg(s + lo);
    const float wv = __ldg(w + p);
    const float q = sr_round(wv, __ldg(uc + p), sl, __fmul_rn(sl, dc));
    oc[p] = ste_out ? ste(wv, q) : q;
  }
}

}  // namespace

extern "C" int repro_sr_quant(const float* w, const int* offsets, const float* s,
                              const float* d, const float* u, float* out, int P, int L,
                              int C, int ste_out, cudaStream_t stream) {
  if (P <= 0 || C <= 0) return 0;
  constexpr int threads = 256;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // enough blocks for 8 resident per SM across all clients, no more than P needs
  const long long want = (8LL * sms + C - 1) / C;
  const long long need = (P + threads - 1) / threads;
  const int gx = static_cast<int>(need < want ? need : (want > 0 ? want : 1));
  dim3 grid(gx, C);
  sr_quant_kernel<<<grid, threads, 0, stream>>>(w, offsets, s, d, u, out, P, L, ste_out);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K1, the inline entry: the trainer's whole quantizer for one weight use.
//
// The same Eq. 1 as above for a single tensor, with everything the trainer
// did around it moved inside (core/quantization.sr_quantize_keyed):
//
//   w (n,) f32          one weight use (a layer's slice of a stacked leaf)
//   parts (n_parts,)    scratch: max|w| of each block of the first pass
//   delta (1,) f32      the client's resolution, read on the device
//   (k0, k1)            the site's 64-bit key
//   out (n,)            f32 or bf16, the compute dtype
//
// Pass 1 (sr_absmax_kernel) reads w once and writes one partial max|w| a
// block; pass 2 (sr_quant_inline_kernel) folds the partials in every block
// (s = max|w|, or 1 where that is not > 0, as tensor_scale), draws element
// i's uniform u_i = (x >> 8) * 2^-24 with x word i % 4 of Philox4x32-10 at
// counter (i / 4, i / 4 >> 32, 0, 0) and key (k0, k1), rounds as the segment
// entry does at step = s * delta, and writes the straight-through value
// w + (q - w) rounded to the output type.  No uniforms, no scale and no f32
// copy touch device memory, and the host never waits: the scale and delta
// stay on the device.
//
// Bound: bytes, 4 read and 2 (bf16) or 4 (f32) written an element, against
// Philox's 80 integer instructions per 4 elements (10 rounds of two
// multiply-highs, two multiply-lows, two three-way XORs, two key adds) on
// the INT32 lanes, which sit within 1.5x of the byte time; the float work
// runs on the FP32 pipes beside them.  A thread takes four consecutive
// elements, one Philox call, a 16-byte load and an 8- or 16-byte store; a
// base or an output that is not aligned for those takes scalar accesses, as
// does the tail of n % 4 elements.  The max|w| partials are exact, so the
// scale does not depend on the grid (the bits of |w| order as unsigned
// integers, a NaN above every number, as amax propagates it).

namespace {

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x), lo0 = 0xD2511F53u * c.x;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z), lo1 = 0xCD9E8D57u * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
    k0 += 0x9E3779B9u;
    k1 += 0xBB67AE85u;
  }
  return c;
}

// The top 24 bits as a uniform in [0, 1) (exact in f32).
__device__ __forceinline__ float philox_uniform(uint32_t x) {
  return __fmul_rn(__uint2float_rn(x >> 8), 5.9604644775390625e-8f);  // 2^-24
}

__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

// max over the block, returned to every thread
__device__ __forceinline__ uint32_t block_max(uint32_t m) {
  __shared__ uint32_t warp_max[32];
  m = __reduce_max_sync(0xffffffffu, m);
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = 0;
  for (int i = 0; i < static_cast<int>(blockDim.x >> 5); ++i) m = max(m, warp_max[i]);
  return m;
}

__global__ void __launch_bounds__(512)
sr_absmax_kernel(const float* __restrict__ w, int64_t n, float* __restrict__ parts) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  uint32_t m = 0;
  int64_t body = 0;
  if ((reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    const float4* w4 = reinterpret_cast<const float4*>(w);
    const int64_t n4 = n >> 2;
    int64_t i = tid;
    for (; i + 3 * stride < n4; i += 4 * stride) {   // four 16-byte loads in flight
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __ldg(w4 + i + k * stride);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m = max(m, max(max(abs_bits(v[k].x), abs_bits(v[k].y)),
                       max(abs_bits(v[k].z), abs_bits(v[k].w))));
    }
    for (; i < n4; i += stride) {
      const float4 v = __ldg(w4 + i);
      m = max(m, max(max(abs_bits(v.x), abs_bits(v.y)), max(abs_bits(v.z), abs_bits(v.w))));
    }
    body = n4 << 2;
  }
  for (int64_t i = body + tid; i < n; i += stride) m = max(m, abs_bits(__ldg(w + i)));
  m = block_max(m);
  if (threadIdx.x == 0) parts[blockIdx.x] = __uint_as_float(m);
}

__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store4(float* o, float4 v) { *reinterpret_cast<float4*>(o) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                            *reinterpret_cast<const uint32_t*>(&b));
}

template <typename Out>
__global__ void __launch_bounds__(256)
sr_quant_inline_kernel(const float* __restrict__ w, const float* __restrict__ parts,
                       int n_parts, const float* __restrict__ delta, uint32_t k0, uint32_t k1,
                       Out* __restrict__ out, int64_t n) {
  uint32_t m = 0;
  for (int i = threadIdx.x; i < n_parts; i += blockDim.x)
    m = max(m, __float_as_uint(__ldg(parts + i)));
  const float smax = __uint_as_float(block_max(m));
  const float s = smax > 0.0f ? smax : 1.0f;
  const float step = __fmul_rn(s, __ldg(delta));
  const bool vec = ((reinterpret_cast<uintptr_t>(w) & 15) |
                    (reinterpret_cast<uintptr_t>(out) & (4 * sizeof(Out) - 1))) == 0;
  const int64_t groups = (n + 3) >> 2;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; g < groups;
       g += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t i0 = g << 2;
    const uint4 ctr = make_uint4(static_cast<uint32_t>(g), static_cast<uint32_t>(g >> 32), 0u, 0u);
    if (vec && i0 + 4 <= n) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(w) + g);
      const uint4 r = philox4x32_10(ctr, k0, k1);
      float4 o;
      o.x = ste(v.x, sr_round(v.x, philox_uniform(r.x), s, step));
      o.y = ste(v.y, sr_round(v.y, philox_uniform(r.y), s, step));
      o.z = ste(v.z, sr_round(v.z, philox_uniform(r.z), s, step));
      o.w = ste(v.w, sr_round(v.w, philox_uniform(r.w), s, step));
      store4(out + i0, o);
    } else {
      const uint4 r = philox4x32_10(ctr, k0, k1);
      const uint32_t x[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (i0 + k < n) {
          const float wv = __ldg(w + i0 + k);
          store1(out + i0 + k, ste(wv, sr_round(wv, philox_uniform(x[k]), s, step)));
        }
      }
    }
  }
}

// Philox4x32-10 of given counters and keys (the known-answer check on the card).
__global__ void philox_kernel(const uint4* __restrict__ ctr, const uint2* __restrict__ key,
                              uint4* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = philox4x32_10(ctr[i], key[i].x, key[i].y);
}

}  // namespace

// out_dtype: DT_F32 | DT_BF16.  n_parts blocks run pass 1 (1 <= n_parts <=
// 1024).  Returns a cudaError_t (cudaErrorInvalidValue for another dtype).
extern "C" int repro_sr_quant_inline(const float* w, float* parts, int n_parts,
                                     const float* delta, unsigned k0, unsigned k1, void* out,
                                     int out_dtype, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (n_parts < 1 || n_parts > 1024 || (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  sr_absmax_kernel<<<n_parts, 512, 0, stream>>>(w, n, parts);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int threads = 256;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long need = ((n + 3) / 4 + threads - 1) / threads;
  const int grid = static_cast<int>(need < 8LL * sms ? need : 8LL * sms);
  if (out_dtype == DT_F32)
    sr_quant_inline_kernel<float><<<grid, threads, 0, stream>>>(
        w, parts, n_parts, delta, k0, k1, static_cast<float*>(out), n);
  else
    sr_quant_inline_kernel<__nv_bfloat16><<<grid, threads, 0, stream>>>(
        w, parts, n_parts, delta, k0, k1, static_cast<__nv_bfloat16*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// ctr (n, 4) and key (n, 2) uint32 -> out (n, 4) uint32.
extern "C" int repro_philox4x32(const void* ctr, const void* key, void* out, int n,
                                cudaStream_t stream) {
  if (n <= 0) return 0;
  philox_kernel<<<(n + 127) / 128, 128, 0, stream>>>(
      static_cast<const uint4*>(ctr), static_cast<const uint2*>(key), static_cast<uint4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2: stochastic rounding onto integer codes (the SR gradient wire).
//
// Replaces the Pallas kernel repro/kernels/sr_quant.py:sr_quant_pack_kernel
// (t = w/step; codes = clip(floor(t) + [u < t - floor(t)], -lim, lim) cast to
// int8; step <= 0 divides by 1).  The TPU kernel packs one (M, N) tensor at
// one step into int8; this one packs every (client, leaf) segment of a train
// step's replicated gradients in a single launch, into the code type the wire
// needs:
//
//   g (C, P) f32        each client's gradients, leaves concatenated
//   offsets (L+1,) i32  leaf l is columns offsets[l] : offsets[l+1]
//   step (L,) f32       per-leaf pitch (the clients' shared grid)
//   u (C, P) f32        uniforms, drawn outside the kernel
//   out (C, P)          int8 / int16 / int32 codes (templated)
//
// After the clip to [-lim, lim] the code saturates to its type's range, as
// XLA's float-to-int conversion does (reachable only where a caller asks for
// a type narrower than 2^bits - 1 needs, or at bits 31, whose lim rounds to
// 2^31 in f32).  IEEE round-to-nearest intrinsics throughout, so the codes
// are bit-equal to the plain version.
//
// Bound: bytes.  8 bytes read (g, u) and 1-4 written per element for ~6 FP32
// operations.  Same shape as K1: consecutive threads on consecutive elements
// (coalesced), blockIdx.y the client, a grid-stride loop over P, the leaf by
// binary search over the offsets.

// Float code -> CodeT, saturating as XLA's conversion does (a NaN gives 0).
template <typename CodeT> __device__ __forceinline__ CodeT saturate(float v);
template <> __device__ __forceinline__ int8_t saturate<int8_t>(float v) {
  return v != v ? 0 : static_cast<int8_t>(fminf(fmaxf(v, -128.0f), 127.0f));
}
template <> __device__ __forceinline__ int16_t saturate<int16_t>(float v) {
  return v != v ? 0 : static_cast<int16_t>(fminf(fmaxf(v, -32768.0f), 32767.0f));
}
template <> __device__ __forceinline__ int32_t saturate<int32_t>(float v) {
  // 2^31 - 1 is not a float: 2^31 and above saturate to INT32_MAX
  if (v != v) return 0;
  if (v >= 2147483648.0f) return 2147483647;
  return static_cast<int32_t>(fmaxf(v, -2147483648.0f));
}

template <typename CodeT>
__global__ void __launch_bounds__(256)
sr_pack_kernel(const float* __restrict__ g, const int* __restrict__ offsets,
               const float* __restrict__ step, const float* __restrict__ u,
               CodeT* __restrict__ out, int P, int L, float lim) {
  const int c = blockIdx.y;
  const float* gc = g + static_cast<int64_t>(c) * P;
  const float* uc = u + static_cast<int64_t>(c) * P;
  CodeT* oc = out + static_cast<int64_t>(c) * P;
  for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < P;
       p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    int lo = 0, hi = L;  // the leaf l with offsets[l] <= p < offsets[l+1]
    while (hi - lo > 1) {
      const int mid = (lo + hi) >> 1;
      if (__ldg(offsets + mid) <= p) lo = mid; else hi = mid;
    }
    const float st = __ldg(step + lo);
    const float safe = st > 0.0f ? st : 1.0f;
    const float t = __fdiv_rn(__ldg(gc + p), safe);
    const float lower = floorf(t);
    const float bern = (__ldg(uc + p) < __fsub_rn(t, lower)) ? 1.0f : 0.0f;
    float code = __fadd_rn(lower, bern);
    code = code < -lim ? -lim : code;      // jnp.clip (a NaN passes through)
    code = code > lim ? lim : code;
    oc[p] = saturate<CodeT>(code);
  }
}

template <typename CodeT>
int launch_sr_pack(const float* g, const int* offsets, const float* step, const float* u,
                   void* out, int P, int L, int C, float lim, cudaStream_t stream) {
  constexpr int threads = 256;
  int sms = 132;
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long want = (8LL * sms + C - 1) / C;
  const long long need = (P + threads - 1) / threads;
  const int gx = static_cast<int>(need < want ? need : (want > 0 ? want : 1));
  dim3 grid(gx, C);
  sr_pack_kernel<CodeT><<<grid, threads, 0, stream>>>(
      g, offsets, step, u, static_cast<CodeT*>(out), P, L, lim);
  return static_cast<int>(cudaGetLastError());
}

// code_dtype: DT_I8 | DT_I16 | DT_I32.  Returns a cudaError_t
// (cudaErrorInvalidValue for another dtype tag).
extern "C" int repro_sr_pack(const float* g, const int* offsets, const float* step,
                             const float* u, void* out, int code_dtype, int P, int L,
                             int C, float lim, cudaStream_t stream) {
  if (P <= 0 || C <= 0) return 0;
  switch (code_dtype) {
    case DT_I8:
      return launch_sr_pack<int8_t>(g, offsets, step, u, out, P, L, C, lim, stream);
    case DT_I16:
      return launch_sr_pack<int16_t>(g, offsets, step, u, out, P, L, C, lim, stream);
    case DT_I32:
      return launch_sr_pack<int32_t>(g, offsets, step, u, out, P, L, C, lim, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
