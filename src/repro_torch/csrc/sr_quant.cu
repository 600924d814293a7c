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
// L = 1).

#include "common.cuh"

namespace {

__global__ void __launch_bounds__(256)
sr_quant_kernel(const float* __restrict__ w, const int* __restrict__ offsets,
                const float* __restrict__ s, const float* __restrict__ d,
                const float* __restrict__ u, float* __restrict__ out, int P, int L,
                int ste) {
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
    const float step = __fmul_rn(sl, dc);
    float q = wv;
    if (step > 0.0f) {
      const float t = __fdiv_rn(wv, step);
      const float lower = floorf(t);
      const float bern = (__ldg(uc + p) < __fsub_rn(t, lower)) ? 1.0f : 0.0f;
      q = __fmul_rn(__fadd_rn(lower, bern), step);
      // clip as jnp.clip does (a NaN passes through)
      q = q < -sl ? -sl : q;
      q = q > sl ? sl : q;
    }
    oc[p] = ste ? __fadd_rn(wv, __fsub_rn(q, wv)) : q;
  }
}

}  // namespace

extern "C" int repro_sr_quant(const float* w, const int* offsets, const float* s,
                              const float* d, const float* u, float* out, int P, int L,
                              int C, int ste, cudaStream_t stream) {
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
  sr_quant_kernel<<<grid, threads, 0, stream>>>(w, offsets, s, d, u, out, P, L, ste);
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
