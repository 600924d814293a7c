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
// L = 1).  The entries that draw their uniforms in the kernel (the trainer's
// inline entry, the keyed segment entries) follow K2.

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
// Philox4x32-10 (Salmon et al., SC'11; Random123's philox4x32), the
// generator of every keyed entry below: ten rounds of two 32x32 -> 64-bit
// multiplies and key-dependent XORs on a 128-bit counter under a 64-bit key.
// A uniform is the top 24 bits of a word, (x >> 8) * 2^-24, exact in f32.

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

// Philox4x32-10 of given counters and keys (the known-answer check on the card).
__global__ void philox_kernel(const uint4* __restrict__ ctr, const uint2* __restrict__ key,
                              uint4* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = philox4x32_10(ctr[i], key[i].x, key[i].y);
}

}  // namespace

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

// One element's code: clip(floor(t) + [u < t - floor(t)], -lim, lim) with
// t = v / safe (jnp.clip: a NaN passes through), saturated to CodeT.
template <typename CodeT>
__device__ __forceinline__ CodeT pack_code(float v, float u, float safe, float lim) {
  const float t = __fdiv_rn(v, safe);
  const float lower = floorf(t);
  const float bern = (u < __fsub_rn(t, lower)) ? 1.0f : 0.0f;
  float code = __fadd_rn(lower, bern);
  code = code < -lim ? -lim : code;
  code = code > lim ? lim : code;
  return saturate<CodeT>(code);
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
    oc[p] = pack_code<CodeT>(__ldg(gc + p), __ldg(uc + p), st > 0.0f ? st : 1.0f, lim);
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

// ---------------------------------------------------------------------------
// The keyed entries: K1 for a trainer's weight use (the inline entry) and for
// an fl-sim round (the keyed segment entry), K2 for the trainer's SR gradient
// wire.  Each is one call of two kernels that leaves nothing to the host: the
// scales, the pitch and the uniforms are made on the device.
//
// All take a by-value table (SegTableT, a __grid_constant__ kernel argument,
// read from the constant bank): L leaves of a row, leaf l columns off[l] ..
// off[l+1] - 1, and a base pointer for every (row, leaf), so each leaf is
// read where it lies (K2's rows are the clients' gradients; K1 has one row,
// the round's weights) and nothing is stacked or concatenated.  Leaf l of a
// row owns blocks blk[l] .. blk[l+1] - 1 of each pass, sized by the host to
// the leaf's share of ~8 blocks an SM; a block finds its leaf by binary
// search over blk and runs a block-stride loop over that leaf alone.  The
// segment entries take SegTable (64 leaves, 256 pointers: ~2.6 KB); a tree
// past it goes through it in groups of consecutive leaves, one call of both
// passes a group (kernels/ops.py): a group's off[] are the tree's columns
// (off[0] > 0 after the first), so it draws the tree's Philox counters and
// writes its own columns of the tree's (C, P) output, P passed apart; a
// 4-group that straddles two groups' leaves is written by both calls, each
// its own elements, in stream order.  The
// inline entry, launched for every weight use (456 times a trainer step), is
// the keyed K1 at one leaf, one row and one client through OneSeg (32 bytes),
// so its launches carry no more parameters than before the merge.
//
// Pass 1 (seg_absmax_kernel) reads every (row, leaf) once and writes one
// exact partial a block: max|x| with NaN on top (as amax, for K1's
// tensor_scale), or for K2's guard the largest finite |x| and the count of
// non-finite x.  |x|'s bits compare as unsigned integers, so the partials,
// and the scale, do not depend on the grid; no float atomics, no memset.
//
// Pass 2 folds the partials of its leaf in every block (K1: s = max|w|, 1
// where that is not > 0, step = s * delta[c] with delta read on the device;
// K2: s over every client's partials, 1 where not > 0, step = s * fl32(1 /
// lim) by IEEE round-to-nearest, bit-equal to collectives.f32_reciprocal's
// product, written out for the dequant, and the client's own finite max for
// the guard).  It draws element (c, p)'s uniform u = (x >> 8) * 2^-24 with x
// word p % 4 of Philox4x32-10 at counter (p / 4, p / 4 >> 32, c, 0) under
// the call's 64-bit key, p the column of the tree's leaves concatenated: the inline
// entry draws stream c = 0 of its one leaf.  K2 applies the guard in
// registers (NaN -> 0, +-Inf -> +- the client's finite max in the leaf; a
// no-op on finite gradients) and writes codes saturated to the wire's type;
// K1 rounds as the segment entry does and writes the straight-through value
// w + (q - w) in f32, or in bf16 for the inline entry's compute dtype.  The
// first block of K2 also sums the non-finite count, the one number the host
// reads in "raise" mode.
//
// Split at the pass boundary (the trainer with one client a rank, where the
// shared scale is a max across processes): repro_sr_pack_keyed_scales runs
// pass 1 and folds each (row, leaf)'s partials into that row's largest
// finite |g| (fmax, C x L) and the rows' non-finite count; the caller
// all-reduces the count (sum) and fmax's row (max) into smax; then
// repro_sr_pack_keyed_scaled runs pass 2 from smax and fmax in device memory,
// row c drawing Philox stream c0 + c.  Rank r passes c0 = r, so its codes are
// row r of the one-call entry's, bit for bit: the same partials, the same
// unsigned max (a float max of finite non-negative values), the same pitch
// and uniforms.  Both passes share their bodies with the one-call entry.
//
// Bound: bytes, each input counted once and each output once: K2 4 B of g
// and 1-4 B of codes an element, K1 4 B of w and 4 B (2 B in bf16) out a
// client (pass 1's read is the price of a scale known before the rounding
// starts).  Pass 2 also issues ~48 instructions an element, Philox's 80
// integer instructions per 4-group (10 rounds of two multiply-highs, two
// multiply-lows, two three-way XORs, two key adds) on the INT32 lanes among
// them, an IEEE division and the clip on the FP32 pipes, so it runs near its
// issue rate as much as its bytes.  A thread takes one 4-group: one Philox
// call, a 16-byte load and a 4-16-byte store where the group lies inside the
// leaf and the addresses are aligned; scalar accesses at ragged leaf edges,
// where a 4-group may straddle two leaves (each leaf's blocks write their own
// elements of it).

constexpr int SEG_MAX_LEAVES = 64;
constexpr int SEG_MAX_PTRS = 256;
constexpr int SEG_THREADS = 256;

template <int kLeaves, int kPtrs>
struct SegTableT {
  int L;                      // leaves a row
  int nb;                     // blocks a row (blk[L])
  int off[kLeaves + 1];       // leaf l is columns off[l] .. off[l+1] - 1
  int blk[kLeaves + 1];       // leaf l owns blocks blk[l] .. blk[l+1] - 1
  const float* base[kPtrs];   // row r's leaf l starts at base[r * L + l]
};
using SegTable = SegTableT<SEG_MAX_LEAVES, SEG_MAX_PTRS>;
using OneSeg = SegTableT<1, 1>;

namespace {

__device__ __forceinline__ uint32_t abs_bits(float v) { return __float_as_uint(v) & 0x7fffffffu; }

template <class T>
__device__ __forceinline__ int seg_leaf(const T& t, int bx) {
  int lo = 0, hi = t.L;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (t.blk[mid] <= bx) lo = mid; else hi = mid;
  }
  return lo;
}

// Two block-wide reductions at once, returned to every thread: (max, sum)
// when kSum, else (max, max).  Blocks of SEG_THREADS threads.
template <bool kSum>
__device__ __forceinline__ uint2 block_reduce2(uint2 v) {
  __shared__ uint2 warp_v[SEG_THREADS / 32];
  v.x = __reduce_max_sync(0xffffffffu, v.x);
  v.y = kSum ? __reduce_add_sync(0xffffffffu, v.y) : __reduce_max_sync(0xffffffffu, v.y);
  if ((threadIdx.x & 31) == 0) warp_v[threadIdx.x >> 5] = v;
  __syncthreads();
  uint2 r = make_uint2(0u, 0u);
#pragma unroll
  for (int i = 0; i < SEG_THREADS / 32; ++i) {
    r.x = max(r.x, warp_v[i].x);
    r.y = kSum ? r.y + warp_v[i].y : max(r.y, warp_v[i].y);
  }
  __syncthreads();  // warp_v is free for the next call
  return r;
}

// kFinite: (largest finite |x|, non-finite count); else (max |x|, NaN on top).
template <bool kFinite>
__device__ __forceinline__ void absmax_take(uint2& acc, float v) {
  const uint32_t b = abs_bits(v);
  if (kFinite) {
    const bool fin = b < 0x7f800000u;
    acc.x = fin ? max(acc.x, b) : acc.x;
    acc.y += fin ? 0u : 1u;
  } else {
    acc.x = max(acc.x, b);
  }
}

template <bool kFinite>
__device__ __forceinline__ void absmax_take4(uint2& acc, float4 v) {
  absmax_take<kFinite>(acc, v.x);
  absmax_take<kFinite>(acc, v.y);
  absmax_take<kFinite>(acc, v.z);
  absmax_take<kFinite>(acc, v.w);
}

template <bool kFinite, class T>
__global__ void __launch_bounds__(SEG_THREADS)
seg_absmax_kernel(const __grid_constant__ T t, uint2* __restrict__ parts) {
  const int r = blockIdx.y;
  const int l = seg_leaf(t, blockIdx.x);
  const float* x = t.base[r * t.L + l];
  const int64_t n = t.off[l + 1] - t.off[l];
  const int64_t stride = static_cast<int64_t>(t.blk[l + 1] - t.blk[l]) * SEG_THREADS;
  const int64_t tid = static_cast<int64_t>(blockIdx.x - t.blk[l]) * SEG_THREADS + threadIdx.x;
  uint2 acc = make_uint2(0u, 0u);
  int64_t body = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const int64_t n4 = n >> 2;
    int64_t i = tid;
    for (; i + 3 * stride < n4; i += 4 * stride) {  // four 16-byte loads in flight
      float4 v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) v[k] = __ldg(x4 + i + k * stride);
#pragma unroll
      for (int k = 0; k < 4; ++k) absmax_take4<kFinite>(acc, v[k]);
    }
    for (; i < n4; i += stride) absmax_take4<kFinite>(acc, __ldg(x4 + i));
    body = n4 << 2;
  }
  for (int64_t i = body + tid; i < n; i += stride) absmax_take<kFinite>(acc, __ldg(x + i));
  acc = block_reduce2<true>(acc);
  if (threadIdx.x == 0) parts[static_cast<int64_t>(r) * t.nb + blockIdx.x] = acc;
}

// Group g's four words for client c (P < 2^31, so the counter's second
// word, g >> 32, is 0).
__device__ __forceinline__ uint4 group_bits(int g, int c, uint32_t k0, uint32_t k1) {
  return philox4x32_10(make_uint4(static_cast<uint32_t>(g), 0u, static_cast<uint32_t>(c), 0u),
                       k0, k1);
}

// Whether the groups wholly inside a leaf that starts at column a may take
// 16-byte loads of x and 4-element stores to the output row o: column p0 (a
// multiple of 4) lies at x + (p0 - a), so both hold for every such group
// when they hold for the leaf's start.  Evaluated once a block.
__device__ __forceinline__ bool groups_aligned(const float* x, int a, const void* o,
                                               int out_bytes) {
  return ((reinterpret_cast<uintptr_t>(x) - 4u * static_cast<uint32_t>(a)) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(o) & (4 * out_bytes - 1)) == 0;
}

__device__ __forceinline__ void store1(float* o, float v) { *o = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store4(float* o, float4 v) { *reinterpret_cast<float4*>(o) = v; }
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const uint32_t*>(&a),
                                            *reinterpret_cast<const uint32_t*>(&b));
}

// K1's pass 2: out (C, P) in Out (f32, or bf16 for the inline entry).
template <class Out, class T>
__global__ void __launch_bounds__(SEG_THREADS)
sr_quant_keyed_kernel(const __grid_constant__ T t, const uint2* __restrict__ parts,
                      const float* __restrict__ d, uint32_t k0, uint32_t k1,
                      Out* __restrict__ out, int P) {
  const int c = blockIdx.y;
  const int l = seg_leaf(t, blockIdx.x);
  const int b0 = t.blk[l], nbl = t.blk[l + 1] - b0;
  uint2 m = make_uint2(0u, 0u);
#pragma unroll 4
  for (int i = threadIdx.x; i < nbl; i += SEG_THREADS) m.x = max(m.x, __ldg(&parts[b0 + i].x));
  m = block_reduce2<false>(m);
  const float smax = __uint_as_float(m.x);
  const float s = smax > 0.0f ? smax : 1.0f;  // a NaN max gives 1, as tensor_scale
  const float step = __fmul_rn(s, __ldg(d + c));
  const int a = t.off[l], b = t.off[l + 1];
  const float* x = t.base[l];
  Out* oc = out + static_cast<int64_t>(c) * P;
  const bool vec = groups_aligned(x, a, oc, sizeof(Out));
  const int g_end = (b >> 2) + ((b & 3) != 0);
  for (int g = (a >> 2) + (blockIdx.x - b0) * SEG_THREADS + threadIdx.x; g < g_end;
       g += nbl * SEG_THREADS) {
    const int p0 = g << 2;
    const uint4 r = group_bits(g, c, k0, k1);
    if (vec && p0 >= a && p0 <= b - 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + (p0 - a)));
      float4 o;
      o.x = ste(v.x, sr_round(v.x, philox_uniform(r.x), s, step));
      o.y = ste(v.y, sr_round(v.y, philox_uniform(r.y), s, step));
      o.z = ste(v.z, sr_round(v.z, philox_uniform(r.z), s, step));
      o.w = ste(v.w, sr_round(v.w, philox_uniform(r.w), s, step));
      store4(oc + p0, o);
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + k;
        if (p >= a && p < b) {
          const float wv = __ldg(x + (p - a));
          store1(oc + p, ste(wv, sr_round(wv, philox_uniform(w[k]), s, step)));
        }
      }
    }
  }
}

// The wire's guard (collectives._nonfinite_guard, "saturate"): NaN -> 0,
// +-Inf -> +-fmax, the client's largest finite |g| in the leaf; finite
// values pass unchanged.
__device__ __forceinline__ float wire_guard(float v, float fmax) {
  if (v != v) return 0.0f;
  return isinf(v) ? copysignf(fmax, v) : v;
}

__device__ __forceinline__ void store_codes4(int8_t* o, const int8_t (&q)[4]) {
  *reinterpret_cast<char4*>(o) = make_char4(q[0], q[1], q[2], q[3]);
}
__device__ __forceinline__ void store_codes4(int16_t* o, const int16_t (&q)[4]) {
  *reinterpret_cast<short4*>(o) = make_short4(q[0], q[1], q[2], q[3]);
}
__device__ __forceinline__ void store_codes4(int32_t* o, const int32_t (&q)[4]) {
  *reinterpret_cast<int4*>(o) = make_int4(q[0], q[1], q[2], q[3]);
}

// The non-finite count over every partial, to thread 0 (64-bit: the
// partials' own counts are 32-bit).
__device__ __forceinline__ unsigned long long block_count(const uint2* __restrict__ parts,
                                                          int n) {
  __shared__ unsigned long long warp_n[SEG_THREADS / 32];
  unsigned long long v = 0;
  for (int i = threadIdx.x; i < n; i += SEG_THREADS) v += __ldg(&parts[i].y);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) warp_n[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
#pragma unroll
  for (int i = 0; i < SEG_THREADS / 32; ++i) v += warp_n[i];
  return v;
}

// The wire's pitch from the shared scale smax (1 where it is not > 0).
__device__ __forceinline__ float wire_step(float smax, float lim) {
  const float s = smax > 0.0f ? smax : 1.0f;
  return __fmul_rn(s, __frcp_rn(lim));
}

// One row's codes of leaf l (its blocks b0 .. b0 + nbl - 1): x guarded at
// fmax, rounded at `step` onto codes from Philox stream `stream`, to oc.
template <typename CodeT>
__device__ __forceinline__ void pack_leaf_row(const SegTable& t, int l, int b0, int nbl,
                                              const float* x, float step, float fmax,
                                              float lim, int stream, uint32_t k0, uint32_t k1,
                                              CodeT* __restrict__ oc) {
  const float safe = step > 0.0f ? step : 1.0f;
  const int a = t.off[l], b = t.off[l + 1];
  const bool vec = groups_aligned(x, a, oc, sizeof(CodeT));
  const int g_end = (b >> 2) + ((b & 3) != 0);
  for (int g = (a >> 2) + (blockIdx.x - b0) * SEG_THREADS + threadIdx.x; g < g_end;
       g += nbl * SEG_THREADS) {
    const int p0 = g << 2;
    const uint4 r = group_bits(g, stream, k0, k1);
    if (vec && p0 >= a && p0 <= b - 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(x + (p0 - a)));
      const CodeT q[4] = {
          pack_code<CodeT>(wire_guard(v.x, fmax), philox_uniform(r.x), safe, lim),
          pack_code<CodeT>(wire_guard(v.y, fmax), philox_uniform(r.y), safe, lim),
          pack_code<CodeT>(wire_guard(v.z, fmax), philox_uniform(r.z), safe, lim),
          pack_code<CodeT>(wire_guard(v.w, fmax), philox_uniform(r.w), safe, lim)};
      store_codes4(oc + p0, q);
    } else {
      const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int p = p0 + k;
        if (p >= a && p < b)
          oc[p] = pack_code<CodeT>(wire_guard(__ldg(x + (p - a)), fmax),
                                   philox_uniform(w[k]), safe, lim);
      }
    }
  }
}

template <typename CodeT>
__global__ void __launch_bounds__(SEG_THREADS)
sr_pack_keyed_kernel(const __grid_constant__ SegTable t, const uint2* __restrict__ parts,
                     int C, float lim, uint32_t k0, uint32_t k1, CodeT* __restrict__ out,
                     float* __restrict__ steps, unsigned long long* __restrict__ bad, int P) {
  const int c = blockIdx.y;
  const int l = seg_leaf(t, blockIdx.x);
  const int b0 = t.blk[l], nbl = t.blk[l + 1] - b0;
  uint2 m = make_uint2(0u, 0u);  // (max over the clients, this client's own)
#pragma unroll 4
  for (int i = threadIdx.x; i < C * nbl; i += SEG_THREADS) {
    const int r = i / nbl;
    const uint32_t v = __ldg(&parts[static_cast<int64_t>(r) * t.nb + b0 + (i - r * nbl)].x);
    m.x = max(m.x, v);
    m.y = r == c ? max(m.y, v) : m.y;
  }
  m = block_reduce2<false>(m);
  const float step = wire_step(__uint_as_float(m.x), lim);
  if (c == 0 && static_cast<int>(blockIdx.x) == b0 && threadIdx.x == 0) steps[l] = step;
  if (c == 0 && blockIdx.x == 0) {
    const unsigned long long n = block_count(parts, C * t.nb);
    if (threadIdx.x == 0) *bad = n;
  }
  pack_leaf_row<CodeT>(t, l, b0, nbl, t.base[c * t.L + l], step, __uint_as_float(m.y), lim, c,
                       k0, k1, out + static_cast<int64_t>(c) * P);
}

// The split wire's pass 1 fold: row r's largest finite |g| of leaf l,
// fmax[r * L + l], from its blocks' partials; block (0, 0) also writes the
// rows' non-finite count.
__global__ void __launch_bounds__(SEG_THREADS)
seg_fold_kernel(const __grid_constant__ SegTable t, const uint2* __restrict__ parts, int rows,
                float* __restrict__ fmax, unsigned long long* __restrict__ bad) {
  const int l = blockIdx.x, r = blockIdx.y;
  const int b0 = t.blk[l], nbl = t.blk[l + 1] - b0;
  uint2 m = make_uint2(0u, 0u);
  for (int i = threadIdx.x; i < nbl; i += SEG_THREADS)
    m.x = max(m.x, __ldg(&parts[static_cast<int64_t>(r) * t.nb + b0 + i].x));
  m = block_reduce2<false>(m);
  if (threadIdx.x == 0) fmax[r * t.L + l] = __uint_as_float(m.x);
  if (l == 0 && r == 0) {
    const unsigned long long n = block_count(parts, rows * t.nb);
    if (threadIdx.x == 0) *bad = n;
  }
}

// The split wire's pass 2: the pitch from the shared scale smax[l] (made
// across ranks), row c guarded at its own fmax[c * L + l] and drawing Philox
// stream c0 + c.
template <typename CodeT>
__global__ void __launch_bounds__(SEG_THREADS)
sr_pack_scaled_kernel(const __grid_constant__ SegTable t, const float* __restrict__ smax,
                      const float* __restrict__ fmax, int c0, float lim, uint32_t k0,
                      uint32_t k1, CodeT* __restrict__ out, float* __restrict__ steps, int P) {
  const int c = blockIdx.y;
  const int l = seg_leaf(t, blockIdx.x);
  const int b0 = t.blk[l], nbl = t.blk[l + 1] - b0;
  const float step = wire_step(__ldg(smax + l), lim);
  if (c == 0 && static_cast<int>(blockIdx.x) == b0 && threadIdx.x == 0) steps[l] = step;
  pack_leaf_row<CodeT>(t, l, b0, nbl, t.base[c * t.L + l], step, __ldg(fmax + c * t.L + l),
                       lim, c0 + c, k0, k1, out + static_cast<int64_t>(c) * P);
}

// The table from the host's arrays: off and blk (L + 1 each, blk[0] = 0 and
// every leaf at least one block; off[0] the group's first column, off[L] at
// most P, the output's columns) and rows * L base pointers.
int fill_seg_table(SegTable& t, const int* off, const int* blk, const void* const* base,
                   int L, int rows, int P) {
  if (L < 1 || L > SEG_MAX_LEAVES || rows < 1 || rows * L > SEG_MAX_PTRS || blk[0] != 0 ||
      off[0] < 0 || off[L] > P)
    return static_cast<int>(cudaErrorInvalidValue);
  t.L = L;
  t.nb = blk[L];
  for (int l = 0; l <= L; ++l) {
    t.off[l] = off[l];
    t.blk[l] = blk[l];
    if (l > 0 && (blk[l] <= blk[l - 1] || off[l] < off[l - 1]))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int i = 0; i < rows * L; ++i) t.base[i] = static_cast<const float*>(base[i]);
  return 0;
}

// K1's two passes over one row of leaves, C clients out.
template <class Out, class T>
int launch_sr_quant_keyed(const T& t, uint2* parts, const float* d, int C, uint32_t k0,
                          uint32_t k1, void* out, int P, cudaStream_t stream) {
  seg_absmax_kernel<false><<<dim3(t.nb, 1), SEG_THREADS, 0, stream>>>(t, parts);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  sr_quant_keyed_kernel<Out><<<dim3(t.nb, C), SEG_THREADS, 0, stream>>>(
      t, parts, d, k0, k1, static_cast<Out*>(out), P);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT>
int launch_sr_pack_keyed(const SegTable& t, const uint2* parts, int C, float lim, uint32_t k0,
                         uint32_t k1, void* out, int P, float* steps, unsigned long long* bad,
                         cudaStream_t stream) {
  sr_pack_keyed_kernel<CodeT><<<dim3(t.nb, C), SEG_THREADS, 0, stream>>>(
      t, parts, C, lim, k0, k1, static_cast<CodeT*>(out), steps, bad, P);
  return static_cast<int>(cudaGetLastError());
}

template <typename CodeT>
int launch_sr_pack_scaled(const SegTable& t, const float* smax, const float* fmax, int C, int c0,
                          float lim, uint32_t k0, uint32_t k1, void* out, int P, float* steps,
                          cudaStream_t stream) {
  sr_pack_scaled_kernel<CodeT><<<dim3(t.nb, C), SEG_THREADS, 0, stream>>>(
      t, smax, fmax, c0, lim, k0, k1, static_cast<CodeT*>(out), steps, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 inline: one weight use w (n,) f32 -> out (n,) in out_dtype (DT_F32 |
// DT_BF16), delta (1,) on the device; nb blocks a pass (1 <= nb, parts holds
// nb uint2 partials).  Returns a cudaError_t (cudaErrorInvalidValue for
// another dtype).
extern "C" int repro_sr_quant_inline(const float* w, int n, int nb, void* parts,
                                     const float* delta, unsigned k0, unsigned k1, void* out,
                                     int out_dtype, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (nb < 1 || (out_dtype != DT_F32 && out_dtype != DT_BF16))
    return static_cast<int>(cudaErrorInvalidValue);
  OneSeg t;
  t.L = 1;
  t.nb = nb;
  t.off[0] = 0;
  t.off[1] = n;
  t.blk[0] = 0;
  t.blk[1] = nb;
  t.base[0] = w;
  uint2* p = static_cast<uint2*>(parts);
  return out_dtype == DT_F32
             ? launch_sr_quant_keyed<float>(t, p, delta, 1, k0, k1, out, n, stream)
             : launch_sr_quant_keyed<__nv_bfloat16>(t, p, delta, 1, k0, k1, out, n, stream);
}

// K1 keyed: L leaves (one row) -> columns off[0] .. off[L] - 1 of out (C,
// P) f32; parts holds blk[L] uint2 partials.  Returns a cudaError_t
// (cudaErrorInvalidValue for a table past its size).
extern "C" int repro_sr_quant_keyed(const int* off, const int* blk, const void* const* base,
                                    int L, void* parts, const float* d, int C, unsigned k0,
                                    unsigned k1, float* out, int P, cudaStream_t stream) {
  SegTable t;
  const int err = fill_seg_table(t, off, blk, base, L, 1, P);
  if (err != 0) return err;
  if (C < 1 || C > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return launch_sr_quant_keyed<float>(t, static_cast<uint2*>(parts), d, C, k0, k1, out, P,
                                      stream);
}

// K2 keyed: L leaves of C clients (base[c * L + l]) -> columns off[0] ..
// off[L] - 1 of codes (C, P) of code_dtype, steps (L,) f32 (the group's
// leaves), bad (1,) the group's non-finite count; parts holds C * blk[L]
// uint2 partials.
extern "C" int repro_sr_pack_keyed(const int* off, const int* blk, const void* const* base,
                                   int L, int C, void* parts, unsigned k0, unsigned k1,
                                   float lim, void* out, int P, int code_dtype, float* steps,
                                   unsigned long long* bad, cudaStream_t stream) {
  SegTable t;
  const int err = fill_seg_table(t, off, blk, base, L, C, P);
  if (err != 0) return err;
  if (code_dtype != DT_I8 && code_dtype != DT_I16 && code_dtype != DT_I32)
    return static_cast<int>(cudaErrorInvalidValue);
  uint2* p = static_cast<uint2*>(parts);
  seg_absmax_kernel<true><<<dim3(t.nb, C), SEG_THREADS, 0, stream>>>(t, p);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  switch (code_dtype) {
    case DT_I8:
      return launch_sr_pack_keyed<int8_t>(t, p, C, lim, k0, k1, out, P, steps, bad, stream);
    case DT_I16:
      return launch_sr_pack_keyed<int16_t>(t, p, C, lim, k0, k1, out, P, steps, bad, stream);
    default:
      return launch_sr_pack_keyed<int32_t>(t, p, C, lim, k0, k1, out, P, steps, bad, stream);
  }
}

// K2 keyed, split at its pass boundary for a wire whose rows lie on several
// ranks.  Pass 1: L leaves of C rows (base[c * L + l]) -> fmax (C, L) f32,
// each row's largest finite |g| a leaf, and bad (1,) the rows' non-finite
// count; parts holds C * blk[L] uint2 partials.  Columns as in
// repro_sr_pack_keyed.
extern "C" int repro_sr_pack_keyed_scales(const int* off, const int* blk,
                                          const void* const* base, int L, int C, void* parts,
                                          float* fmax, unsigned long long* bad,
                                          cudaStream_t stream) {
  SegTable t;
  const int err = fill_seg_table(t, off, blk, base, L, C, off[L]);
  if (err != 0) return err;
  uint2* p = static_cast<uint2*>(parts);
  seg_absmax_kernel<true><<<dim3(t.nb, C), SEG_THREADS, 0, stream>>>(t, p);
  const cudaError_t e1 = cudaGetLastError();
  if (e1 != cudaSuccess) return static_cast<int>(e1);
  seg_fold_kernel<<<dim3(L, C), SEG_THREADS, 0, stream>>>(t, p, C, fmax, bad);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2: smax (L,) the shared scales, fmax (C, L) the rows' own, on the
// device; row c draws Philox stream c0 + c.  -> columns off[0] .. off[L] - 1
// of codes (C, P) of code_dtype, steps (L,) f32.
extern "C" int repro_sr_pack_keyed_scaled(const int* off, const int* blk,
                                          const void* const* base, int L, int C,
                                          const float* smax, const float* fmax, int c0,
                                          unsigned k0, unsigned k1, float lim, void* out, int P,
                                          int code_dtype, float* steps, cudaStream_t stream) {
  SegTable t;
  const int err = fill_seg_table(t, off, blk, base, L, C, P);
  if (err != 0) return err;
  if (c0 < 0 || code_dtype < DT_I8 || code_dtype > DT_I32)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (code_dtype) {
    case DT_I8:
      return launch_sr_pack_scaled<int8_t>(t, smax, fmax, C, c0, lim, k0, k1, out, P, steps,
                                           stream);
    case DT_I16:
      return launch_sr_pack_scaled<int16_t>(t, smax, fmax, C, c0, lim, k0, k1, out, P, steps,
                                            stream);
    default:
      return launch_sr_pack_scaled<int32_t>(t, smax, fmax, C, c0, lim, k0, k1, out, P, steps,
                                            stream);
  }
}
