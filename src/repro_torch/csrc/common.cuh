// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element-type tags the ctypes launchers receive (kept in sync with
// repro_torch/kernels/_build.py: DTYPE_CODES).
enum DType : int { DT_F32 = 0, DT_BF16 = 1, DT_I8 = 2, DT_I16 = 3, DT_I32 = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }

// Finite "minus infinity" of the reference kernels (flash_attention.py
// _NEG_INF): an empty softmax row reports m = -1e30, l = 0.
constexpr float NEG_INF = -1e30f;
