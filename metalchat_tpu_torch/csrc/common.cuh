// Shared helpers for the port's CUDA kernels (sm_90a, plain C interface).
//
// Built without --use_fast_math: '/' is IEEE division, sqrtf is correctly
// rounded and rintf rounds half to even, which the kernels need to produce
// the same int8 codes as the reference (torch.round / jnp.round are
// half-to-even too).
#pragma once

#include <cmath>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// -0.7 * FLT_MAX: an additive mask value that never yields NaN through exp.
#define MC_MASK_VALUE (-0.7f * 3.4028234663852886e+38f)

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round through T and back (the activation-dtype rounding of the reference).
template <typename T> __device__ __forceinline__ float round_through(float v) {
  return to_f32<T>(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions over blockDim.x threads (a multiple of 32, at most
// 1024). `scratch` holds one slot per warp; every thread gets the result.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = 0.f;
  for (int w = 0; w < nwarps; ++w) r += scratch[w];
  return r;
}

__device__ __forceinline__ float block_max(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = scratch[0];
  for (int w = 1; w < nwarps; ++w) r = fmaxf(r, scratch[w]);
  return r;
}

__device__ __forceinline__ int block_sum_int(int v, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  v = warp_sum_int(v);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int r = 0;
  for (int w = 0; w < nwarps; ++w) r += scratch[w];
  return r;
}

// Symmetric int8 code of v / s (clip to +-127, round half to even).
__device__ __forceinline__ int8_t quant_code(float q) {
  return (int8_t)fminf(fmaxf(rintf(q), -127.f), 127.f);
}

// Quantize one head's new K or V row (hd values) with the op order of
// cache.quantize_kv: scale = absmax/127, inv = 1/scale (0 when scale is 0),
// code = clip(round(x * inv)). Writes the codes to dst and the scale to
// *dst_scale. Every thread of the block calls it (block_max syncs).
template <typename T>
__device__ void quantize_into(const T* __restrict__ x, int hd, int8_t* dst,
                              float* dst_scale, float* scratch) {
  float amax = 0.f;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) amax = fmaxf(amax, fabsf(to_f32<T>(x[d])));
  amax = block_max(amax, scratch);
  const float scale = amax / 127.f;
  const float inv = scale == 0.f ? 0.f : 1.f / scale;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) dst[d] = quant_code(to_f32<T>(x[d]) * inv);
  if (threadIdx.x == 0) *dst_scale = scale;
}
