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

// A load of T from global memory; COHERENT reads through L2 (`ld.global.cg`),
// for data that other blocks of the same launch wrote (ffn_block's scratch).
template <typename T, bool COHERENT>
__device__ __forceinline__ float load_f32(const T* p) {
  if constexpr (COHERENT) return to_f32<T>(__ldcg(p));
  return to_f32<T>(*p);
}

// Prologue of the int8-activation matvecs: one activation row of in_f values
// into shared memory as int8 codes, with the op order of the reference
// `_act_quantize` (and, with NORM, of ops.rms_norm -> round to the activation
// dtype -> _act_quantize). Every thread of the block calls it.
template <typename T, bool NORM, bool COHERENT = false>
__device__ void quantize_row(const T* x, const T* __restrict__ nw, int in_f, float eps,
                             float offset, int8_t* xq_row, float* sx_out, float* scratch) {
  float r = 0.f;
  if (NORM) {
    float ss = 0.f;
    for (int i = threadIdx.x; i < in_f; i += blockDim.x) {
      const float v = load_f32<T, COHERENT>(x + i);
      ss += v * v;
    }
    const float var = block_sum(ss, scratch) / (float)in_f;
    r = 1.0f / sqrtf(var + eps);
  }
  auto value = [&](int i) -> float {
    const float v = load_f32<T, COHERENT>(x + i);
    if (!NORM) return v;
    return round_through<T>((v * r) * (offset + to_f32<T>(nw[i])));
  };
  float amax = 0.f;
  for (int i = threadIdx.x; i < in_f; i += blockDim.x) amax = fmaxf(amax, fabsf(value(i)));
  amax = block_max(amax, scratch);
  const float sx = amax == 0.f ? 1.f : amax / 127.f;
  for (int i = threadIdx.x; i < in_f; i += blockDim.x) xq_row[i] = quant_code(value(i) / sx);
  if (threadIdx.x == 0) *sx_out = sx;
}

// The int4 correction 8 * sum(x_lo) of one row of codes (see warp_row_dot).
__device__ __forceinline__ void int4_correction(const int8_t* xq_row, int in_f, int* corr,
                                                int* iscratch) {
  int part = 0;
  for (int i = threadIdx.x; i < in_f / 2; i += blockDim.x) part += xq_row[i];
  const int total = block_sum_int(part, iscratch);
  if (threadIdx.x == 0) *corr = 8 * total;
}

// Integer dot products of one weight row (k = in_f/2 packed int4 bytes,
// half-split with an offset-binary low nibble, or in_f int8 bytes) with B
// rows of int8 codes xq [B][in_f] in shared memory; one warp, 16-byte loads,
// neighbouring lanes on neighbouring addresses. The int4 nibbles are never
// unpacked: dp4a on (p & 0x0F0F0F0F) gives sum x_lo*(lo+8) and on
// (p & 0xF0F0F0F0) 16*sum x_hi*hi, both exact; corr[b] = 8*sum(x_lo) and an
// arithmetic >> 4 finish them (the TPU kernel's identities). Integer sums
// are order-free, so the totals are exact. epilogue(b, total) runs on every
// lane for each row b < B, as soon as its total is reduced.
template <int MAXB, int BITS, typename Epilogue>
__device__ __forceinline__ void warp_row_dot(const int8_t* __restrict__ wrow,
                                             const int8_t* xq, int in_f, int B,
                                             const int* corr, Epilogue&& epilogue) {
  const int lane = threadIdx.x & 31;
  const int half = in_f / 2;
  const int k = BITS == 4 ? half : in_f;
  int acc_lo[MAXB], acc_hi[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc_lo[b] = acc_hi[b] = 0;

#pragma unroll 4
  for (int c = lane * 16; c < k; c += 32 * 16) {
    const int4 w = *reinterpret_cast<const int4*>(wrow + c);
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b >= B) break;
      const int8_t* xrow = xq + (size_t)b * in_f;
      if (BITS == 4) {
        const int4 xl = *reinterpret_cast<const int4*>(xrow + c);
        const int4 xh = *reinterpret_cast<const int4*>(xrow + half + c);
        const int ml = 0x0F0F0F0F, mh = (int)0xF0F0F0F0u;
        acc_lo[b] = __dp4a(w.x & ml, xl.x, acc_lo[b]);
        acc_lo[b] = __dp4a(w.y & ml, xl.y, acc_lo[b]);
        acc_lo[b] = __dp4a(w.z & ml, xl.z, acc_lo[b]);
        acc_lo[b] = __dp4a(w.w & ml, xl.w, acc_lo[b]);
        acc_hi[b] = __dp4a(w.x & mh, xh.x, acc_hi[b]);
        acc_hi[b] = __dp4a(w.y & mh, xh.y, acc_hi[b]);
        acc_hi[b] = __dp4a(w.z & mh, xh.z, acc_hi[b]);
        acc_hi[b] = __dp4a(w.w & mh, xh.w, acc_hi[b]);
      } else {
        const int4 xv = *reinterpret_cast<const int4*>(xrow + c);
        acc_lo[b] = __dp4a(w.x, xv.x, acc_lo[b]);
        acc_lo[b] = __dp4a(w.y, xv.y, acc_lo[b]);
        acc_lo[b] = __dp4a(w.z, xv.z, acc_lo[b]);
        acc_lo[b] = __dp4a(w.w, xv.w, acc_lo[b]);
      }
    }
  }

#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b >= B) break;
    int t = warp_sum_int(acc_lo[b]);
    if (BITS == 4) t = (t - corr[b]) + (warp_sum_int(acc_hi[b]) >> 4);
    epilogue(b, t);
  }
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
