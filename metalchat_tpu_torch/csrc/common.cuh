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

// Signed byte i of w as f32, exactly, without the int-to-float unit (a
// quarter of the FMA rate on Hopper): with the sign bit flipped the byte is
// b + 128, placed in the low mantissa of 2^23 by a byte permute, and one
// subtraction leaves b.
__device__ __forceinline__ float s8_at(uint32_t w_biased, int i) {
  return __int_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// NACC int8 codes to global or shared memory in one access.
__device__ __forceinline__ void store_codes(void* p, const int8_t (&c)[2]) {
  *reinterpret_cast<char2*>(p) = make_char2(c[0], c[1]);
}
__device__ __forceinline__ void store_codes(void* p, const int8_t (&c)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(c[0], c[1], c[2], c[3]);
}

// -- Decode attention split over cache positions (flash-decoding) -----------
//
// The positions [lo, length) of one (batch row, kv head) are cut into chunks
// of `chunk` positions; chunk s covers [s * chunk, (s + 1) * chunk). One
// block per chunk computes f32 partials (m, l, acc[hd]) for each query head
// of the group; the last block of the (row, kv head) to arrive merges them.
// Workspace of one launch (rows = B * nh query heads, n_split chunks each):
// acc [rows][n_split][hd] f32, then (m, l) [rows][n_split][2] f32.

// The chunks that hold a position of [lo, length) (at least the one of
// length - 1, which holds the new token).
struct SplitSpan {
  int lo, hi;
};
__device__ __forceinline__ SplitSpan live_splits(int lo, int length, int chunk) {
  const int hi = (length - 1) / chunk;
  return {min(lo / chunk, hi), hi};
}

// NACC consecutive f32 values (8- or 16-byte aligned) in one access.
__device__ __forceinline__ void store_f32s(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}
__device__ __forceinline__ void store_f32s(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load_f32s_cg(const float* p, float (&v)[2]) {
  const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
  v[0] = x.x; v[1] = x.y;
}
__device__ __forceinline__ void load_f32s_cg(const float* p, float (&v)[4]) {
  const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// One warp writes its query head's partial: acc[a] is dim lane * NACC + a.
template <int NACC>
__device__ __forceinline__ void write_partial(float* acc_ws, float* ml_ws, size_t idx,
                                              const float (&acc)[NACC], float m, float l) {
  const int lane = threadIdx.x & 31;
  store_f32s(acc_ws + idx * (NACC * 32) + lane * NACC, acc);
  if (lane == 0) reinterpret_cast<float2*>(ml_ws)[idx] = make_float2(m, l);
}

// Every thread of the block calls it after writing its partials. True in
// every thread of the block that arrives last of `expected` on *counter;
// that block also resets the counter to 0 for the next launch (all the
// others have arrived, so none touches it again). `flag` is a __shared__ int.
__device__ __forceinline__ bool arrive_last(int* counter, int expected, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const bool last = atomicAdd(counter, 1) == expected - 1;
    if (last) *counter = 0;
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

// One warp merges the partials of query head `row` over the live chunks, in
// chunk order (so the result does not depend on which block arrived last),
// and writes out_row[lane * NACC + a]. Chunks are taken kMergeBatch at a
// time, every load of a batch issued before any is used, with the running
// max rescaled between batches. A chunk without a position (m = -inf)
// weighs 0; with none at all the output is 0, as when l == 0.
constexpr int kMergeBatch = 32;

template <typename T, int NACC>
__device__ __forceinline__ void combine_partials(const float* acc_ws, const float* ml_ws,
                                                 size_t row, int n_split, SplitSpan sp,
                                                 T* out_row) {
  constexpr int hd = NACC * 32;
  const int lane = threadIdx.x & 31;
  const size_t base = row * n_split;
  const float2* ml = reinterpret_cast<const float2*>(ml_ws) + base;
  float M = -INFINITY, l = 0.f, acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = 0.f;
  for (int s0 = sp.lo; s0 <= sp.hi; s0 += kMergeBatch) {
    const int n = min(kMergeBatch, sp.hi - s0 + 1);
    const float2 p = lane < n ? __ldcg(&ml[s0 + lane]) : make_float2(-INFINITY, 0.f);
    float x[kMergeBatch][NACC];
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i) {
      if (i < n) {
        load_f32s_cg(acc_ws + (base + s0 + i) * hd + lane * NACC, x[i]);
      } else {
#pragma unroll
        for (int a = 0; a < NACC; ++a) x[i][a] = 0.f;
      }
    }
    const float m_new = fmaxf(M, warp_max(p.x));
    if (m_new == -INFINITY) continue;  // no position so far (warp-uniform)
    const float alpha = expf(M - m_new);
    const float wgt = p.x == -INFINITY ? 0.f : expf(p.x - m_new);
    l = alpha * l + warp_sum(wgt * p.y);
#pragma unroll
    for (int a = 0; a < NACC; ++a) acc[a] *= alpha;
#pragma unroll
    for (int i = 0; i < kMergeBatch; ++i) {
      const float wi = __shfl_sync(0xffffffffu, wgt, i);
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[a] += wi * x[i][a];
    }
    M = m_new;
  }
  const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
  for (int a = 0; a < NACC; ++a) out_row[lane * NACC + a] = from_f32<T>(acc[a] * l_inv);
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
