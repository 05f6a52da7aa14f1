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

// Prologue of the int8-activation matvecs: one activation row of in_f values
// (staged in shared memory) into int8 codes, with the op order of the
// reference `_act_quantize` (and, with NORM, of ops.rms_norm -> round to the
// activation dtype -> _act_quantize). Every thread of the block calls it.
template <typename T, bool NORM>
__device__ void quantize_row(const T* x, const T* nw, int in_f, float eps,
                             float offset, int8_t* xq_row, float* sx_out, float* scratch) {
  float r = 0.f;
  if (NORM) {
    float ss = 0.f;
    for (int i = threadIdx.x; i < in_f; i += blockDim.x) {
      const float v = to_f32<T>(x[i]);
      ss += v * v;
    }
    const float var = block_sum(ss, scratch) / (float)in_f;
    r = 1.0f / sqrtf(var + eps);
  }
  auto value = [&](int i) -> float {
    const float v = to_f32<T>(x[i]);
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

// The int4 correction 8 * sum(x_lo) of one row of codes (ffn_block.cu's
// row_dot_chunk, the mma tile below).
__device__ __forceinline__ void int4_correction(const int8_t* xq_row, int in_f, int* corr,
                                                int* iscratch) {
  int part = 0;
  for (int i = threadIdx.x; i < in_f / 2; i += blockDim.x) part += xq_row[i];
  const int total = block_sum_int(part, iscratch);
  if (threadIdx.x == 0) *corr = 8 * total;
}

// The act-quant of one row, as every int8-activation kernel runs it: the row
// x [in_f] staged into xs (shared memory) with 16-byte loads, all in flight
// at once (COHERENT: through L2, for a row that other blocks of the launch
// wrote), and with NORM the norm weights nw [in_f] into nws likewise;
// quantize_row's passes then read them there (from global memory each pass
// was a chain of round trips), write the codes to xq_row (shared memory) and
// the scale to *sx; with corr, the int4 correction to *corr. Every thread
// of the block calls it; it ends synced.
template <typename T, bool NORM, bool COHERENT = false>
__device__ void quantize_staged(const T* x, const T* __restrict__ nw, int in_f, float eps,
                                float offset, T* xs, T* nws, int8_t* xq_row, float* sx,
                                int* corr, float* scratch, int* iscratch) {
  const int4* src = reinterpret_cast<const int4*>(x);
  const int4* wsrc = reinterpret_cast<const int4*>(nw);
  const int n16 = in_f * (int)sizeof(T) / 16;
#pragma unroll 8
  for (int i = threadIdx.x; i < n16; i += blockDim.x) {
    reinterpret_cast<int4*>(xs)[i] = COHERENT ? __ldcg(src + i) : src[i];
    if (NORM) reinterpret_cast<int4*>(nws)[i] = wsrc[i];
  }
  __syncthreads();
  quantize_row<T, NORM>(xs, nws, in_f, eps, offset, xq_row, sx, scratch);
  __syncthreads();
  if (corr != nullptr) int4_correction(xq_row, in_f, corr, iscratch);
  __syncthreads();
}

// -- The int8 tensor-core tile (mma.sync m16n8k32 s8.s8.s32) ------------------
//
// A tile is 16 weight rows (the mma's M) against up to 16 code rows in NT
// n-tiles of 8. k is walked in steps of 64 packed bytes a row, kMmaSplit warps
// splitting the steps. In one step a lane (group g = lane/4, thread t =
// lane%4) holds the 16 bytes [16t, 16t + 16) of weight rows g and g + 8 and
// of code row g of each n-tile, and feeds bytes 0-7 to one mma and 8-15 to
// the next: one permutation of k applied to both operands (an integer sum
// does not depend on its order), chosen so that every load is 16 contiguous
// bytes. Int4: (p & 0x0F0F0F0F) against x_lo and (p & 0xF0F0F0F0) against
// x_hi, both valid s8 operands (lo + 8 in [0, 15], 16 hi in [-128, 112]),
// into two accumulators; OWN_CORR adds a third against an A of all 8s, which
// gives 8 sum(x_lo) where no prologue computed it. Every partial is an exact
// integer (|acc| <= 14336 * 127 * 128 < 2^31).
constexpr int kMmaRows = 16;
constexpr int kMmaSplit = 8;
constexpr int kMmaStep = 64;

__device__ __forceinline__ int word_at(const int4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// c += A (16 x 32, row-major) * B (32 x 8, col-major), s8 in, s32 out. A:
// a0/a2 row g, a1/a3 row g + 8; a0/a1 k in [4t, 4t + 4), a2/a3 k + 16. B:
// column g, b0 k in [4t, 4t + 4), b1 k + 16. c0/c1 row g, c2/c3 row g + 8,
// columns 2t and 2t + 1.
__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2, int a3, int b0,
                                       int b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Accumulators a lane holds: [n-tile][lo, hi, 8 sum(x_lo)][register].
template <int BITS, bool OWN_CORR>
__host__ __device__ constexpr int mma_terms() { return BITS == 8 ? 1 : OWN_CORR ? 3 : 2; }

// One step: wa / wb are the lane's 16 bytes of weight rows g and g + 8, xl /
// xh its 16 bytes of code row g of each n-tile (xh: the hi half, int4 only).
template <int BITS, int NT, int NA, bool OWN_CORR>
__device__ __forceinline__ void mma_step(int (&acc)[NT][NA][4], const int4& wa, const int4& wb,
                                         const int4 (&xl)[NT], const int4 (&xh)[NT]) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {  // bytes 8m .. 8m + 7 of each lane's chunk
    const int a0 = word_at(wa, 2 * m), a1 = word_at(wb, 2 * m);
    const int a2 = word_at(wa, 2 * m + 1), a3 = word_at(wb, 2 * m + 1);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int b0 = word_at(xl[j], 2 * m), b1 = word_at(xl[j], 2 * m + 1);
      if (BITS == 8) {
        mma_s8(acc[j][0], a0, a1, a2, a3, b0, b1);
      } else {
        const int ml = 0x0F0F0F0F, mh = (int)0xF0F0F0F0u;
        mma_s8(acc[j][0], a0 & ml, a1 & ml, a2 & ml, a3 & ml, b0, b1);
        mma_s8(acc[j][1], a0 & mh, a1 & mh, a2 & mh, a3 & mh, word_at(xh[j], 2 * m),
               word_at(xh[j], 2 * m + 1));
        if (OWN_CORR) {
          const int eights = 0x08080808;
          mma_s8(acc[j][NA - 1], eights, eights, eights, eights, b0, b1);
        }
      }
    }
  }
}

// The kMmaSplit warps' partials of one tile summed in warp order through
// red [kMmaSplit][NT * NA * 4][32] (shared memory); then one thread per
// (n-tile j, register i, lane) calls epilogue(r, b, tot) for its tile row r
// (0..15) and code row b < B, tot[a] the tile's sums by term. Every thread of
// the block calls it; it syncs once, after the partials are written.
template <int NT, int NA, typename Epilogue>
__device__ __forceinline__ void mma_reduce(const int (&acc)[NT][NA][4], int* red, int B,
                                           Epilogue&& epilogue) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int kRegs = NT * NA * 4;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(warp * kRegs + (j * NA + a) * 4 + i) * 32 + lane] = acc[j][a][i];
  __syncthreads();
  for (int e = threadIdx.x; e < NT * 4 * 32; e += blockDim.x) {
    const int ln = e & 31, j = e >> 7, i = (e >> 5) & 3;
    const int r = (ln >> 2) + (i >= 2 ? 8 : 0);
    const int b = 8 * j + 2 * (ln & 3) + (i & 1);
    if (b >= B) continue;
    int tot[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tot[a] = 0;
#pragma unroll
      for (int w = 0; w < kMmaSplit; ++w)
        tot[a] += red[(w * kRegs + (j * NA + a) * 4 + i) * 32 + ln];
    }
    epilogue(r, b, tot);
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
// Eight codes as two 4-byte stores: a padded K tile row is 4-byte aligned only.
__device__ __forceinline__ void store_codes(void* p, const int8_t (&c)[8]) {
  char4* d = reinterpret_cast<char4*>(p);
  d[0] = make_char4(c[0], c[1], c[2], c[3]);
  d[1] = make_char4(c[4], c[5], c[6], c[7]);
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
__device__ __forceinline__ void store_f32s(float* p, const float (&v)[8]) {
  float4* d = reinterpret_cast<float4*>(p);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void load_f32s_cg(const float* p, float (&v)[2]) {
  const float2 x = __ldcg(reinterpret_cast<const float2*>(p));
  v[0] = x.x; v[1] = x.y;
}
__device__ __forceinline__ void load_f32s_cg(const float* p, float (&v)[4]) {
  const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}
__device__ __forceinline__ void load_f32s_cg(const float* p, float (&v)[8]) {
  const float4 x = __ldcg(reinterpret_cast<const float4*>(p));
  const float4 y = __ldcg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
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
// and writes out_row[lane * NACC + a]. Chunks are taken merge_batch() at a
// time, every load of a batch issued before any is used, with the running
// max rescaled between batches. A chunk without a position (m = -inf)
// weighs 0; with none at all the output is 0, as when l == 0. A batch holds
// at most 128 partial values a lane: 32 chunks up to hd 128, 16 at hd 256.
template <int NACC> __host__ __device__ constexpr int merge_batch() {
  return NACC <= 4 ? 32 : 128 / NACC;
}

template <typename T, int NACC>
__device__ __forceinline__ void combine_partials(const float* acc_ws, const float* ml_ws,
                                                 size_t row, int n_split, SplitSpan sp,
                                                 T* out_row) {
  constexpr int hd = NACC * 32;
  const int lane = threadIdx.x & 31;
  const size_t base = row * n_split;
  const float2* ml = reinterpret_cast<const float2*>(ml_ws) + base;
  constexpr int kMergeBatch = merge_batch<NACC>();
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
