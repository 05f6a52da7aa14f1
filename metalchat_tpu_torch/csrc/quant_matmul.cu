// Weight-only group-quantized matmul for decode-sized row counts, Hopper (sm_90a).
//
// Replaces metalchat_tpu/ops/quant_matmul_pallas.py: quant_matmul_pallas
// (_int8_kernel, _int4_kernel). One C entry, quant_matmul:
//   x (bf16/f32) [B, in], B <= 32  @  dequant(q, scales)  ->  out [B, out] in x's dtype
// Each weight element is T(float(q) * float(T(s))) in the activation dtype T,
// x is read as T, products are summed in f32 and the output rounded to T:
// for bf16 the TPU kernel's rounding (both products are exact in f32, only
// the summation order differs), for f32 the JAX package's f32 quant_matmul.
// Both storage orientations of the JAX package:
//   transposed:     q [out, in(/2)], scales [out, in/g]
//   non-transposed: q [in(/2), out], scales [in/g, out]
// with per-channel scales (g == in) [1, out] in both, which the index
// o * n_groups + grp (resp. grp * out + o) covers with n_groups = 1. int4 is
// half-split with an offset-binary low nibble: packed row r holds input r
// (low nibble, +8) and input r + in/2 (high nibble, two's complement).
//
// What bounds it on the H100: the weight stream. At B <= 32 each weight
// element is used B times, far below the ~295 bf16 operations per byte where
// the tensor cores would become the limit, so the least time is the packed
// bytes plus the group scales over the HBM rate. Design, simple first:
// - transposed: one warp per output row streams the row with 16-byte loads,
//   neighbouring lanes on neighbouring addresses; a 16-byte chunk lies in one
//   group (g % 16 == 0), so each lane reads one scale per chunk and half; the
//   nibbles unpack in registers; x is read through the L1 cache; a warp
//   reduction in f32 finishes each output.
// - non-transposed: threads run along out (the contiguous axis): a block
//   owns 32 output columns, its 8 warps split the packed rows into
//   contiguous ranges, each lane keeps its column's scale until the group
//   changes, and the 8 partial sums meet in shared memory.
// No tensor cores, no staging of weight tiles: making it fast is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// 16 consecutive values of x as f32.
template <typename T> __device__ __forceinline__ void load16(const T* p, float* v);
template <> __device__ __forceinline__ void load16<float>(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}
template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                   float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p) + i);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[8 * i + j] = __bfloat162float(h[j]);
  }
}

// A scale as the activation dtype sees it: T(s).
template <typename T, typename S> __device__ __forceinline__ float scale_as(S s) {
  return round_through<T>(to_f32<S>(s));
}

template <int MAXB, int BITS, typename T, typename S>
__global__ void __launch_bounds__(kThreads)
qmm_transposed(const T* __restrict__ x, const int8_t* __restrict__ q,
               const S* __restrict__ s, T* __restrict__ out, int B, int in_f, int out_f,
               int g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = in_f / 2;
  const int k = BITS == 4 ? half : in_f;
  const int n_groups = in_f / g;
  for (int o = blockIdx.x * kWarps + warp; o < out_f; o += gridDim.x * kWarps) {
    const int8_t* wrow = q + (size_t)o * k;
    const S* srow = s + (size_t)o * n_groups;
    float acc[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;
    for (int c = lane * 16; c < k; c += 32 * 16) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(wrow + c));
      const int8_t* wb = reinterpret_cast<const int8_t*>(&raw);
      float w_lo[16], w_hi[16];
      if (BITS == 8) {
        const float sc = scale_as<T, S>(srow[c / g]);
#pragma unroll
        for (int j = 0; j < 16; ++j) w_lo[j] = round_through<T>((float)wb[j] * sc);
      } else {
        const float s_lo = scale_as<T, S>(srow[c / g]);
        const float s_hi = scale_as<T, S>(srow[(half + c) / g]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          w_lo[j] = round_through<T>((float)((wb[j] & 15) - 8) * s_lo);
          w_hi[j] = round_through<T>((float)(wb[j] >> 4) * s_hi);
        }
      }
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b >= B) break;
        float xv[16];
        load16<T>(x + (size_t)b * in_f + c, xv);
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[b] = fmaf(xv[j], w_lo[j], acc[b]);
        if (BITS == 4) {
          load16<T>(x + (size_t)b * in_f + half + c, xv);
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[b] = fmaf(xv[j], w_hi[j], acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b >= B) break;
      const float total = warp_sum(acc[b]);
      if (lane == 0) out[(size_t)b * out_f + o] = from_f32<T>(total);
    }
  }
}

template <int MAXB, int BITS, typename T, typename S>
__global__ void __launch_bounds__(kThreads)
qmm_natural(const T* __restrict__ x, const int8_t* __restrict__ q,
            const S* __restrict__ s, T* __restrict__ out, int B, int in_f, int out_f,
            int g) {
  __shared__ float part[kWarps][MAXB][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = in_f / 2;
  const int k = BITS == 4 ? half : in_f;  // packed rows
  const int o = blockIdx.x * 32 + lane;
  const bool live = o < out_f;
  const int per = (k + kWarps - 1) / kWarps;
  const int r0 = warp * per;
  const int r1 = min(k, r0 + per);
  float acc[MAXB];
#pragma unroll
  for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;
  if (live) {
    float s_lo = 0.f, s_hi = 0.f;
    int next = r0;  // the next packed row that starts a group
#pragma unroll 4
    for (int r = r0; r < r1; ++r) {
      if (r == next) {
        s_lo = scale_as<T, S>(s[(size_t)(r / g) * out_f + o]);
        if (BITS == 4) s_hi = scale_as<T, S>(s[(size_t)((r + half) / g) * out_f + o]);
        next = (r / g + 1) * g;
      }
      const int8_t p = __ldg(q + (size_t)r * out_f + o);
      const float w_lo = round_through<T>((float)(BITS == 4 ? (p & 15) - 8 : p) * s_lo);
      const float w_hi = BITS == 4 ? round_through<T>((float)(p >> 4) * s_hi) : 0.f;
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b >= B) break;
        acc[b] = fmaf(to_f32<T>(__ldg(x + (size_t)b * in_f + r)), w_lo, acc[b]);
        if (BITS == 4)
          acc[b] = fmaf(to_f32<T>(__ldg(x + (size_t)b * in_f + half + r)), w_hi, acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < MAXB; ++b) part[warp][b][lane] = acc[b];
  __syncthreads();
  for (int i = threadIdx.x; i < B * 32; i += blockDim.x) {
    const int b = i / 32, l = i % 32;
    const int col = blockIdx.x * 32 + l;
    if (col >= out_f) continue;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += part[w][b][l];
    out[(size_t)b * out_f + col] = from_f32<T>(total);
  }
}

int max_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = sms * 8;
  }
  return blocks;
}

template <int MAXB, int BITS, typename T, typename S>
int launch(int transposed, const void* x, const void* q, const void* s, void* out, int B,
           int in_f, int out_f, int g, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const S* st_ = static_cast<const S*>(s);
  T* ot = static_cast<T*>(out);
  if (transposed) {
    int grid = (out_f + kWarps - 1) / kWarps;
    if (grid > max_blocks()) grid = max_blocks();
    qmm_transposed<MAXB, BITS, T, S><<<grid, kThreads, 0, st>>>(xt, qt, st_, ot, B, in_f,
                                                                out_f, g);
  } else {
    const int grid = (out_f + 31) / 32;
    qmm_natural<MAXB, BITS, T, S><<<grid, kThreads, 0, st>>>(xt, qt, st_, ot, B, in_f,
                                                             out_f, g);
  }
  return (int)cudaGetLastError();
}

template <int BITS, typename T, typename S>
int by_rows(int transposed, const void* x, const void* q, const void* s, void* out, int B,
            int in_f, int out_f, int g, cudaStream_t st) {
  if (B == 1) return launch<1, BITS, T, S>(transposed, x, q, s, out, B, in_f, out_f, g, st);
  if (B <= 8) return launch<8, BITS, T, S>(transposed, x, q, s, out, B, in_f, out_f, g, st);
  return launch<32, BITS, T, S>(transposed, x, q, s, out, B, in_f, out_f, g, st);
}

template <typename T, typename S>
int by_bits(int bits, int transposed, const void* x, const void* q, const void* s,
            void* out, int B, int in_f, int out_f, int g, cudaStream_t st) {
  if (bits == 4) return by_rows<4, T, S>(transposed, x, q, s, out, B, in_f, out_f, g, st);
  return by_rows<8, T, S>(transposed, x, q, s, out, B, in_f, out_f, g, st);
}

}  // namespace

extern "C" {

// x: [B, in] bf16 (x_bf16=1) or f32; q: int8 as described above; s: f32 or
// bf16 (s_bf16=1); out: [B, out] in x's dtype. 1 <= B <= 32, in % 32 == 0,
// g % 16 == 0 and in % g == 0 (checked by the caller).
int quant_matmul(const void* x, const void* q, const void* s, void* out, int B, int in_f,
                 int out_f, int g, int bits, int transposed, int x_bf16, int s_bf16,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && s_bf16)
    return by_bits<__nv_bfloat16, __nv_bfloat16>(bits, transposed, x, q, s, out, B, in_f, out_f, g, st);
  if (x_bf16)
    return by_bits<__nv_bfloat16, float>(bits, transposed, x, q, s, out, B, in_f, out_f, g, st);
  if (s_bf16)
    return by_bits<float, __nv_bfloat16>(bits, transposed, x, q, s, out, B, in_f, out_f, g, st);
  return by_bits<float, float>(bits, transposed, x, q, s, out, B, in_f, out_f, g, st);
}

}  // extern "C"
