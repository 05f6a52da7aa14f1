// W4A8 / W8A8 stacked decode matvec for Hopper (sm_90a).
//
// Replaces metalchat_tpu/ops/a8_matvec_pallas.py: quant_matvec_stacked_fused
// (_fused_kernel, _int_acc_w4, _int_acc_w8) and quant_matvec_stacked
// (_w4_kernel, _w8_kernel). One C entry per mode:
//   a8_matvec_fused: x (bf16/f32) [B, in] -> optional rmsnorm prologue ->
//       per-token int8 act-quant -> s8 x s8 -> s32 -> acc * sx * s_col -> [B, out]
//   a8_matvec_raw:   xq int8 [B, in] -> raw int32 accumulator [B, out]
// The weight pointer is already layer l of the stacked [L, out, k] array,
// k = in/2 for packed int4 (half-split, offset-binary low nibble) or in.
//
// What bounds it on the H100: the weight stream. At batch <= 16 each weight
// byte is used B times, far below the ~600 int8 ops per byte where the
// tensor cores would become the limit, so the kernel is a pure HBM read of
// out*k bytes. Design: each block quantizes x once into shared memory (B*in
// bytes, tiny next to the weights); each warp then owns whole output rows
// and streams a row with 16-byte loads, neighbouring lanes on neighbouring
// addresses. The int4 nibbles never get unpacked: dp4a on (p & 0x0F0F0F0F)
// gives sum x_lo*(lo+8) and on (p & 0xF0F0F0F0) gives 16*sum x_hi*hi, both
// exact; the +8 bias is removed with 8*sum(x_lo) and the 16 with an
// arithmetic >> 4, the same identities as the TPU kernel. Integer sums are
// order-free, so the raw mode is bit-exact against any reference.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

enum Mode { kRaw = 0, kFused = 1, kFusedNorm = 2 };

// Prologue: one activation row into shared memory as int8 codes.
// Same op order as the reference `_act_quantize` (and, with the norm, as
// ops.rms_norm -> round to the activation dtype -> _act_quantize).
template <typename T, int MODE>
__device__ void quantize_row(const T* __restrict__ x, const T* __restrict__ nw,
                             int in_f, float eps, float offset, int8_t* xq_row,
                             float* sx_out, float* scratch) {
  float r = 0.f;
  if (MODE == kFusedNorm) {
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
    if (MODE != kFusedNorm) return v;
    return round_through<T>((v * r) * (offset + to_f32<T>(nw[i])));
  };
  float amax = 0.f;
  for (int i = threadIdx.x; i < in_f; i += blockDim.x) amax = fmaxf(amax, fabsf(value(i)));
  amax = block_max(amax, scratch);
  const float sx = amax == 0.f ? 1.f : amax / 127.f;
  for (int i = threadIdx.x; i < in_f; i += blockDim.x) xq_row[i] = quant_code(value(i) / sx);
  if (threadIdx.x == 0) *sx_out = sx;
}

template <int MAXB, int BITS, int MODE, typename T, typename S>
__global__ void __launch_bounds__(kThreads)
a8_matvec_kernel(const void* __restrict__ x_, const int8_t* __restrict__ p,
                 const S* __restrict__ s_col, const T* __restrict__ nw,
                 void* __restrict__ out_, int B, int in_f, int out_f,
                 float eps, float offset) {
  extern __shared__ __align__(16) int8_t xq[];  // [B][in_f]
  __shared__ float sx[MAXB];
  __shared__ int corr[MAXB];
  __shared__ float scratch[kWarps];
  __shared__ int iscratch[kWarps];

  const int half = in_f / 2;
  const int k = BITS == 4 ? half : in_f;  // packed bytes per weight row

  for (int b = 0; b < B; ++b) {
    int8_t* row = xq + (size_t)b * in_f;
    if (MODE == kRaw) {
      const int8_t* xin = static_cast<const int8_t*>(x_) + (size_t)b * in_f;
      for (int i = threadIdx.x; i < in_f; i += blockDim.x) row[i] = xin[i];
    } else {
      const T* xin = static_cast<const T*>(x_) + (size_t)b * in_f;
      const T* nrow = nw;
      quantize_row<T, MODE>(xin, nrow, in_f, eps, offset, row, &sx[b], scratch);
    }
    __syncthreads();
    if (BITS == 4) {
      int part = 0;
      for (int i = threadIdx.x; i < half; i += blockDim.x) part += row[i];
      const int total = block_sum_int(part, iscratch);
      if (threadIdx.x == 0) corr[b] = 8 * total;
    }
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = blockIdx.x * kWarps + warp; o < out_f; o += gridDim.x * kWarps) {
    const int8_t* wrow = p + (size_t)o * k;
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
      int total = warp_sum_int(acc_lo[b]);
      if (BITS == 4) total = (total - corr[b]) + (warp_sum_int(acc_hi[b]) >> 4);
      if (lane == 0) {
        if (MODE == kRaw) {
          static_cast<int32_t*>(out_)[(size_t)b * out_f + o] = total;
        } else {
          const float y = ((float)total * sx[b]) * to_f32<S>(s_col[o]);
          static_cast<T*>(out_)[(size_t)b * out_f + o] = from_f32<T>(y);
        }
      }
    }
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

template <int MAXB, int BITS, int MODE, typename T, typename S>
int launch(const void* x, const int8_t* p, const void* s, const void* nw, void* out,
           int B, int in_f, int out_f, float eps, float offset, cudaStream_t stream) {
  auto kernel = a8_matvec_kernel<MAXB, BITS, MODE, T, S>;
  const size_t smem = (size_t)B * in_f;
  static size_t configured = 0;
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  int grid = (out_f + kWarps - 1) / kWarps;
  if (grid > max_blocks()) grid = max_blocks();
  kernel<<<grid, kThreads, smem, stream>>>(x, p, static_cast<const S*>(s),
                                          static_cast<const T*>(nw), out, B, in_f,
                                          out_f, eps, offset);
  return (int)cudaGetLastError();
}

template <int BITS, int MODE, typename T, typename S>
int by_batch(const void* x, const int8_t* p, const void* s, const void* nw, void* out,
             int B, int in_f, int out_f, float eps, float offset, cudaStream_t st) {
  if (B == 1) return launch<1, BITS, MODE, T, S>(x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
  if (B <= 4) return launch<4, BITS, MODE, T, S>(x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
  return launch<16, BITS, MODE, T, S>(x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
}

template <int MODE, typename T, typename S>
int by_bits(int bits, const void* x, const int8_t* p, const void* s, const void* nw,
            void* out, int B, int in_f, int out_f, float eps, float offset,
            cudaStream_t st) {
  if (bits == 4) return by_batch<4, MODE, T, S>(x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
  return by_batch<8, MODE, T, S>(x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
}

template <typename T, typename S>
int fused(int norm, int bits, const void* x, const int8_t* p, const void* s,
          const void* nw, void* out, int B, int in_f, int out_f, float eps,
          float offset, cudaStream_t st) {
  if (norm) return by_bits<kFusedNorm, T, S>(bits, x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
  return by_bits<kFused, T, S>(bits, x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
}

}  // namespace

extern "C" {

// x: [B, in] bf16 (x_bf16=1) or f32; p: int8 [out, k] (one layer); s: [out]
// f32 or bf16 (s_bf16=1); nw: [in] in x's dtype, or NULL for no norm;
// out: [B, out] in x's dtype. B <= 16; in % 32 == 0 (checked by the caller).
int a8_matvec_fused(const void* x, const void* p, const void* s, const void* nw,
                    void* out, int B, int in_f, int out_f, int bits, int x_bf16,
                    int s_bf16, float eps, float offset, void* stream) {
  const int norm = nw != nullptr;
  const int8_t* w = static_cast<const int8_t*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && s_bf16)
    return fused<__nv_bfloat16, __nv_bfloat16>(norm, bits, x, w, s, nw, out, B, in_f, out_f, eps, offset, st);
  if (x_bf16)
    return fused<__nv_bfloat16, float>(norm, bits, x, w, s, nw, out, B, in_f, out_f, eps, offset, st);
  if (s_bf16)
    return fused<float, __nv_bfloat16>(norm, bits, x, w, s, nw, out, B, in_f, out_f, eps, offset, st);
  return fused<float, float>(norm, bits, x, w, s, nw, out, B, in_f, out_f, eps, offset, st);
}

// xq: int8 [B, in]; p: int8 [out, k]; out: int32 [B, out].
int a8_matvec_raw(const void* xq, const void* p, void* out, int B, int in_f,
                  int out_f, int bits, void* stream) {
  return by_bits<kRaw, float, float>(bits, xq, static_cast<const int8_t*>(p), nullptr,
                                     nullptr, out, B, in_f, out_f, 0.f, 0.f,
                                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
