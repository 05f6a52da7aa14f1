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
// addresses. The int4 nibbles never get unpacked (warp_row_dot in
// common.cuh: dp4a on masked bytes, the TPU kernel's identities). Integer
// sums are order-free, so the raw mode is bit-exact against any reference.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

enum Mode { kRaw = 0, kFused = 1, kFusedNorm = 2 };

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

  const int k = BITS == 4 ? in_f / 2 : in_f;  // packed bytes per weight row

  for (int b = 0; b < B; ++b) {
    int8_t* row = xq + (size_t)b * in_f;
    if (MODE == kRaw) {
      const int8_t* xin = static_cast<const int8_t*>(x_) + (size_t)b * in_f;
      for (int i = threadIdx.x; i < in_f; i += blockDim.x) row[i] = xin[i];
    } else {
      const T* xin = static_cast<const T*>(x_) + (size_t)b * in_f;
      quantize_row<T, MODE == kFusedNorm>(xin, nw, in_f, eps, offset, row, &sx[b], scratch);
    }
    __syncthreads();
    if (BITS == 4) int4_correction(row, in_f, &corr[b], iscratch);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = blockIdx.x * kWarps + warp; o < out_f; o += gridDim.x * kWarps) {
    warp_row_dot<MAXB, BITS>(p + (size_t)o * k, xq, in_f, B, corr, [&](int b, int total) {
      if (lane != 0) return;
      if (MODE == kRaw) {
        static_cast<int32_t*>(out_)[(size_t)b * out_f + o] = total;
      } else {
        const float y = ((float)total * sx[b]) * to_f32<S>(s_col[o]);
        static_cast<T*>(out_)[(size_t)b * out_f + o] = from_f32<T>(y);
      }
    });
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
