// W4A8 / W8A8 stacked decode matvec for Hopper (sm_90a).
//
// Replaces metalchat_tpu/ops/a8_matvec_pallas.py: quant_matvec_stacked_fused
// (_fused_kernel, _int_acc_w4, _int_acc_w8) and quant_matvec_stacked
// (_w4_kernel, _w8_kernel). The function:
//   fused: x (bf16/f32) [B, in] -> optional rmsnorm prologue ->
//       per-token int8 act-quant -> s8 x s8 -> s32 -> acc * sx * s_col -> [B, out]
//   raw:   xq int8 [B, in] -> raw int32 accumulator [B, out]
// The weight pointer is already layer l of the stacked [L, out, k] array,
// k = in/2 for packed int4 (half-split, offset-binary low nibble) or in.
// The indexed form (a8_quantize_mma_indexed) takes the stack's base instead,
// with the entry read on the device: every block of a8_mma_kernel reads the
// int32 index once and forms base + (int64) index * stride for the weights
// and the scales. That is the Pallas kernel's scalar-prefetched layer
// argument, which the JAX decode step feeds with l * E + topk(router)[j]
// over a flattened [L * E, out, k] expert stack (models/decode.py
// _expert_linear_l): the host never reads the routed expert, so a decode
// step with routed experts stays one CUDA graph. Mixtral-8x7B's w2 entry
// 255 starts 7.49e9 bytes into its stack, past 2^31: the offset is 64-bit.
// The index comes from topk over E and is not range-checked here.
//
// What bounds it on the H100: the weight stream. At batch <= 16 each weight
// byte is used B times, far below the ~600 int8 ops per byte where the
// tensor cores would become the limit, so the kernel is a pure HBM read of
// out*k bytes. The Pallas kernel quantizes x in each of its few sequential
// grid steps; on the H100 the same prologue in each of up to 1056 parallel
// blocks left HBM idle for its length (PR 1's kernel, 3.38 ms a decode step
// at one row against a 1.12 ms bound, 2.06 of it the prologue; PR 4's at 8
// rows, 23.5 ms). So every row count, one included, takes two launches
// (fused; raw mode the second alone):
//   a8_quantize_kernel: grid B, one block of 512 threads a row, act-quant
//     once a call (quantize_staged: the row and norm weights staged in
//     shared memory, quantize_row's op order) into xq [B, in] int8, sx [B]
//     f32, corr [B] int32.
//   a8_mma_kernel: mma.sync m16n8k32 s8.s8.s32 (the tile of common.cuh,
//     mma_step / mma_reduce). A block owns a tile of 16 output rows and
//     kMmaSplit warps split its k: warp w takes the 64-byte steps w, w +
//     kMmaSplit, ... of every row. The codes are read through L1 (xq is at
//     most 229 KB, the same for every block); the weights bypass it. kUnroll
//     steps of loads are issued before the first mma. Code rows >= B are
//     zero (at one row the tensor cores do 15/16 wasted work, which costs
//     nothing: HBM bounds the call). The warps' int32 partials are summed in
//     warp order, then (acc_lo - corr) + (acc_hi >> 4) and, fused, ((float)
//     total * sx[b]) * s_col[o]. Raw mode has no a8_quantize, so int4 takes
//     corr = 8 sum(x_lo) from a third mma per step whose A operand is all
//     8s. Every partial is an exact integer, so raw mode is bit-exact.
// At one row this route was measured against one-launch designs that stream
// the weights under the prologue (a ring of TMA or cp.async stages with every
// block quantizing the row, and a cooperative grid whose block 0 quantizes
// it for all): both were slower (PERF.md, PR 8).
#include "common.cuh"

namespace {

enum Mode { kRaw = 0, kFused = 1 };

// a8_mma_kernel: kUnroll steps of loads in flight a warp (half as many with
// two n-tiles, which double the codes).
constexpr int kUnroll = 4;
// a8_quantize_kernel's block: quantize_row's passes are chains of dependent
// steps, and 16 warps on the row's SM hide them better than 8 (a quarter
// less time a call at 8 rows, measured); 32 gain no more.
constexpr int kQuantizeThreads = 512;

// 16 weight bytes streamed once: not kept in L1, where the codes live.
__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// One warp's kUnroll steps s0, s0 + kMmaSplit, ... of a 16-row tile: the
// lane's 16 bytes of weight rows g and g + 8 (zeros past k or out).
template <int U>
__device__ __forceinline__ void load_steps(const int8_t* p, int tile, int s0, int k, int out_f,
                                           int4 (&wa)[U], int4 (&wb)[U]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int o0 = tile * kMmaRows + g;
  const bool live0 = o0 < out_f, live1 = o0 + 8 < out_f;
  const int8_t* w0 = p + (size_t)(live0 ? o0 : 0) * k + 16 * t;
  const int8_t* w1 = p + (size_t)(live1 ? o0 + 8 : 0) * k + 16 * t;
  const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int c = (s0 + u * kMmaSplit) * kMmaStep;
    const bool in = c + 16 * t < k;  // k % 16 == 0: a 16-byte chunk is all in or out
    wa[u] = in && live0 ? ld_stream(w0 + c) : zero;
    wb[u] = in && live1 ? ld_stream(w1 + c) : zero;
  }
}

template <typename T, bool NORM>
__global__ void __launch_bounds__(kQuantizeThreads)
a8_quantize_kernel(const T* __restrict__ x, const T* __restrict__ nw, int8_t* __restrict__ xq,
                   float* __restrict__ sx, int* __restrict__ corr, int in_f, float eps,
                   float offset) {
  // The row is staged in shared memory and quantized there (from global
  // memory each of quantize_row's passes was a chain of round trips); the
  // codes leave in 16-byte stores.
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* row = reinterpret_cast<int8_t*>(smem);  // [in_f]
  T* xs = reinterpret_cast<T*>(smem + in_f);      // [in_f]
  T* nws = xs + in_f;                             // [in_f] (NORM)
  __shared__ float scratch[kQuantizeThreads / 32];
  __shared__ int iscratch[kQuantizeThreads / 32];
  const int b = blockIdx.x;
  quantize_staged<T, NORM>(x + (size_t)b * in_f, nw, in_f, eps, offset, xs, nws, row, &sx[b],
                           corr == nullptr ? nullptr : &corr[b], scratch, iscratch);
  int4* dst = reinterpret_cast<int4*>(xq + (size_t)b * in_f);
  for (int i = threadIdx.x; i < in_f / 16; i += blockDim.x)
    dst[i] = reinterpret_cast<const int4*>(row)[i];
}

// NT n-tiles of 8 code rows (B <= 8 * NT). MODE kRaw writes int32 (and, for
// int4, makes its own corr); kFused applies sx and s_col into T. INDEXED:
// p and s_col are the stacks' bases, the entry is *index (strides in
// elements of p and s_col).
template <int BITS, int NT, int MODE, typename T, typename S, bool INDEXED>
__global__ void __launch_bounds__(kMmaSplit * 32, 2)
a8_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ p,
              const S* __restrict__ s_col, const float* __restrict__ sx,
              const int* __restrict__ corr, void* __restrict__ out_, int B, int in_f,
              int out_f, const int* __restrict__ index, long long p_stride,
              long long s_stride) {
  if (INDEXED) {
    const long long e = __ldg(index);
    p += e * p_stride;
    s_col += e * s_stride;
  }
  constexpr bool kOwnCorr = BITS == 4 && MODE == kRaw;
  constexpr int NA = mma_terms<BITS, kOwnCorr>();  // lo, hi, 8 sum(x_lo)
  constexpr int U = NT == 1 ? kUnroll : kUnroll / 2;
  __shared__ int red[kMmaSplit * NT * NA * 4 * 32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k = BITS == 4 ? in_f / 2 : in_f;  // packed bytes a weight row
  const int half = in_f / 2;
  const int8_t* xr[NT];
  bool xlive[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    xlive[j] = 8 * j + g < B;
    xr[j] = xq + (size_t)(xlive[j] ? 8 * j + g : 0) * in_f + 16 * t;
  }
  int acc[NT][NA][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][a][i] = 0;

  const int4 zero = make_int4(0, 0, 0, 0);
  const int steps = (k + kMmaStep - 1) / kMmaStep;
  for (int s0 = warp; s0 < steps; s0 += kMmaSplit * U) {
    int4 wa[U], wb[U], xl[U][NT], xh[U][NT];
    load_steps<U>(p, blockIdx.x, s0, k, out_f, wa, wb);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (s0 + u * kMmaSplit) * kMmaStep;
      const bool in = c + 16 * t < k;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool x_in = in && xlive[j];
        xl[u][j] = x_in ? __ldg(reinterpret_cast<const int4*>(xr[j] + c)) : zero;
        xh[u][j] = x_in && BITS == 4 ? __ldg(reinterpret_cast<const int4*>(xr[j] + half + c))
                                     : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) mma_step<BITS, NT, NA, kOwnCorr>(acc, wa[u], wb[u], xl[u], xh[u]);
  }

  mma_reduce<NT, NA>(acc, red, B, [&](int r, int b, const int* tot) {
    const int o = blockIdx.x * kMmaRows + r;
    if (o >= out_f) return;
    int total = tot[0];
    if (BITS == 4) total = (tot[0] - (kOwnCorr ? tot[NA - 1] : corr[b])) + (tot[1] >> 4);
    if (MODE == kRaw) {
      static_cast<int32_t*>(out_)[(size_t)b * out_f + o] = total;
    } else {
      const float y = ((float)total * sx[b]) * to_f32<S>(s_col[o]);
      static_cast<T*>(out_)[(size_t)b * out_f + o] = from_f32<T>(y);
    }
  });
}

template <typename T>
int quantize(int norm, const void* x, const void* nw, int8_t* xq, float* sx, int* corr,
             int B, int in_f, float eps, float offset, cudaStream_t st) {
  const size_t smem = (size_t)in_f * (1 + (1 + norm) * sizeof(T));  // codes, row, norm weights
  auto kernel = norm ? a8_quantize_kernel<T, true> : a8_quantize_kernel<T, false>;
  static size_t configured[2] = {0, 0};
  if (smem > 48 * 1024 && smem > configured[norm]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[norm] = smem;
  }
  kernel<<<B, kQuantizeThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const T*>(nw),
                                            xq, sx, corr, in_f, eps, offset);
  return (int)cudaGetLastError();
}

template <int BITS, int MODE, typename T, typename S, bool INDEXED = false>
int launch_mma(const int8_t* xq, const int8_t* p, const void* s, const float* sx,
               const int* corr, void* out, int B, int in_f, int out_f, cudaStream_t st,
               const int* index = nullptr, long long p_stride = 0, long long s_stride = 0) {
  if (B < 1 || B > 16) return (int)cudaErrorInvalidValue;
  const int grid = (out_f + kMmaRows - 1) / kMmaRows;
  const S* sc = static_cast<const S*>(s);
  if (B <= 8)
    a8_mma_kernel<BITS, 1, MODE, T, S, INDEXED><<<grid, kMmaSplit * 32, 0, st>>>(
        xq, p, sc, sx, corr, out, B, in_f, out_f, index, p_stride, s_stride);
  else
    a8_mma_kernel<BITS, 2, MODE, T, S, INDEXED><<<grid, kMmaSplit * 32, 0, st>>>(
        xq, p, sc, sx, corr, out, B, in_f, out_f, index, p_stride, s_stride);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int mma_fused(int bits, const int8_t* xq, const int8_t* p, const void* s, const float* sx,
              const int* corr, void* out, int B, int in_f, int out_f, cudaStream_t st) {
  if (bits == 4) return launch_mma<4, kFused, T, S>(xq, p, s, sx, corr, out, B, in_f, out_f, st);
  return launch_mma<8, kFused, T, S>(xq, p, s, sx, corr, out, B, in_f, out_f, st);
}

template <typename T, typename S>
int mma_indexed(int bits, const int8_t* xq, const int8_t* p, const void* s, const float* sx,
                const int* corr, void* out, int B, int in_f, int out_f, cudaStream_t st,
                const int* index, long long p_stride, long long s_stride) {
  if (bits == 4)
    return launch_mma<4, kFused, T, S, true>(xq, p, s, sx, corr, out, B, in_f, out_f, st,
                                             index, p_stride, s_stride);
  return launch_mma<8, kFused, T, S, true>(xq, p, s, sx, corr, out, B, in_f, out_f, st, index,
                                           p_stride, s_stride);
}

}  // namespace

extern "C" {

// Act-quant of B rows, one block a row. x: [B, in] bf16 (x_bf16=1) or f32;
// nw: [in] in x's dtype, or NULL for no norm; xq: int8 [B, in]; sx: f32
// [B]; corr: int32 [B] (8 * sum of each row's first in/2 codes), or NULL.
int a8_quantize(const void* x, const void* nw, void* xq, void* sx, void* corr, int B,
                int in_f, int x_bf16, float eps, float offset, void* stream) {
  const int norm = nw != nullptr;
  int8_t* q = static_cast<int8_t*>(xq);
  float* s = static_cast<float*>(sx);
  int* c = static_cast<int*>(corr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) return quantize<__nv_bfloat16>(norm, x, nw, q, s, c, B, in_f, eps, offset, st);
  return quantize<float>(norm, x, nw, q, s, c, B, in_f, eps, offset, st);
}

// 1 <= B <= 16, after a8_quantize. xq: int8 [B, in]; p: int8 [out, k]; s:
// [out] f32 or bf16 (s_bf16=1); sx: f32 [B]; corr: int32 [B] (bits 4);
// out: [B, out] bf16 (out_bf16=1) or f32. Every pointer 16-byte aligned.
int a8_mma(const void* xq, const void* p, const void* s, const void* sx, const void* corr,
           void* out, int B, int in_f, int out_f, int bits, int out_bf16, int s_bf16,
           void* stream) {
  const int8_t* q = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(p);
  const float* sxf = static_cast<const float*>(sx);
  const int* c = static_cast<const int*>(corr);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16 && s_bf16)
    return mma_fused<__nv_bfloat16, __nv_bfloat16>(bits, q, w, s, sxf, c, out, B, in_f, out_f, st);
  if (out_bf16)
    return mma_fused<__nv_bfloat16, float>(bits, q, w, s, sxf, c, out, B, in_f, out_f, st);
  if (s_bf16)
    return mma_fused<float, __nv_bfloat16>(bits, q, w, s, sxf, c, out, B, in_f, out_f, st);
  return mma_fused<float, float>(bits, q, w, s, sxf, c, out, B, in_f, out_f, st);
}

// The fused matvec's two launches from one call (the host sets the pace of
// batch-1 decode): a8_quantize of x into the workspace ws (codes [B, in],
// then sx [B] f32 and, for bits 4, corr [B] int32), then a8_mma. Arguments
// as those two; ws holds B * in + 8 * B bytes.
int a8_quantize_mma(const void* x, const void* nw, const void* p, const void* s, void* ws,
                    void* out, int B, int in_f, int out_f, int bits, int x_bf16, int s_bf16,
                    float eps, float offset, void* stream) {
  int8_t* xq = static_cast<int8_t*>(ws);
  float* sx = reinterpret_cast<float*>(xq + (size_t)B * in_f);
  int* corr = bits == 4 ? reinterpret_cast<int*>(sx + B) : nullptr;
  const int rc = a8_quantize(x, nw, xq, sx, corr, B, in_f, x_bf16, eps, offset, stream);
  if (rc != 0) return rc;
  return a8_mma(xq, p, s, sx, corr, out, B, in_f, out_f, bits, x_bf16, s_bf16, stream);
}

// a8_quantize_mma with the stack entry read on the device: p and s are the
// bases of the stacks [N, out, k] and [N, 1, out], index points to one int32
// entry in [0, N) on the card, p_stride = out * k and s_stride = out. No norm
// prologue.
int a8_quantize_mma_indexed(const void* x, const void* p, const void* s, const void* index,
                            void* ws, void* out, int B, int in_f, int out_f, int bits,
                            int x_bf16, int s_bf16, long long p_stride, long long s_stride,
                            void* stream) {
  int8_t* xq = static_cast<int8_t*>(ws);
  float* sx = reinterpret_cast<float*>(xq + (size_t)B * in_f);
  int* corr = bits == 4 ? reinterpret_cast<int*>(sx + B) : nullptr;
  const int rc = a8_quantize(x, nullptr, xq, sx, corr, B, in_f, x_bf16, 0.f, 0.f, stream);
  if (rc != 0) return rc;
  const int8_t* w = static_cast<const int8_t*>(p);
  const int* e = static_cast<const int*>(index);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && s_bf16)
    return mma_indexed<__nv_bfloat16, __nv_bfloat16>(bits, xq, w, s, sx, corr, out, B, in_f,
                                                     out_f, st, e, p_stride, s_stride);
  if (x_bf16)
    return mma_indexed<__nv_bfloat16, float>(bits, xq, w, s, sx, corr, out, B, in_f, out_f, st,
                                             e, p_stride, s_stride);
  if (s_bf16)
    return mma_indexed<float, __nv_bfloat16>(bits, xq, w, s, sx, corr, out, B, in_f, out_f, st,
                                             e, p_stride, s_stride);
  return mma_indexed<float, float>(bits, xq, w, s, sx, corr, out, B, in_f, out_f, st, e,
                                   p_stride, s_stride);
}

// 1 <= B <= 16. xq: int8 [B, in]; p: int8 [out, k]; out: int32 [B, out].
int a8_mma_raw(const void* xq, const void* p, void* out, int B, int in_f, int out_f,
               int bits, void* stream) {
  const int8_t* q = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 4)
    return launch_mma<4, kRaw, float, float>(q, w, nullptr, nullptr, nullptr, out, B, in_f,
                                             out_f, st);
  return launch_mma<8, kRaw, float, float>(q, w, nullptr, nullptr, nullptr, out, B, in_f, out_f,
                                           st);
}

}  // extern "C"
