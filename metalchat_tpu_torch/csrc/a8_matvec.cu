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
//
// What bounds it on the H100: the weight stream. At batch <= 16 each weight
// byte is used B times, far below the ~600 int8 ops per byte where the
// tensor cores would become the limit, so the kernel is a pure HBM read of
// out*k bytes. Two routes, by row count:
//
// B = 1 (a8_matvec_fused / a8_matvec_raw, a8_matvec_kernel): each block
// quantizes x once into shared memory; each warp then owns whole output
// rows and streams a row with 16-byte loads, neighbouring lanes on
// neighbouring addresses. The int4 nibbles never get unpacked (warp_row_dot
// in common.cuh: dp4a on masked bytes, the TPU kernel's identities).
//
// 2 <= B <= 16 (a8_quantize, then a8_mma or a8_mma_raw): the Pallas kernel
// quantizes x in each of its few sequential grid steps; on the H100 the same
// prologue in each of up to 1056 parallel blocks, one row after another,
// cost more than the weight stream at 8 rows, and the row dot re-read the
// codes from shared memory for every output row. So:
//   a8_quantize_kernel: grid B, one block of 512 threads a row, act-quant once a call
//     with quantize_row / int4_correction (the B = 1 prologue's op order, so
//     the same codes) on the row staged in shared memory, into xq [B, in]
//     int8, sx [B] f32, corr [B] int32.
//   a8_mma_kernel: int8 tensor cores, mma.sync m16n8k32 s8.s8.s32. A block
//     owns a tile of 16 output rows (the mma's M) and kSplit warps split its
//     k: warp w takes the 64-byte steps w, w + kSplit, ... of every row. In
//     one step a lane (group g = lane/4, thread t = lane%4) loads the 16
//     bytes [16t, 16t + 16) of weight rows g and g + 8 and of code row g (n
//     = g, or 8 + g in the second n-tile), and feeds bytes 0-7 to one mma
//     and 8-15 to the next. That is one permutation of k applied to both
//     operands (an integer sum does not depend on its order), chosen so that
//     every load is 16 contiguous bytes. The codes are read through L1 (xq
//     is at most 229 KB, the same for every block); the weights bypass it.
//     kUnroll steps of loads are issued before the first mma. Code rows >= B
//     are zero. Int4: (p & 0x0F0F0F0F) against x_lo and (p & 0xF0F0F0F0)
//     against x_hi, both valid s8 operands (lo + 8 in [0, 15], 16 hi in
//     [-128, 112]), into two accumulators. The warps' int32 partials are
//     summed in shared memory in warp order, then (acc_lo - corr) + (acc_hi
//     >> 4) and, fused, ((float)total * sx[b]) * s_col[o] as at B = 1. Raw
//     mode has no a8_quantize, so int4 takes corr = 8 sum(x_lo) from a third
//     mma per step whose A operand is all 8s. Every partial is an exact
//     integer (|acc| <= 14336 * 127 * 128 < 2^31), so raw mode is bit-exact.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

enum Mode { kRaw = 0, kFused = 1, kFusedNorm = 2 };

// a8_mma_kernel's tile: 16 output rows a block, kSplit warps over k, steps
// of 64 packed bytes a row (4 lanes x 16 B), kUnroll steps of loads in
// flight a warp (half as many with two n-tiles, which double the codes).
constexpr int kTileRows = 16;
constexpr int kSplit = 8;
constexpr int kStep = 64;
constexpr int kUnroll = 4;
// a8_quantize_kernel's block: quantize_row's passes are chains of dependent
// steps, and 16 warps on the row's SM hide them better than 8 (a quarter
// less time a call at 8 rows, measured); 32 gain no more.
constexpr int kQuantizeThreads = 512;

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

template <typename T, bool NORM>
__global__ void __launch_bounds__(kQuantizeThreads)
a8_quantize_kernel(const T* __restrict__ x, const T* __restrict__ nw, int8_t* __restrict__ xq,
                   float* __restrict__ sx, int* __restrict__ corr, int in_f, float eps,
                   float offset) {
  // The row is staged in shared memory with 16-byte loads, all in flight at
  // once; quantize_row's passes then read it there (from global memory each
  // pass was a chain of round trips, one an unrolled group of elements) and
  // write the codes there, and the codes leave in 16-byte stores.
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);                                // [in_f]
  int8_t* row = reinterpret_cast<int8_t*>(smem + in_f * sizeof(T));  // [in_f]
  __shared__ float scratch[kQuantizeThreads / 32];
  __shared__ int iscratch[kQuantizeThreads / 32];
  const int b = blockIdx.x;
  const int4* src = reinterpret_cast<const int4*>(x + (size_t)b * in_f);
  const int n16 = in_f * (int)sizeof(T) / 16;
#pragma unroll 8
  for (int i = threadIdx.x; i < n16; i += blockDim.x) reinterpret_cast<int4*>(xs)[i] = src[i];
  __syncthreads();
  quantize_row<T, NORM>(xs, nw, in_f, eps, offset, row, &sx[b], scratch);
  __syncthreads();
  if (corr != nullptr) int4_correction(row, in_f, &corr[b], iscratch);
  int4* dst = reinterpret_cast<int4*>(xq + (size_t)b * in_f);
  for (int i = threadIdx.x; i < in_f / 16; i += blockDim.x)
    dst[i] = reinterpret_cast<const int4*>(row)[i];
}

// 16 weight bytes streamed once: not kept in L1, where the codes live.
__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ int word(const int4& v, int i) {
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

// NT n-tiles of 8 code rows (B <= 8 * NT). MODE kRaw writes int32 (and, for
// int4, makes its own corr); kFused applies sx and s_col into T.
template <int BITS, int NT, int MODE, typename T, typename S>
__global__ void __launch_bounds__(kSplit * 32, 2)
a8_mma_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ p,
              const S* __restrict__ s_col, const float* __restrict__ sx,
              const int* __restrict__ corr, void* __restrict__ out_, int B, int in_f,
              int out_f) {
  constexpr bool kOwnCorr = BITS == 4 && MODE == kRaw;
  constexpr int NA = BITS == 8 ? 1 : kOwnCorr ? 3 : 2;  // lo, hi, 8 sum(x_lo)
  constexpr int U = NT == 1 ? kUnroll : kUnroll / 2;
  __shared__ int red[kSplit][NT * NA * 4][32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int k = BITS == 4 ? in_f / 2 : in_f;  // packed bytes a weight row
  const int half = in_f / 2;
  const int o0 = blockIdx.x * kTileRows + g;
  const bool live0 = o0 < out_f, live1 = o0 + 8 < out_f;
  const int8_t* w0 = p + (size_t)(live0 ? o0 : 0) * k + 16 * t;
  const int8_t* w1 = p + (size_t)(live1 ? o0 + 8 : 0) * k + 16 * t;
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
  const int steps = (k + kStep - 1) / kStep;
  for (int s0 = warp; s0 < steps; s0 += kSplit * U) {
    int4 wa[U], wb[U], xl[U][NT], xh[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = (s0 + u * kSplit) * kStep;
      const bool in = c + 16 * t < k;  // k % 16 == 0: a 16-byte chunk is all in or out
      wa[u] = in && live0 ? ld_stream(w0 + c) : zero;
      wb[u] = in && live1 ? ld_stream(w1 + c) : zero;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool x_in = in && xlive[j];
        xl[u][j] = x_in ? __ldg(reinterpret_cast<const int4*>(xr[j] + c)) : zero;
        if (BITS == 4)
          xh[u][j] = x_in ? __ldg(reinterpret_cast<const int4*>(xr[j] + half + c)) : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int m = 0; m < 2; ++m) {  // bytes 8m .. 8m + 7 of each lane's chunk
        const int a0 = word(wa[u], 2 * m), a1 = word(wb[u], 2 * m);
        const int a2 = word(wa[u], 2 * m + 1), a3 = word(wb[u], 2 * m + 1);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int b0 = word(xl[u][j], 2 * m), b1 = word(xl[u][j], 2 * m + 1);
          if (BITS == 8) {
            mma_s8(acc[j][0], a0, a1, a2, a3, b0, b1);
          } else {
            const int ml = 0x0F0F0F0F, mh = (int)0xF0F0F0F0u;
            mma_s8(acc[j][0], a0 & ml, a1 & ml, a2 & ml, a3 & ml, b0, b1);
            mma_s8(acc[j][1], a0 & mh, a1 & mh, a2 & mh, a3 & mh, word(xh[u][j], 2 * m),
                   word(xh[u][j], 2 * m + 1));
            if (kOwnCorr) {
              const int eights = 0x08080808;
              mma_s8(acc[j][NA - 1], eights, eights, eights, eights, b0, b1);
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int i = 0; i < 4; ++i) red[warp][(j * NA + a) * 4 + i][lane] = acc[j][a][i];
  __syncthreads();
  // One thread per (n-tile j, register i, lane): its output element.
  for (int e = threadIdx.x; e < NT * 4 * 32; e += blockDim.x) {
    const int ln = e & 31, j = e >> 7, i = (e >> 5) & 3;
    const int o = blockIdx.x * kTileRows + (ln >> 2) + (i >= 2 ? 8 : 0);
    const int b = 8 * j + 2 * (ln & 3) + (i & 1);
    if (o >= out_f || b >= B) continue;
    int tot[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
      tot[a] = 0;
#pragma unroll
      for (int w = 0; w < kSplit; ++w) tot[a] += red[w][(j * NA + a) * 4 + i][ln];
    }
    int total = tot[0];
    if (BITS == 4) total = (tot[0] - (kOwnCorr ? tot[NA - 1] : corr[b])) + (tot[1] >> 4);
    if (MODE == kRaw) {
      static_cast<int32_t*>(out_)[(size_t)b * out_f + o] = total;
    } else {
      const float y = ((float)total * sx[b]) * to_f32<S>(s_col[o]);
      static_cast<T*>(out_)[(size_t)b * out_f + o] = from_f32<T>(y);
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

template <int MODE, typename T, typename S>
int by_bits(int bits, const void* x, const int8_t* p, const void* s, const void* nw,
            void* out, int B, int in_f, int out_f, float eps, float offset,
            cudaStream_t st) {
  if (B != 1) return (int)cudaErrorInvalidValue;
  if (bits == 4) return launch<1, 4, MODE, T, S>(x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
  return launch<1, 8, MODE, T, S>(x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
}

template <typename T, typename S>
int fused(int norm, int bits, const void* x, const int8_t* p, const void* s,
          const void* nw, void* out, int B, int in_f, int out_f, float eps,
          float offset, cudaStream_t st) {
  if (norm) return by_bits<kFusedNorm, T, S>(bits, x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
  return by_bits<kFused, T, S>(bits, x, p, s, nw, out, B, in_f, out_f, eps, offset, st);
}

template <typename T>
int quantize(int norm, const void* x, const void* nw, int8_t* xq, float* sx, int* corr,
             int B, int in_f, float eps, float offset, cudaStream_t st) {
  const size_t smem = (size_t)in_f * (sizeof(T) + 1);  // the row and its codes
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

template <int BITS, int MODE, typename T, typename S>
int launch_mma(const int8_t* xq, const int8_t* p, const void* s, const float* sx,
               const int* corr, void* out, int B, int in_f, int out_f, cudaStream_t st) {
  if (B < 2 || B > 16) return (int)cudaErrorInvalidValue;
  const int grid = (out_f + kTileRows - 1) / kTileRows;
  const S* sc = static_cast<const S*>(s);
  if (B <= 8)
    a8_mma_kernel<BITS, 1, MODE, T, S><<<grid, kSplit * 32, 0, st>>>(xq, p, sc, sx, corr, out,
                                                                    B, in_f, out_f);
  else
    a8_mma_kernel<BITS, 2, MODE, T, S><<<grid, kSplit * 32, 0, st>>>(xq, p, sc, sx, corr, out,
                                                                    B, in_f, out_f);
  return (int)cudaGetLastError();
}

template <typename T, typename S>
int mma_fused(int bits, const int8_t* xq, const int8_t* p, const void* s, const float* sx,
              const int* corr, void* out, int B, int in_f, int out_f, cudaStream_t st) {
  if (bits == 4) return launch_mma<4, kFused, T, S>(xq, p, s, sx, corr, out, B, in_f, out_f, st);
  return launch_mma<8, kFused, T, S>(xq, p, s, sx, corr, out, B, in_f, out_f, st);
}

}  // namespace

extern "C" {

// B = 1. x: [1, in] bf16 (x_bf16=1) or f32; p: int8 [out, k] (one layer);
// s: [out] f32 or bf16 (s_bf16=1); nw: [in] in x's dtype, or NULL for no
// norm; out: [1, out] in x's dtype. in % 32 == 0 (checked by the caller).
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

// B = 1. xq: int8 [1, in]; p: int8 [out, k]; out: int32 [1, out].
int a8_matvec_raw(const void* xq, const void* p, void* out, int B, int in_f,
                  int out_f, int bits, void* stream) {
  return by_bits<kRaw, float, float>(bits, xq, static_cast<const int8_t*>(p), nullptr,
                                     nullptr, out, B, in_f, out_f, 0.f, 0.f,
                                     static_cast<cudaStream_t>(stream));
}

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

// 2 <= B <= 16, after a8_quantize. xq: int8 [B, in]; p: int8 [out, k]; s:
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

// 2 <= B <= 16. xq: int8 [B, in]; p: int8 [out, k]; out: int32 [B, out].
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
