// Merged post-attention block for W4A8 / W8A8 decode, Hopper (sm_90a): ONE
// cooperative launch per layer.
//
// Replaces metalchat_tpu/ops/ffn_block_pallas.py: ffn_block_stacked
// (_ffn_block_kernel). For rows b < B <= 16:
//   x2  = x + T(wo(attn))                               (phase A)
//   xn  = T(rmsnorm(x2) * (offset + norm_w))            (prologue of phase B)
//   h   = T(act_f32(gate) * up),  [gate | up] = w13(xn) (phase B)
//   out = x2 + T(w2(h))                                 (phase C)
// where every linear is the W4A8/W8A8 matvec of a8_matvec.cu: per-token int8
// act-quant of its input, s8 x s8 -> s32 against the layer's packed weights
// [out, in(/2)], then T(acc * sx * s_col). The activation runs in f32 (silu or
// gelu_tanh), as in the TPU kernel.
//
// What bounds it on the H100: the weight stream of wo, w13 and w2 (out*in/2
// bytes each for int4), as for the separate matvecs. The merged kernel saves
// two launches and the glue kernels between them per layer, not bytes.
// Design: a cooperative persistent kernel, at most as many blocks as can be
// resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), launched
// with cudaLaunchCooperativeKernel. Two grid-wide dependencies sit inside it
// (the norm of x2 needs every wo output, the act-quant of h needs all of F),
// so the phases meet at cooperative_groups::this_grid().sync(). In each
// phase the blocks walk output rows one warp per row (warp_row_dot of
// common.cuh, the int8 codes of the phase's input in shared memory, B*max(H,
// F) bytes). After each sync every block re-reads the whole phase input
// (x2 or h, B rows, from L2 through ld.global.cg) and quantizes it itself
// with a8_matvec's prologue: the blocks reduce in the same order, so all of
// them hold identical codes, and no partial sums cross blocks. The scratch
// x2 and h lives in device memory the wrapper allocates.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

struct Args {
  const void* attn;   // [B, H] in T
  const void* x;      // [B, H] in T
  const int8_t* wo;   // [H, kwo]   (layer l)
  const void* wo_s;   // [H]        in S
  const void* nw;     // [H]        in T
  const int8_t* w13;  // [2F, k13]
  const void* w13_s;  // [2F]
  const int8_t* w2;   // [H, k2]
  const void* w2_s;   // [H]
  void* x2;           // scratch [B, H] in T
  void* h;            // scratch [B, F] in T
  void* out;          // [B, H] in T
  int B, H, F, act;   // act: 0 silu, 1 gelu_tanh
  float eps, offset;
};

__device__ __forceinline__ float activation(float g, int act) {
  if (act == 1) {  // gelu, tanh approximation (PyTorch's constants)
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float cube = g * g * g;
    return 0.5f * g * (1.f + tanhf(kBeta * (g + kKappa * cube)));
  }
  return g / (1.f + expf(-g));  // silu
}

// Codes of B rows of `src` [B][n] into xq [B][n], their sx and int4 correction.
template <typename T, bool NORM, bool COHERENT, int BITS>
__device__ void quantize_rows(const T* src, const T* nw, int B, int n, float eps,
                              float offset, int8_t* xq, float* sx, int* corr,
                              float* scratch, int* iscratch) {
  for (int b = 0; b < B; ++b) {
    int8_t* row = xq + (size_t)b * n;
    quantize_row<T, NORM, COHERENT>(src + (size_t)b * n, nw, n, eps, offset, row, &sx[b],
                                    scratch);
    __syncthreads();
    if (BITS == 4) int4_correction(row, n, &corr[b], iscratch);
  }
  __syncthreads();
}

template <int MAXB, int BITS, typename T, typename S>
__global__ void __launch_bounds__(kThreads) ffn_block_kernel(Args a) {
  extern __shared__ __align__(16) int8_t xq[];  // [B][max(H, F)]
  __shared__ float sx[MAXB];
  __shared__ int corr[MAXB];
  __shared__ float scratch[kWarps];
  __shared__ int iscratch[kWarps];
  cg::grid_group grid = cg::this_grid();

  const int B = a.B, H = a.H, F = a.F;
  const int pack = BITS == 4 ? 2 : 1;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int stride = gridDim.x * kWarps;
  const T* x = static_cast<const T*>(a.x);
  T* x2 = static_cast<T*>(a.x2);
  T* h = static_cast<T*>(a.h);
  T* out = static_cast<T*>(a.out);
  const S* wo_s = static_cast<const S*>(a.wo_s);
  const S* w13_s = static_cast<const S*>(a.w13_s);
  const S* w2_s = static_cast<const S*>(a.w2_s);
  int total[MAXB];

  // Phase A: x2 = x + wo(attn).
  quantize_rows<T, false, false, BITS>(static_cast<const T*>(a.attn), nullptr, B, H, 0.f,
                                       0.f, xq, sx, corr, scratch, iscratch);
  for (int o = first; o < H; o += stride) {
    const float s = to_f32<S>(wo_s[o]);
    warp_row_dot<MAXB, BITS>(a.wo + (size_t)o * (H / pack), xq, H, B, corr,
                             [&](int b, int t) {
      if (lane != 0) return;
      const float y = round_through<T>(((float)t * sx[b]) * s);
      x2[(size_t)b * H + o] = from_f32<T>(to_f32<T>(x[(size_t)b * H + o]) + y);
    });
  }
  grid.sync();

  // Phase B: h = act(gate(xn)) * up(xn), xn the normed x2.
  quantize_rows<T, true, true, BITS>(x2, static_cast<const T*>(a.nw), B, H, a.eps,
                                     a.offset, xq, sx, corr, scratch, iscratch);
  for (int j = first; j < F; j += stride) {
    const float s_g = to_f32<S>(w13_s[j]), s_u = to_f32<S>(w13_s[F + j]);
    warp_row_dot<MAXB, BITS>(a.w13 + (size_t)j * (H / pack), xq, H, B, corr,
                             [&](int b, int t) { total[b] = t; });
    warp_row_dot<MAXB, BITS>(a.w13 + (size_t)(F + j) * (H / pack), xq, H, B, corr,
                             [&](int b, int t) {
      if (lane != 0) return;
      const float gate = ((float)total[b] * sx[b]) * s_g;
      const float up = ((float)t * sx[b]) * s_u;
      h[(size_t)b * F + j] = from_f32<T>(activation(gate, a.act) * up);
    });
  }
  grid.sync();

  // Phase C: out = x2 + w2(h).
  quantize_rows<T, false, true, BITS>(h, nullptr, B, F, 0.f, 0.f, xq, sx, corr, scratch,
                                      iscratch);
  for (int o = first; o < H; o += stride) {
    const float s = to_f32<S>(w2_s[o]);
    warp_row_dot<MAXB, BITS>(a.w2 + (size_t)o * (F / pack), xq, F, B, corr,
                             [&](int b, int t) {
      if (lane != 0) return;
      const float ffn = round_through<T>(((float)t * sx[b]) * s);
      out[(size_t)b * H + o] = from_f32<T>(load_f32<T, true>(x2 + (size_t)b * H + o) + ffn);
    });
  }
}

template <int MAXB, int BITS, typename T, typename S>
int launch(Args a, cudaStream_t stream) {
  auto kernel = ffn_block_kernel<MAXB, BITS, T, S>;
  const size_t smem = (size_t)a.B * (a.H > a.F ? a.H : a.F);
  static size_t configured = 0;
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                                  kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  const int rows = a.H > a.F ? a.H : a.F;  // the widest phase, one warp per row
  int grid = (rows + kWarps - 1) / kWarps;
  if (grid > per_sm * sms) grid = per_sm * sms;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads), args,
                                    smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BITS, typename T, typename S>
int by_rows(Args a, cudaStream_t st) {
  if (a.B == 1) return launch<1, BITS, T, S>(a, st);
  if (a.B <= 4) return launch<4, BITS, T, S>(a, st);
  return launch<16, BITS, T, S>(a, st);
}

template <typename T, typename S>
int by_bits(int bits, Args a, cudaStream_t st) {
  if (bits == 4) return by_rows<4, T, S>(a, st);
  return by_rows<8, T, S>(a, st);
}

}  // namespace

extern "C" {

// attn, x, out: [B, H] bf16 (x_bf16=1) or f32; wo [H, H(/2)], w13 [2F, H(/2)],
// w2 [H, F(/2)] int8 (layer l); wo_s [H], w13_s [2F], w2_s [H] f32 or bf16
// (s_bf16=1); nw [H] in x's dtype; x2 [B, H] and h [B, F] scratch in x's
// dtype. 1 <= B <= 16, H % 32 == 0, F % 32 == 0 (checked by the caller).
int ffn_block(const void* attn, const void* x, const void* wo, const void* wo_s,
              const void* nw, const void* w13, const void* w13_s, const void* w2,
              const void* w2_s, void* x2, void* h, void* out, int B, int H, int F,
              int bits, int act, int x_bf16, int s_bf16, float eps, float offset,
              void* stream) {
  Args a{attn, x, static_cast<const int8_t*>(wo), wo_s, nw,
         static_cast<const int8_t*>(w13), w13_s, static_cast<const int8_t*>(w2), w2_s,
         x2, h, out, B, H, F, act, eps, offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && s_bf16) return by_bits<__nv_bfloat16, __nv_bfloat16>(bits, a, st);
  if (x_bf16) return by_bits<__nv_bfloat16, float>(bits, a, st);
  if (s_bf16) return by_bits<float, __nv_bfloat16>(bits, a, st);
  return by_bits<float, float>(bits, a, st);
}

}  // extern "C"
