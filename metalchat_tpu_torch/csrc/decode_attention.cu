// Decode attention over a dense stacked KV cache for Hopper (sm_90a):
// single-token GQA attention of each batch row over its cache positions,
// with an optional fused write of the new token's K/V row.
//
// Replaces metalchat_tpu/ops/decode_attention_pallas.py:
// * decode_attention_update_quantized_stacked (_decode_update_kernel,
//   _quantize_row): write mode, int8 cache. The TPU kernel folds the new
//   token in at score level because Mosaic could not merge one row into a
//   cache block cheaply; here the block that holds its position writes the
//   quantized row to the cache and into its own tile, and attends over the
//   tile. The JAX docstring states both orders give the same result.
// * decode_attention_stacked / decode_attention_quantized_stacked
//   (_decode_kernel): read-only mode over a cache the caller has already
//   updated, in the activation dtype (bf16 or f32) or int8 with scales.
//
// What bounds it on the H100: bytes. Each call reads the layer's K and V
// rows in [window_lo, length) (and their f32 scales, int8) once; the
// arithmetic (2*groups*hd flops per position and operand) is far below the
// card's rate. At batch 1 the bytes are a few hundred KB, well under a
// microsecond at HBM rate, so what a call costs is latency: how many SMs
// load at once and how many dependent steps each block takes.
//
// Design (flash-decoding): the positions are split over blocks. The grid is
// (n_split, n_kv, B) with n_split = ceil(t_max / kChunk); the block of chunk
// s covers positions [s * kChunk, (s + 1) * kChunk) and returns at once if
// none of them lies in [window_lo, length). At Llama-8B, batch 1, length 576
// that is 18 live chunks x 8 kv heads = 144 blocks on the 132 SMs, where one
// block per kv head gave 8. A live block stages its chunk of K and V with
// 16-byte loads; the query heads of the GQA group share the chunk, each
// taken by one of the block's 4 warps with one position per lane, the
// k-scale on the scores and the v-scale on the probabilities as in the TPU
// kernel (a cache without scales uses 1, which is exact). Each head's f32
// partials (m, l, acc[hd]) go to a workspace. The last block of a (row, kv
// head) to arrive, counted by an atomic counter that it then resets, merges
// the partials in chunk order
// (common.cuh: live_splits, write_partial, arrive_last, combine_partials):
// one launch per call, reproducible run to run, and capturable in a CUDA
// graph. In write mode only the block whose chunk holds length - 1
// quantizes the new row (warp 0 K, warp 1 V, warp-level reductions) and
// writes it to the cache and to its own tiles, and no other block reads
// that position. Every global load of a phase is issued before any is
// used (the call is a chain of round trips: length and q, the chunk, the
// arrival counter, the partials), and int8 codes become f32 by a byte
// permute instead of the slower int-to-float unit. The chunk body is
// decode_chunk.cuh's, shared with the paged kernel (paged_attention.cu):
// only the address of a position's row differs.
#include "decode_chunk.cuh"

namespace {

// Position t of (batch row b, kv head h) in the dense cache [B, n_kv, t_max,
// hd], and its scales [B, n_kv, t_max]: base + t, base = (b * n_kv + h) * t_max.
struct DenseRows {
  size_t base;
  int c0;  // the chunk's first position
  __device__ size_t row(int, int j) const { return base + c0 + j; }
  __device__ size_t scale(int j) const { return base + c0 + j; }
  __device__ void locate_new(int length, size_t& row, size_t& sc) const {
    row = sc = base + length - 1;
  }
};

template <typename T, typename KV, int NACC>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
              const T* __restrict__ v_new, KV* __restrict__ kc, KV* __restrict__ vc,
              float* __restrict__ ks, float* __restrict__ vs,
              const int32_t* __restrict__ lengths, T* __restrict__ out,
              float* __restrict__ acc_ws, float* __restrict__ ml_ws,
              int* __restrict__ counters, int nkv, int groups, int t_max, float scale,
              int window, int write) {
  const int b = blockIdx.z;
  const int length = lengths[b];
  const DenseRows rows{((size_t)b * nkv + blockIdx.y) * t_max, (int)blockIdx.x * kChunk};
  attend_chunk<T, KV, NACC>(rows, length, t_max, q, k_new, v_new, kc, vc, ks, vs, out, acc_ws,
                            ml_ws, counters, nkv, groups, scale, window, write);
}

template <typename T, typename KV, int NACC>
int launch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
           void* vs, const void* lengths, void* out, void* ws, void* counters, int B, int nh,
           int nkv, int t_max, float scale, int window, int write, cudaStream_t st) {
  constexpr int hd = NACC * 32;
  const int groups = nh / nkv;
  const int n_split = (t_max + kChunk - 1) / kChunk;
  const size_t smem = chunk_smem<KV, NACC>(groups);
  auto kernel = decode_kernel<T, KV, NACC>;
  static size_t configured = 0;
  if (const int err = allow_smem(kernel, smem, configured)) return err;
  float* acc_ws = static_cast<float*>(ws);
  float* ml_ws = acc_ws + (size_t)B * nh * n_split * hd;
  dim3 grid(n_split, nkv, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<KV*>(kc), static_cast<KV*>(vc), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      acc_ws, ml_ws, static_cast<int*>(counters), nkv, groups, t_max, scale, window, write);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int by_head_dim(int hd, const void* q, const void* kn, const void* vn, void* kc, void* vc,
                void* ks, void* vs, const void* lengths, void* out, void* ws, void* counters,
                int B, int nh, int nkv, int t_max, float scale, int window, int write,
                cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, KV, 2>(q, kn, vn, kc, vc, ks, vs, lengths, out, ws, counters, B, nh, nkv, t_max, scale, window, write, st);
    case 128: return launch<T, KV, 4>(q, kn, vn, kc, vc, ks, vs, lengths, out, ws, counters, B, nh, nkv, t_max, scale, window, write, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_cache_type(int kv_int8, int hd, const void* q, const void* kn, const void* vn,
                  void* kc, void* vc, void* ks, void* vs, const void* lengths, void* out,
                  void* ws, void* counters, int B, int nh, int nkv, int t_max, float scale,
                  int window, int write, cudaStream_t st) {
  if (kv_int8)
    return by_head_dim<T, int8_t>(hd, q, kn, vn, kc, vc, ks, vs, lengths, out, ws, counters,
                                  B, nh, nkv, t_max, scale, window, write, st);
  return by_head_dim<T, T>(hd, q, kn, vn, kc, vc, nullptr, nullptr, lengths, out, ws,
                           counters, B, nh, nkv, t_max, scale, window, 0, st);
}

}  // namespace

extern "C" {

// q [B, nh, hd]; k_new/v_new [B, nkv, hd] (bf16 if x_bf16 else f32);
// kc/vc int8 [B, nkv, t_max, hd] and ks/vs f32 [B, nkv, t_max]: layer l of
// the stacked cache, updated in place; lengths int32 [B] include the new
// token; window < 0 means global; out [B, nh, hd]. ws: f32 workspace of
// B * nh * ceil(t_max / chunk) * (hd + 2) values; counters: B * nkv int32,
// zero before the first launch (each launch leaves them zero). chunk must
// be the kernel's kChunk.
int decode_attention_update(const void* q, const void* k_new, const void* v_new, void* kc,
                            void* vc, void* ks, void* vs, const void* lengths, void* out,
                            void* ws, void* counters, int B, int nh, int nkv, int t_max,
                            int hd, int chunk, float scale, int window, int x_bf16,
                            void* stream) {
  if (chunk != kChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return by_cache_type<__nv_bfloat16>(1, hd, q, k_new, v_new, kc, vc, ks, vs, lengths, out,
                                        ws, counters, B, nh, nkv, t_max, scale, window, 1, st);
  return by_cache_type<float>(1, hd, q, k_new, v_new, kc, vc, ks, vs, lengths, out, ws,
                              counters, B, nh, nkv, t_max, scale, window, 1, st);
}

// Read-only: the same attention over layer l of a cache the caller has
// already updated. kv_int8: kc/vc int8 with f32 scales ks/vs as above; else
// kc/vc [B, nkv, t_max, hd] in q's dtype and ks/vs unused.
int decode_attention(const void* q, const void* kc, const void* vc, const void* ks,
                     const void* vs, const void* lengths, void* out, void* ws, void* counters,
                     int B, int nh, int nkv, int t_max, int hd, int chunk, float scale,
                     int window, int x_bf16, int kv_int8, void* stream) {
  if (chunk != kChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* k = const_cast<void*>(kc);
  void* v = const_cast<void*>(vc);
  void* ksc = const_cast<void*>(ks);
  void* vsc = const_cast<void*>(vs);
  if (x_bf16)
    return by_cache_type<__nv_bfloat16>(kv_int8, hd, q, nullptr, nullptr, k, v, ksc, vsc,
                                        lengths, out, ws, counters, B, nh, nkv, t_max, scale,
                                        window, 0, st);
  return by_cache_type<float>(kv_int8, hd, q, nullptr, nullptr, k, v, ksc, vsc, lengths, out,
                              ws, counters, B, nh, nkv, t_max, scale, window, 0, st);
}

}  // extern "C"
