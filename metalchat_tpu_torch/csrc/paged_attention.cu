// Paged int8-KV decode attention for Hopper (sm_90a), with an optional
// fused write of the new token.
//
// Replaces metalchat_tpu/ops/paged_attention_pallas.py:
//   * paged_decode_attention_update_stacked (_paged_update_kernel): write
//     mode. Quantize the new K/V row, write it into its page, attend.
//   * paged_decode_attention_stacked and paged_decode_attention
//     (_paged_kernel): read-only mode. The one-layer form is the stacked
//     form on a one-layer view.
// The TPU kernel walks a (row, page) grid in order and folds the new token
// in at score level, flushing the page it aliases at the row's end. Here
// the block whose chunk holds the new position writes the quantized row to
// its page and into its own tiles, as the dense kernel in decode_attention.cu
// does; the JAX docstring states both orders give the same result.
//
// What bounds it on the H100: bytes. A call reads each row's int8 K and V
// rows in [window_lo, length), found through the page table, and their f32
// scales once; the arithmetic (2*groups*hd flops per position and operand)
// is far below the card's rate. At 8 rows the bytes are a few hundred KB a
// call, under a microsecond at HBM rate, so what a call costs is how many
// SMs load at once and how many dependent round trips each block takes.
//
// Design (flash-decoding, as decode_attention.cu): the positions are split
// over blocks. The grid is (n_split, n_kv, B) with n_split = ceil(MP * psize
// / kChunk); the block of chunk s covers positions [s * kChunk, (s + 1) *
// kChunk) and returns at once if none of them lies in [window_lo, length)
// (live_splits). A chunk may cross pages (pages of 4, 8, 16 or 48 positions
// as well as 256): every staged row finds its physical page through the
// table by its position, and the block loads the table entries of its
// chunk beside the length, so they cost no round trip of their own. Rows
// are staged with 16-byte loads inside one row of a page. The query heads of
// the GQA group share the chunk, each taken by one of the block's 4 warps
// with one position per lane, the k-scale on the scores and the v-scale on
// the probabilities as in the TPU kernel. Each head's f32 partials (m, l,
// acc[hd]) go to a workspace; the last block of a (row, kv head) to arrive,
// counted by an atomic counter that it then resets, merges them in chunk
// order (common.cuh: live_splits, write_partial, arrive_last,
// combine_partials): one launch per call, reproducible run to run, and
// capturable in a CUDA graph. In write mode only the block whose chunk
// holds length - 1 quantizes the new row (warp 0 K, warp 1 V,
// cache.quantize_kv's op order) and writes it to its page and to its own
// tiles; no other block reads that position. The chunk body is
// decode_chunk.cuh's, shared with the dense kernel: PagedRows gives it the
// address of each position's row.
//
// The garbage page is shared: every row whose table entry at its write
// position is the sentinel writes there in the same launch, and the blocks
// race. Such a row's output is undefined (the engine discards it); live
// rows never share a page, so their pages and outputs are exact.
#include "decode_chunk.cuh"

namespace {

// Physical page of logical page `i` of a row: table entries are clamped
// into the pool, so the sentinel (the last page) stays in bounds.
__device__ __forceinline__ int physical_page(const int32_t* __restrict__ pt_row, int i,
                                             int num_pages) {
  return min(max(__ldg(pt_row + i), 0), num_pages - 1);
}

// Position t of (batch row b, kv head h) in one layer of the pool: K/V rows
// [n_kv, num_pages, psize, hd], scales [num_pages, n_kv, psize], on page
// pt[b, t / psize] at t % psize. The table entries of this thread's staged
// rows and of its scale row are loaded when it is made, beside the length.
template <int kVecs, int kRowBytes>
struct PagedRows {
  const int32_t* pt_row;
  int h, nkv, num_pages, psize, c0;
  int page[kVecs];  // the page of each of this thread's 16-byte pieces
  int spage;        // the page of its scale row (threadIdx.x < kChunk)
  __device__ PagedRows(const int32_t* pt_row_, int h_, int nkv_, int num_pages_, int psize_,
                       int mp, int c0_)
      : pt_row(pt_row_), h(h_), nkv(nkv_), num_pages(num_pages_), psize(psize_), c0(c0_) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int t = c0 + 16 * ((int)threadIdx.x + i * kThreads) / kRowBytes;
      page[i] = physical_page(pt_row, min(t / psize, mp - 1), num_pages);
    }
    spage = physical_page(pt_row, min((c0 + (int)threadIdx.x) / psize, mp - 1), num_pages);
  }
  __device__ size_t row(int i, int j) const {
    return ((size_t)h * num_pages + page[i]) * psize + (c0 + j) % psize;
  }
  __device__ size_t scale(int j) const {
    return ((size_t)spage * nkv + h) * psize + (c0 + j) % psize;
  }
  __device__ void locate_new(int length, size_t& row, size_t& sc) const {
    const int pg = physical_page(pt_row, (length - 1) / psize, num_pages);
    row = ((size_t)h * num_pages + pg) * psize + (length - 1) % psize;
    sc = ((size_t)pg * nkv + h) * psize + (length - 1) % psize;
  }
};

// kp/vp int8 [n_kv, num_pages, psize, hd] and ks/vs f32 [num_pages, n_kv,
// psize] are one layer of the stacked pool, updated in place in write mode.
template <typename T, int NACC>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
             const T* __restrict__ v_new, int8_t* __restrict__ kp, int8_t* __restrict__ vp,
             float* __restrict__ ks, float* __restrict__ vs, const int32_t* __restrict__ pt,
             const int32_t* __restrict__ lengths, T* __restrict__ out,
             float* __restrict__ acc_ws, float* __restrict__ ml_ws, int* __restrict__ counters,
             int nkv, int groups, int num_pages, int psize, int mp, float scale, int window,
             int write) {
  const int b = blockIdx.z;
  const int length = lengths[b];
  const PagedRows<chunk_vecs<int8_t, NACC>(), NACC * 32> rows(
      pt + (size_t)b * mp, blockIdx.y, nkv, num_pages, psize, mp, blockIdx.x * kChunk);
  attend_chunk<T, int8_t, NACC>(rows, length, mp * psize, q, k_new, v_new, kp, vp, ks, vs, out,
                                acc_ws, ml_ws, counters, nkv, groups, scale, window, write);
}

template <typename T, int NACC>
int launch(const void* q, const void* kn, const void* vn, void* kp, void* vp, void* ks,
           void* vs, const void* pt, const void* lengths, void* out, void* ws, void* counters,
           int B, int nh, int nkv, int num_pages, int psize, int mp, float scale, int window,
           int write, cudaStream_t st) {
  constexpr int hd = NACC * 32;
  const int groups = nh / nkv;
  const int n_split = (mp * psize + kChunk - 1) / kChunk;
  const size_t smem = chunk_smem<int8_t, NACC>(groups);
  auto kernel = paged_kernel<T, NACC>;
  static size_t configured = 0;
  if (const int err = allow_smem(kernel, smem, configured)) return err;
  float* acc_ws = static_cast<float*>(ws);
  float* ml_ws = acc_ws + (size_t)B * nh * n_split * hd;
  dim3 grid(n_split, nkv, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<int8_t*>(kp), static_cast<int8_t*>(vp), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), acc_ws, ml_ws,
      static_cast<int*>(counters), nkv, groups, num_pages, psize, mp, scale, window, write);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* kn, const void* vn, void* kp, void* vp,
                void* ks, void* vs, const void* pt, const void* lengths, void* out, void* ws,
                void* counters, int B, int nh, int nkv, int num_pages, int psize, int mp,
                float scale, int window, int write, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 2>(q, kn, vn, kp, vp, ks, vs, pt, lengths, out, ws, counters, B, nh,
                          nkv, num_pages, psize, mp, scale, window, write, st);
    case 128:
      return launch<T, 4>(q, kn, vn, kp, vp, ks, vs, pt, lengths, out, ws, counters, B, nh,
                          nkv, num_pages, psize, mp, scale, window, write, st);
    case 256:
      return launch<T, 8>(q, kn, vn, kp, vp, ks, vs, pt, lengths, out, ws, counters, B, nh,
                          nkv, num_pages, psize, mp, scale, window, write, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, nh, hd]; k_new/v_new [B, nkv, hd] (bf16 if x_bf16 else f32; unused
// and may be null when write is 0); kp/vp int8 [nkv, num_pages, psize, hd]
// and ks/vs f32 [num_pages, nkv, psize]: one layer of the stacked pool,
// updated in place when write is 1; pt int32 [B, mp]; lengths int32 [B]
// include the new token; window < 0 means global; out [B, nh, hd]. ws: f32
// workspace of B * nh * ceil(mp * psize / chunk) * (hd + 2) values;
// counters: B * nkv int32, zero before the first launch (each launch leaves
// them zero). chunk must be the kernel's kChunk.
int paged_attention(const void* q, const void* k_new, const void* v_new, void* kp, void* vp,
                    void* ks, void* vs, const void* pt, const void* lengths, void* out,
                    void* ws, void* counters, int B, int nh, int nkv, int num_pages, int psize,
                    int mp, int hd, int chunk, float scale, int window, int write, int x_bf16,
                    void* stream) {
  if (chunk != kChunk) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return by_head_dim<__nv_bfloat16>(hd, q, k_new, v_new, kp, vp, ks, vs, pt, lengths, out,
                                      ws, counters, B, nh, nkv, num_pages, psize, mp, scale,
                                      window, write, st);
  return by_head_dim<float>(hd, q, k_new, v_new, kp, vp, ks, vs, pt, lengths, out, ws,
                            counters, B, nh, nkv, num_pages, psize, mp, scale, window, write,
                            st);
}

}  // extern "C"
