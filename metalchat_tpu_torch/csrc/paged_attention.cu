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
// in at score level, flushing the page it aliases at the row's end. Here a
// block writes the row first and, after __syncthreads(), reads the updated
// pages, as the dense kernel in decode_attention.cu does.
//
// What bounds it on the H100: bytes. A call reads each row's int8 K and V
// rows in [window_lo, length), found through the page table, and their f32
// scales once; the arithmetic (2*groups*hd flops per position and operand)
// is far below the card's rate. Design (simple first): one block per (batch
// row, kv head), one warp per query head of its GQA group. Positions are
// staged in tiles of up to 64 that never cross a page, so each tile is one
// contiguous run of rows in one physical page, loaded 16 bytes a thread.
// Online softmax in f32, k-scale on the scores and v-scale on the
// probabilities, 1/l guarded at l == 0, as in the TPU kernel. B*n_kv blocks
// (64 at Llama-8B with 8 slots) cannot fill the card; splitting the pages
// across blocks and moving the dots onto tensor cores is later work.
//
// The garbage page is shared: every row whose table entry at its write
// position is the sentinel writes there in the same launch, and the blocks
// race. Such a row's output is undefined (the engine discards it); live
// rows never share a page, so their pages and outputs are exact.
#include "common.cuh"

namespace {

constexpr int kTile = 64;

// Physical page of logical page `i` of a row: table entries are clamped
// into the pool, so the sentinel (the last page) stays in bounds.
__device__ __forceinline__ int physical_page(const int32_t* __restrict__ pt_row, int i,
                                             int num_pages) {
  return min(max(pt_row[i], 0), num_pages - 1);
}

// kp/vp int8 [n_kv, num_pages, psize, hd] and ks/vs f32 [num_pages, n_kv,
// psize] are one layer of the stacked pool. They carry no __restrict__: the
// block writes the new row through them and then reads it back.
template <typename T, int NACC>
__global__ void paged_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    int8_t* kp, int8_t* vp, float* ks, float* vs, const int32_t* __restrict__ pt,
    const int32_t* __restrict__ lengths, T* __restrict__ out, int nkv, int groups,
    int num_pages, int psize, int mp, float scale, int window, int write) {
  constexpr int hd = NACC * 32;
  constexpr int kStride = hd + 4;  // padded K rows: conflict-free column reads
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                 // [groups][hd]
  float* pv = qs + groups * hd;                               // [groups][kTile]
  float* kst = pv + groups * kTile;                           // [kTile]
  float* vst = kst + kTile;                                   // [kTile]
  int8_t* vtile = reinterpret_cast<int8_t*>(vst + kTile);     // [kTile][hd]
  int8_t* ktile = vtile + kTile * hd;                         // [kTile][kStride]
  __shared__ float scratch[32];

  const int h = blockIdx.x, b = blockIdx.y;
  const int nh = nkv * groups;
  const int length = lengths[b];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int32_t* pt_row = pt + (size_t)b * mp;
  // Heads are kv-major: query head h*groups + g shares kv head h.
  const T* qh = q + ((size_t)b * nh + (size_t)h * groups) * hd;
  T* o = out + ((size_t)b * nh + (size_t)h * groups + g) * hd;
  if (length < 1 || length > mp * psize) {
    // A length outside [1, mp*psize] is the caller's error. The wrapper
    // cannot raise on it without a host sync, so the pages are left
    // untouched and the row's output is NaN (the plain version raises).
    if (g < groups)
#pragma unroll
      for (int a = 0; a < NACC; ++a) o[lane + 32 * a] = from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }

  // 1. Write mode: quantize the new row into page pt[b, pos / psize] at
  //    pos % psize (pos = length - 1), in place, then make it visible.
  if (write) {
    const int pos = length - 1;
    const int page = physical_page(pt_row, pos / psize, num_pages), off = pos % psize;
    const size_t bh = (size_t)b * nkv + h;
    const size_t row = ((size_t)h * num_pages + page) * psize + off;
    const size_t srow = ((size_t)page * nkv + h) * psize + off;
    quantize_into<T>(k_new + bh * hd, hd, kp + row * hd, ks + srow, scratch);
    quantize_into<T>(v_new + bh * hd, hd, vp + row * hd, vs + srow, scratch);
  }
  for (int i = threadIdx.x; i < groups * hd; i += blockDim.x) qs[i] = to_f32<T>(qh[i]);
  __syncthreads();

  // 2. Attend over [lo, length): kv_pos > (length - 1) - window.
  const int lo = window < 0 ? 0 : max(length - window, 0);
  float m = -INFINITY, l = 0.f, acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = 0.f;

  for (int t0 = lo; t0 < length;) {
    const int in_page = t0 % psize;
    const int n = min(min(kTile, length - t0), psize - in_page);
    const int page = physical_page(pt_row, t0 / psize, num_pages);
    const size_t row0 = ((size_t)h * num_pages + page) * psize + in_page;
    const int8_t* kbase = kp + row0 * hd;
    const int8_t* vbase = vp + row0 * hd;
    const float* ksb = ks + ((size_t)page * nkv + h) * psize + in_page;
    const float* vsb = vs + ((size_t)page * nkv + h) * psize + in_page;
    // Stage K (padded rows), V and the scales of this tile.
    const int chunks = n * hd / 16;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int e = c * 16, r = e / hd, col = e % hd;
      const int4 kw = *reinterpret_cast<const int4*>(kbase + e);
      const int4 vw = *reinterpret_cast<const int4*>(vbase + e);
      int* kd = reinterpret_cast<int*>(ktile + r * kStride + col);
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      *reinterpret_cast<int4*>(vtile + e) = vw;
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      kst[j] = ksb[j];
      vst[j] = vsb[j];
    }
    __syncthreads();

    if (g < groups) {
      const float* qg = qs + g * hd;
      float s[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = lane + 32 * h2;
        if (j < n) {
          const int8_t* krow = ktile + j * kStride;
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < hd; d += 4) {
            const char4 kv4 = *reinterpret_cast<const char4*>(krow + d);
            dot += qg[d] * (float)kv4.x;
            dot += qg[d + 1] * (float)kv4.y;
            dot += qg[d + 2] * (float)kv4.z;
            dot += qg[d + 3] * (float)kv4.w;
          }
          s[h2] = (dot * scale) * kst[j];
        } else {
          s[h2] = MC_MASK_VALUE;
        }
      }
      const float m_next = fmaxf(m, warp_max(fmaxf(s[0], s[1])));
      const float alpha = expf(m - m_next);
      const float p0 = lane < n ? expf(s[0] - m_next) : 0.f;
      const float p1 = lane + 32 < n ? expf(s[1] - m_next) : 0.f;
      l = alpha * l + warp_sum(p0 + p1);
      m = m_next;
      float* pg = pv + g * kTile;
      pg[lane] = p0 * (lane < n ? vst[lane] : 0.f);
      pg[lane + 32] = p1 * (lane + 32 < n ? vst[lane + 32] : 0.f);
      __syncwarp();
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[a] *= alpha;
      for (int j = 0; j < n; ++j) {
        const float pj = pg[j];
        const int8_t* vrow = vtile + j * hd;
#pragma unroll
        for (int a = 0; a < NACC; ++a) acc[a] += pj * (float)vrow[lane + 32 * a];
      }
    }
    __syncthreads();
    t0 += n;
  }

  if (g < groups) {
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int a = 0; a < NACC; ++a) o[lane + 32 * a] = from_f32<T>(acc[a] * l_inv);
  }
}

template <typename T, int NACC>
int launch(const void* q, const void* kn, const void* vn, void* kp, void* vp, void* ks,
           void* vs, const void* pt, const void* lengths, void* out, int B, int nh, int nkv,
           int num_pages, int psize, int mp, float scale, int window, int write,
           cudaStream_t st) {
  constexpr int hd = NACC * 32;
  const int groups = nh / nkv;
  const size_t smem = sizeof(float) * (groups * hd + groups * kTile + 2 * kTile)
                      + (size_t)kTile * hd + (size_t)kTile * (hd + 4);
  auto kernel = paged_kernel<T, NACC>;
  static size_t configured = 0;
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  dim3 grid(nkv, B);
  kernel<<<grid, 32 * groups, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(kn), static_cast<const T*>(vn),
      static_cast<int8_t*>(kp), static_cast<int8_t*>(vp), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(lengths), static_cast<T*>(out), nkv, groups, num_pages,
      psize, mp, scale, window, write);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* kn, const void* vn, void* kp, void* vp,
                void* ks, void* vs, const void* pt, const void* lengths, void* out, int B,
                int nh, int nkv, int num_pages, int psize, int mp, float scale, int window,
                int write, cudaStream_t st) {
  switch (hd) {
    case 64:
      return launch<T, 2>(q, kn, vn, kp, vp, ks, vs, pt, lengths, out, B, nh, nkv,
                          num_pages, psize, mp, scale, window, write, st);
    case 128:
      return launch<T, 4>(q, kn, vn, kp, vp, ks, vs, pt, lengths, out, B, nh, nkv,
                          num_pages, psize, mp, scale, window, write, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, nh, hd]; k_new/v_new [B, nkv, hd] (bf16 if x_bf16 else f32; unused
// and may be null when write is 0); kp/vp int8 [nkv, num_pages, psize, hd]
// and ks/vs f32 [num_pages, nkv, psize]: one layer of the stacked pool,
// updated in place when write is 1; pt int32 [B, mp]; lengths int32 [B]
// include the new token; window < 0 means global; out [B, nh, hd].
int paged_attention(const void* q, const void* k_new, const void* v_new, void* kp, void* vp,
                    void* ks, void* vs, const void* pt, const void* lengths, void* out, int B,
                    int nh, int nkv, int num_pages, int psize, int mp, int hd, float scale,
                    int window, int write, int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return by_head_dim<__nv_bfloat16>(hd, q, k_new, v_new, kp, vp, ks, vs, pt, lengths, out,
                                      B, nh, nkv, num_pages, psize, mp, scale, window, write,
                                      st);
  return by_head_dim<float>(hd, q, k_new, v_new, kp, vp, ks, vs, pt, lengths, out, B, nh, nkv,
                            num_pages, psize, mp, scale, window, write, st);
}

}  // extern "C"
