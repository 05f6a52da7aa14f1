// Fused int8-KV decode step for Hopper (sm_90a): quantize the new K/V row,
// write it into the cache in place, then single-token GQA attention.
//
// Replaces metalchat_tpu/ops/decode_attention_pallas.py:
// decode_attention_update_quantized_stacked (_decode_update_kernel,
// _quantize_row). The TPU kernel folds the new token in at score level
// because Mosaic could not merge one row into a cache block cheaply; here
// the block simply writes the row first and, after __syncthreads(), reads
// the updated cache. The JAX docstring states both orders give the same
// result.
//
// What bounds it on the H100: bytes. Each call reads the layer's int8 K and
// V rows in [window_lo, length) and their f32 scales once; the arithmetic
// (2*groups*hd flops per position and operand) is far below the card's
// rate. Design (simple first): one block per (batch row, kv head) and one
// warp per query head of its GQA group, so the K/V tile in shared memory
// is shared by the `groups` heads that read it. Tiles of 64 positions are
// staged with 16-byte global loads; the online softmax runs in f32 with
// the k-scale on the scores and the v-scale on the probabilities, as in
// the TPU kernel. Only B*n_kv blocks run (8 at Llama-8B batch 1), so the
// kernel cannot fill the card; splitting the positions across blocks is
// later work.
#include "common.cuh"

namespace {

constexpr int kTile = 64;

// Quantize one head's new row (hd values) with the op order of
// cache.quantize_kv: scale = absmax/127, inv = 1/scale (0 when scale is 0),
// code = clip(round(x * inv)). Writes codes and scale at position `pos`.
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

template <typename T, int NACC>
__global__ void decode_update_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    int8_t* __restrict__ kc, int8_t* __restrict__ vc, float* __restrict__ ks,
    float* __restrict__ vs, const int32_t* __restrict__ lengths, T* __restrict__ out,
    int nkv, int groups, int t_max, float scale, int window) {
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
  const size_t bh = (size_t)b * nkv + h;
  int8_t* kbh = kc + bh * t_max * hd;
  int8_t* vbh = vc + bh * t_max * hd;
  float* ksbh = ks + bh * t_max;
  float* vsbh = vs + bh * t_max;

  const int length = lengths[b];
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  // Heads are kv-major: query head h*groups + g shares kv head h.
  const T* qh = q + ((size_t)b * nh + (size_t)h * groups) * hd;
  T* o = out + ((size_t)b * nh + (size_t)h * groups + g) * hd;
  if (length < 1 || length > t_max) {
    // A length outside [1, t_max] is the caller's error. The wrapper cannot
    // raise on it without a host sync, so the cache is left untouched and
    // the row's output is NaN (the plain version raises).
    if (g < groups)
#pragma unroll
      for (int a = 0; a < NACC; ++a) o[lane + 32 * a] = from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }
  const int pos = length - 1;

  // 1. Quantize and write the new row (in place), then make it visible.
  quantize_into<T>(k_new + bh * hd, hd, kbh + (size_t)pos * hd, ksbh + pos, scratch);
  quantize_into<T>(v_new + bh * hd, hd, vbh + (size_t)pos * hd, vsbh + pos, scratch);
  for (int i = threadIdx.x; i < groups * hd; i += blockDim.x) qs[i] = to_f32<T>(qh[i]);
  __syncthreads();

  // 2. Attend over [lo, length): kv_pos > (length - 1) - window.
  const int lo = window < 0 ? 0 : max(length - window, 0);
  float m = -INFINITY, l = 0.f, acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = 0.f;

  for (int t0 = lo; t0 < length; t0 += kTile) {
    const int n = min(kTile, length - t0);
    // Stage K (padded rows), V and the scales of this tile.
    const int chunks = n * hd / 16;
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int e = c * 16, row = e / hd, col = e % hd;
      const int4 kw = *reinterpret_cast<const int4*>(kbh + (size_t)t0 * hd + e);
      const int4 vw = *reinterpret_cast<const int4*>(vbh + (size_t)t0 * hd + e);
      int* kd = reinterpret_cast<int*>(ktile + row * kStride + col);
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      *reinterpret_cast<int4*>(vtile + e) = vw;
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      kst[j] = ksbh[t0 + j];
      vst[j] = vsbh[t0 + j];
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
  }

  if (g < groups) {
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int a = 0; a < NACC; ++a) o[lane + 32 * a] = from_f32<T>(acc[a] * l_inv);
  }
}

template <typename T, int NACC>
int launch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
           void* vs, const void* lengths, void* out, int B, int nh, int nkv, int t_max,
           float scale, int window, cudaStream_t st) {
  constexpr int hd = NACC * 32;
  const int groups = nh / nkv;
  const size_t smem = sizeof(float) * (groups * hd + groups * kTile + 2 * kTile)
                      + (size_t)kTile * hd + (size_t)kTile * (hd + 4);
  auto kernel = decode_update_kernel<T, NACC>;
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
      static_cast<int8_t*>(kc), static_cast<int8_t*>(vc), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      nkv, groups, t_max, scale, window);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* kn, const void* vn, void* kc, void* vc,
                void* ks, void* vs, const void* lengths, void* out, int B, int nh, int nkv,
                int t_max, float scale, int window, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 2>(q, kn, vn, kc, vc, ks, vs, lengths, out, B, nh, nkv, t_max, scale, window, st);
    case 128: return launch<T, 4>(q, kn, vn, kc, vc, ks, vs, lengths, out, B, nh, nkv, t_max, scale, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, nh, hd]; k_new/v_new [B, nkv, hd] (bf16 if x_bf16 else f32);
// kc/vc int8 [B, nkv, t_max, hd] and ks/vs f32 [B, nkv, t_max]: layer l of
// the stacked cache, updated in place; lengths int32 [B] include the new
// token; window < 0 means global; out [B, nh, hd].
int decode_attention_update(const void* q, const void* k_new, const void* v_new, void* kc,
                            void* vc, void* ks, void* vs, const void* lengths, void* out,
                            int B, int nh, int nkv, int t_max, int hd, float scale,
                            int window, int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return by_head_dim<__nv_bfloat16>(hd, q, k_new, v_new, kc, vc, ks, vs, lengths, out, B,
                                      nh, nkv, t_max, scale, window, st);
  return by_head_dim<float>(hd, q, k_new, v_new, kc, vc, ks, vs, lengths, out, B, nh, nkv,
                            t_max, scale, window, st);
}

}  // extern "C"
