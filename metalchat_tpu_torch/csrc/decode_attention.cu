// Decode attention over a dense stacked KV cache for Hopper (sm_90a):
// single-token GQA attention of each batch row over its cache positions,
// with an optional fused write of the new token's K/V row.
//
// Replaces metalchat_tpu/ops/decode_attention_pallas.py:
// * decode_attention_update_quantized_stacked (_decode_update_kernel,
//   _quantize_row): write mode, int8 cache. The TPU kernel folds the new
//   token in at score level because Mosaic could not merge one row into a
//   cache block cheaply; here the block simply writes the row first and,
//   after __syncthreads(), reads the updated cache. The JAX docstring
//   states both orders give the same result.
// * decode_attention_stacked / decode_attention_quantized_stacked
//   (_decode_kernel): read-only mode over a cache the caller has already
//   updated, in the activation dtype (bf16 or f32) or int8 with scales.
//
// What bounds it on the H100: bytes. Each call reads the layer's K and V
// rows in [window_lo, length) (and their f32 scales, int8) once; the
// arithmetic (2*groups*hd flops per position and operand) is far below the
// card's rate. Design (simple first): one block per (batch row, kv head) and
// one warp per query head of its GQA group, so the K/V tile in shared memory
// is shared by the `groups` heads that read it. Tiles of 64 positions are
// staged with 16-byte global loads; the online softmax runs in f32 with the
// k-scale on the scores and the v-scale on the probabilities, as in the TPU
// kernel (a cache without scales uses 1, which is exact). Only B*n_kv blocks
// run (8 at Llama-8B batch 1), so the kernel cannot fill the card; splitting
// the positions across blocks is later work.
#include "common.cuh"

namespace {

constexpr int kTile = 64;

// Four consecutive cache elements (4-byte aligned) as f32.
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  f[0] = (float)c.x; f[1] = (float)c.y; f[2] = (float)c.z; f[3] = (float)c.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  f[0] = __low2float(a); f[1] = __high2float(a); f[2] = __low2float(b); f[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  f[0] = p[0]; f[1] = p[1]; f[2] = p[2]; f[3] = p[3];
}

__device__ __forceinline__ float kv_f32(int8_t v) { return (float)v; }
__device__ __forceinline__ float kv_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float kv_f32(float v) { return v; }

// KV is int8_t (scales ks/vs given; `write` quantizes and stores the new
// row first) or T itself (no scales, read-only).
template <typename T, typename KV, int NACC>
__global__ void decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new, const T* __restrict__ v_new,
    KV* __restrict__ kc, KV* __restrict__ vc, float* __restrict__ ks,
    float* __restrict__ vs, const int32_t* __restrict__ lengths, T* __restrict__ out,
    int nkv, int groups, int t_max, float scale, int window, int write) {
  constexpr int hd = NACC * 32;
  constexpr int kRowBytes = hd * (int)sizeof(KV);
  constexpr int kStride = kRowBytes + 4;  // padded K rows: conflict-free column reads
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                 // [groups][hd]
  float* pv = qs + groups * hd;                               // [groups][kTile]
  float* kst = pv + groups * kTile;                           // [kTile]
  float* vst = kst + kTile;                                   // [kTile]
  unsigned char* vtile = reinterpret_cast<unsigned char*>(vst + kTile);  // [kTile][hd] KV
  unsigned char* ktile = vtile + kTile * kRowBytes;           // [kTile] rows of kStride bytes
  __shared__ float scratch[32];

  const int h = blockIdx.x, b = blockIdx.y;
  const int nh = nkv * groups;
  const size_t bh = (size_t)b * nkv + h;
  KV* kbh = kc + bh * t_max * hd;
  KV* vbh = vc + bh * t_max * hd;
  const bool scaled = ks != nullptr;
  const float* ksbh = scaled ? ks + bh * t_max : nullptr;
  const float* vsbh = scaled ? vs + bh * t_max : nullptr;

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

  // 1. Write mode: quantize and write the new row (in place); the
  // __syncthreads below makes it visible to the whole block.
  if constexpr (sizeof(KV) == 1) {
    if (write) {
      const int pos = length - 1;
      quantize_into<T>(k_new + bh * hd, hd, kbh + (size_t)pos * hd, ks + bh * t_max + pos,
                       scratch);
      quantize_into<T>(v_new + bh * hd, hd, vbh + (size_t)pos * hd, vs + bh * t_max + pos,
                       scratch);
    }
  }
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
    const int chunks = n * kRowBytes / 16;
    const unsigned char* kg = reinterpret_cast<const unsigned char*>(kbh + (size_t)t0 * hd);
    const unsigned char* vg = reinterpret_cast<const unsigned char*>(vbh + (size_t)t0 * hd);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
      const int e = c * 16, row = e / kRowBytes, col = e % kRowBytes;
      const int4 kw = *reinterpret_cast<const int4*>(kg + e);
      const int4 vw = *reinterpret_cast<const int4*>(vg + e);
      int* kd = reinterpret_cast<int*>(ktile + row * kStride + col);
      kd[0] = kw.x; kd[1] = kw.y; kd[2] = kw.z; kd[3] = kw.w;
      *reinterpret_cast<int4*>(vtile + e) = vw;
    }
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      kst[j] = scaled ? ksbh[t0 + j] : 1.f;
      vst[j] = scaled ? vsbh[t0 + j] : 1.f;
    }
    __syncthreads();

    if (g < groups) {
      const float* qg = qs + g * hd;
      float s[2];
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int j = lane + 32 * h2;
        if (j < n) {
          const KV* krow = reinterpret_cast<const KV*>(ktile + j * kStride);
          float dot = 0.f;
#pragma unroll 8
          for (int d = 0; d < hd; d += 4) {
            float kf[4];
            load4(krow + d, kf);
            dot += qg[d] * kf[0];
            dot += qg[d + 1] * kf[1];
            dot += qg[d + 2] * kf[2];
            dot += qg[d + 3] * kf[3];
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
        const KV* vrow = reinterpret_cast<const KV*>(vtile) + j * hd;
#pragma unroll
        for (int a = 0; a < NACC; ++a) acc[a] += pj * kv_f32(vrow[lane + 32 * a]);
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

template <typename T, typename KV, int NACC>
int launch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
           void* vs, const void* lengths, void* out, int B, int nh, int nkv, int t_max,
           float scale, int window, int write, cudaStream_t st) {
  constexpr int hd = NACC * 32;
  const int groups = nh / nkv;
  const size_t smem = sizeof(float) * (groups * hd + groups * kTile + 2 * kTile)
                      + (size_t)kTile * hd * sizeof(KV) + (size_t)kTile * (hd * sizeof(KV) + 4);
  auto kernel = decode_kernel<T, KV, NACC>;
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
      static_cast<KV*>(kc), static_cast<KV*>(vc), static_cast<float*>(ks),
      static_cast<float*>(vs), static_cast<const int32_t*>(lengths), static_cast<T*>(out),
      nkv, groups, t_max, scale, window, write);
  return (int)cudaGetLastError();
}

template <typename T, typename KV>
int by_head_dim(int hd, const void* q, const void* kn, const void* vn, void* kc, void* vc,
                void* ks, void* vs, const void* lengths, void* out, int B, int nh, int nkv,
                int t_max, float scale, int window, int write, cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, KV, 2>(q, kn, vn, kc, vc, ks, vs, lengths, out, B, nh, nkv, t_max, scale, window, write, st);
    case 128: return launch<T, KV, 4>(q, kn, vn, kc, vc, ks, vs, lengths, out, B, nh, nkv, t_max, scale, window, write, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int by_cache_type(int kv_int8, int hd, const void* q, const void* kn, const void* vn,
                  void* kc, void* vc, void* ks, void* vs, const void* lengths, void* out,
                  int B, int nh, int nkv, int t_max, float scale, int window, int write,
                  cudaStream_t st) {
  if (kv_int8)
    return by_head_dim<T, int8_t>(hd, q, kn, vn, kc, vc, ks, vs, lengths, out, B, nh, nkv,
                                  t_max, scale, window, write, st);
  return by_head_dim<T, T>(hd, q, kn, vn, kc, vc, nullptr, nullptr, lengths, out, B, nh,
                           nkv, t_max, scale, window, 0, st);
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
    return by_cache_type<__nv_bfloat16>(1, hd, q, k_new, v_new, kc, vc, ks, vs, lengths, out,
                                        B, nh, nkv, t_max, scale, window, 1, st);
  return by_cache_type<float>(1, hd, q, k_new, v_new, kc, vc, ks, vs, lengths, out, B, nh,
                              nkv, t_max, scale, window, 1, st);
}

// Read-only: the same attention over layer l of a cache the caller has
// already updated. kv_int8: kc/vc int8 with f32 scales ks/vs as above; else
// kc/vc [B, nkv, t_max, hd] in q's dtype and ks/vs unused.
int decode_attention(const void* q, const void* kc, const void* vc, const void* ks,
                     const void* vs, const void* lengths, void* out, int B, int nh, int nkv,
                     int t_max, int hd, float scale, int window, int x_bf16, int kv_int8,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* k = const_cast<void*>(kc);
  void* v = const_cast<void*>(vc);
  void* ksc = const_cast<void*>(ks);
  void* vsc = const_cast<void*>(vs);
  if (x_bf16)
    return by_cache_type<__nv_bfloat16>(kv_int8, hd, q, nullptr, nullptr, k, v, ksc, vsc,
                                        lengths, out, B, nh, nkv, t_max, scale, window, 0, st);
  return by_cache_type<float>(kv_int8, hd, q, nullptr, nullptr, k, v, ksc, vsc, lengths, out,
                              B, nh, nkv, t_max, scale, window, 0, st);
}

}  // extern "C"
