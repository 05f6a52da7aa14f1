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
// permute instead of the slower int-to-float unit.
#include "common.cuh"

namespace {

constexpr int kChunk = 32;  // positions a block (ops/decode_attention.py SPLIT_CHUNK)

// Signed byte i of w as f32, exactly, without the int-to-float unit (a
// quarter of the FMA rate on Hopper): with the sign bit flipped the byte is
// b + 128, placed in the low mantissa of 2^23 by a byte permute, and one
// subtraction leaves b.
__device__ __forceinline__ float s8_at(uint32_t w_biased, int i) {
  return __int_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7440 + i)) - 8388736.f;
}

// Four consecutive cache elements (4-byte aligned) as f32.
__device__ __forceinline__ void load4(const int8_t* p, float* f) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p) ^ 0x80808080u;
  f[0] = s8_at(w, 0); f[1] = s8_at(w, 1); f[2] = s8_at(w, 2); f[3] = s8_at(w, 3);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(p + 2);
  f[0] = __low2float(a); f[1] = __high2float(a); f[2] = __low2float(b); f[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const float* p, float* f) {
  f[0] = p[0]; f[1] = p[1]; f[2] = p[2]; f[3] = p[3];
}

// NACC consecutive cache elements, aligned to their size, in one access.
__device__ __forceinline__ void load_kv(const int8_t* p, float (&f)[2]) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
  f[0] = s8_at(w, 0); f[1] = s8_at(w, 1);
}
__device__ __forceinline__ void load_kv(const int8_t* p, float (&f)[4]) { load4(p, f); }
__device__ __forceinline__ void load_kv(const __nv_bfloat16* p, float (&f)[2]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  f[0] = __low2float(a); f[1] = __high2float(a);
}
__device__ __forceinline__ void load_kv(const __nv_bfloat16* p, float (&f)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  f[0] = __low2float(a); f[1] = __high2float(a); f[2] = __low2float(b); f[3] = __high2float(b);
}
__device__ __forceinline__ void load_kv(const float* p, float (&f)[2]) {
  const float2 x = *reinterpret_cast<const float2*>(p);
  f[0] = x.x; f[1] = x.y;
}
__device__ __forceinline__ void load_kv(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}

// NACC int8 codes to global or shared memory in one access.
__device__ __forceinline__ void store_codes(void* p, const int8_t (&c)[2]) {
  *reinterpret_cast<char2*>(p) = make_char2(c[0], c[1]);
}
__device__ __forceinline__ void store_codes(void* p, const int8_t (&c)[4]) {
  *reinterpret_cast<char4*>(p) = make_char4(c[0], c[1], c[2], c[3]);
}

constexpr int kWarps = 4, kThreads = 32 * kWarps;
static_assert(kChunk == 32 && kChunk <= kThreads, "one position a lane, one scale a thread");

// KV is int8_t (scales ks/vs given; `write` quantizes and stores the new
// row) or T itself (no scales, read-only). Warp w takes query heads w,
// w + 4, ... of the kv head's group.
template <typename T, typename KV, int NACC>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
              const T* __restrict__ v_new, KV* __restrict__ kc, KV* __restrict__ vc,
              float* __restrict__ ks, float* __restrict__ vs,
              const int32_t* __restrict__ lengths, T* __restrict__ out,
              float* __restrict__ acc_ws, float* __restrict__ ml_ws,
              int* __restrict__ counters, int nkv, int groups, int t_max, float scale,
              int window, int write) {
  constexpr int hd = NACC * 32;
  constexpr int kRowBytes = hd * (int)sizeof(KV);
  constexpr int kStride = kRowBytes + 4;  // padded K rows: conflict-free row-per-lane reads
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);                 // [groups][hd]
  float* pv = qs + groups * hd;                               // [kWarps][kChunk]
  float* kst = pv + kWarps * kChunk;                          // [kChunk]
  float* vst = kst + kChunk;                                  // [kChunk]
  unsigned char* vtile = reinterpret_cast<unsigned char*>(vst + kChunk);  // [kChunk][hd] KV
  unsigned char* ktile = vtile + kChunk * kRowBytes;          // [kChunk] rows of kStride bytes
  __shared__ int last_flag;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int nh = nkv * groups;
  const size_t bh = (size_t)b * nkv + h;
  KV* kbh = kc + bh * t_max * hd;
  KV* vbh = vc + bh * t_max * hd;
  const bool scaled = ks != nullptr;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // Heads are kv-major: query head h*groups + g shares kv head h.
  const size_t row0 = (size_t)b * nh + (size_t)h * groups;

  // Loads that do not depend on the length are issued beside it: q, and in
  // write mode the new K row (warp 0) and V row (warp 1).
  const int length = lengths[b];
  float nrow[NACC];
  if (write && w < 2) {
    const T* src = (w ? v_new : k_new) + bh * hd + lane * NACC;
#pragma unroll
    for (int a = 0; a < NACC; ++a) nrow[a] = to_f32<T>(src[a]);
  }
  const T* qrow = q + row0 * hd;
  if (reinterpret_cast<uintptr_t>(qrow) % 16 == 0) {
    constexpr int kQVec = 16 / sizeof(T);
    for (int c = threadIdx.x; c < groups * hd / kQVec; c += kThreads) {
      const int4 raw = reinterpret_cast<const int4*>(qrow)[c];
      const T* x = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kQVec; ++i) qs[c * kQVec + i] = to_f32<T>(x[i]);
    }
  } else {
    for (int i = threadIdx.x; i < groups * hd; i += kThreads) qs[i] = to_f32<T>(qrow[i]);
  }

  if (length < 1 || length > t_max) {
    // A length outside [1, t_max] is the caller's error. The wrapper cannot
    // raise on it without a host sync, so the cache is left untouched and
    // the row's output is NaN (the plain version raises).
    if (split == 0)
      for (int g = w; g < groups; g += kWarps)
#pragma unroll
        for (int a = 0; a < NACC; ++a)
          out[(row0 + g) * hd + lane + 32 * a] = from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }
  // Attend over [lo, length): kv_pos > (length - 1) - window.
  const int lo = window < 0 ? 0 : max(length - window, 0);
  const SplitSpan sp = live_splits(lo, length, kChunk);
  if (split < sp.lo || split > sp.hi) return;
  const int c0 = split * kChunk;
  const int j_lo = max(lo - c0, 0), j_hi = min(length - c0, kChunk);
  const int j_new = length - 1 - c0;  // the new row's place, in the writer's chunk
  const bool writer = write && split == sp.hi;

  // 1. Write mode, in the chunk of pos = length - 1 only: quantize the new
  // rows with cache.quantize_kv's op order, write codes and scale to the
  // cache (in place) and straight into this block's tiles.
  if constexpr (sizeof(KV) == 1) {
    if (writer && w < 2) {
      float amax = 0.f;
#pragma unroll
      for (int a = 0; a < NACC; ++a) amax = fmaxf(amax, fabsf(nrow[a]));
      amax = warp_max(amax);
      const float sc = amax / 127.f;
      const float inv = sc == 0.f ? 0.f : 1.f / sc;
      int8_t codes[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) codes[a] = quant_code(nrow[a] * inv);
      store_codes((w ? vbh : kbh) + (size_t)(length - 1) * hd + lane * NACC, codes);
      store_codes((w ? vtile + j_new * kRowBytes : ktile + j_new * kStride) + lane * NACC,
                  codes);
      if (lane == 0) {
        (w ? vs : ks)[bh * t_max + length - 1] = sc;
        (w ? vst : kst)[j_new] = sc;
      }
    }
  }

  // 2. Stage rows [j_lo, j_hi) of the chunk (K padded; the writer's new row
  // is already there) and their scales.
  const unsigned char* kg = reinterpret_cast<const unsigned char*>(kbh + (size_t)c0 * hd);
  const unsigned char* vg = reinterpret_cast<const unsigned char*>(vbh + (size_t)c0 * hd);
  constexpr int kVecs = kChunk * kRowBytes / 16 / kThreads;  // 16-byte pieces a thread
  int4 kw[kVecs], vw[kVecs];
  auto staged = [&](int i) {
    const int r = 16 * (threadIdx.x + i * kThreads) / kRowBytes;
    return r >= j_lo && r < j_hi && !(writer && r == j_new);
  };
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (staged(i)) {
      const int e = 16 * (threadIdx.x + i * kThreads);
      kw[i] = *reinterpret_cast<const int4*>(kg + e);
      vw[i] = *reinterpret_cast<const int4*>(vg + e);
    }
  }
  const int js = j_lo + threadIdx.x;  // kChunk <= kThreads: one scale row a thread
  const bool scale_row = js < j_hi && !(writer && js == j_new);
  float k_sc = 1.f, v_sc = 1.f;
  if (scaled && scale_row) {
    k_sc = ks[bh * t_max + c0 + js];
    v_sc = vs[bh * t_max + c0 + js];
  }
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (staged(i)) {
      const int e = 16 * (threadIdx.x + i * kThreads);
      int* kd = reinterpret_cast<int*>(ktile + (e / kRowBytes) * kStride + e % kRowBytes);
      kd[0] = kw[i].x; kd[1] = kw[i].y; kd[2] = kw[i].z; kd[3] = kw[i].w;
      *reinterpret_cast<int4*>(vtile + e) = vw[i];
    }
  }
  if (scale_row) {
    kst[js] = k_sc;
    vst[js] = v_sc;
  }
  __syncthreads();

  // 3. Each query head over the chunk, one position per lane.
  const bool valid = lane >= j_lo && lane < j_hi;
  const KV* krow = reinterpret_cast<const KV*>(ktile + lane * kStride);
  float* pg = pv + w * kChunk;
  for (int g = w; g < groups; g += kWarps) {
    float s = -INFINITY;
    if (valid) {
      const float* qg = qs + g * hd;
      float dot[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 8
      for (int d = 0; d < hd; d += 4) {
        float kf[4];
        load4(krow + d, kf);
        const float4 qv = *reinterpret_cast<const float4*>(qg + d);
        dot[0] += qv.x * kf[0];
        dot[1] += qv.y * kf[1];
        dot[2] += qv.z * kf[2];
        dot[3] += qv.w * kf[3];
      }
      s = (((dot[0] + dot[1]) + (dot[2] + dot[3])) * scale) * kst[lane];
    }
    const float m = warp_max(s);
    const float p = valid ? expf(s - m) : 0.f;
    const float l = warp_sum(p);
    __syncwarp();  // the previous head's reads of pg are done
    pg[lane] = valid ? p * vst[lane] : 0.f;
    __syncwarp();
    float acc[NACC];
#pragma unroll
    for (int a = 0; a < NACC; ++a) acc[a] = 0.f;
#pragma unroll 8
    for (int j = j_lo; j < j_hi; ++j) {
      const float pj = pg[j];
      float vf[NACC];
      load_kv(reinterpret_cast<const KV*>(vtile) + j * hd + lane * NACC, vf);
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[a] += pj * vf[a];
    }
    write_partial<NACC>(acc_ws, ml_ws, (row0 + g) * n_split + split, acc, m, l);
  }

  // 4. The last chunk of this (row, kv head) to finish merges them all.
  if (!arrive_last(counters + bh, sp.hi - sp.lo + 1, &last_flag)) return;
  for (int g = w; g < groups; g += kWarps)
    combine_partials<T, NACC>(acc_ws, ml_ws, row0 + g, n_split, sp, out + (row0 + g) * hd);
}

template <typename T, typename KV, int NACC>
int launch(const void* q, const void* kn, const void* vn, void* kc, void* vc, void* ks,
           void* vs, const void* lengths, void* out, void* ws, void* counters, int B, int nh,
           int nkv, int t_max, float scale, int window, int write, cudaStream_t st) {
  constexpr int hd = NACC * 32;
  const int groups = nh / nkv;
  const int n_split = (t_max + kChunk - 1) / kChunk;
  const size_t smem = sizeof(float) * (groups * hd + kWarps * kChunk + 2 * kChunk)
                      + (size_t)kChunk * hd * sizeof(KV)
                      + (size_t)kChunk * (hd * sizeof(KV) + 4);
  auto kernel = decode_kernel<T, KV, NACC>;
  static size_t configured = 0;
  if (smem > 48 * 1024 && smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
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
