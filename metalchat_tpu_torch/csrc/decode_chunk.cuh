// The chunk body of decode attention split over cache positions
// (flash-decoding), shared by decode_attention.cu (a dense cache: rows 3, 5
// and 6 of the TPU kernels) and paged_attention.cu (a paged pool: rows 7-9).
// One block attends the query heads of one (batch row, kv head) over one
// chunk of kChunk positions, and the last block of the (row, kv head) to
// arrive merges the chunks (see the note at the top of decode_attention.cu).
// The two kernels differ only in where a position's K/V row and its scales
// live. A Rows type says that:
//   size_t row(i, j)   the row index (rows of hd elements) of chunk row j
//                      for this thread's 16-byte staging piece i;
//   size_t scale(j)    the index of chunk row j's scales, for j == threadIdx.x;
//   void locate_new(length, row, scale)   those of position length - 1.
#pragma once

#include "common.cuh"

namespace {

constexpr int kChunk = 32;  // positions a block (ops/decode_attention.py SPLIT_CHUNK)
constexpr int kWarps = 4, kThreads = 32 * kWarps;
static_assert(kChunk == 32 && kChunk <= kThreads, "one position a lane, one scale a thread");

// 16-byte pieces of a chunk's K (or V) rows that each thread stages.
template <typename KV, int NACC> __host__ __device__ constexpr int chunk_vecs() {
  return kChunk * NACC * 32 * (int)sizeof(KV) / 16 / kThreads;
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

// Dynamic shared memory of one block: q as f32, the probabilities, the
// chunk's scales and its V and (padded) K rows.
template <typename KV, int NACC> size_t chunk_smem(int groups) {
  constexpr int hd = NACC * 32;
  return sizeof(float) * (groups * hd + kWarps * kChunk + 2 * kChunk)
         + (size_t)kChunk * hd * sizeof(KV) + (size_t)kChunk * (hd * sizeof(KV) + 4);
}

// The block of grid (split, kv head h, batch row b). KV is int8_t (scales
// ks/vs given; `write` quantizes and stores the new row) or T itself (no
// scales, read-only). `capacity` is the most positions a row can hold.
// Warp w takes query heads w, w + 4, ... of the kv head's group.
template <typename T, typename KV, int NACC, typename Rows>
__device__ __forceinline__ void attend_chunk(
    const Rows& rows, const int length, const int capacity, const T* __restrict__ q,
    const T* __restrict__ k_new, const T* __restrict__ v_new, KV* __restrict__ kc,
    KV* __restrict__ vc, float* __restrict__ ks, float* __restrict__ vs, T* __restrict__ out,
    float* __restrict__ acc_ws, float* __restrict__ ml_ws, int* __restrict__ counters, int nkv,
    int groups, float scale, int window, int write) {
  constexpr int hd = NACC * 32;
  constexpr int kRowBytes = hd * (int)sizeof(KV);
  constexpr int kStride = kRowBytes + 4;  // padded K rows: conflict-free row-per-lane reads
  constexpr int kVecs = chunk_vecs<KV, NACC>();
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
  const bool scaled = ks != nullptr;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // Heads are kv-major: query head h*groups + g shares kv head h.
  const size_t row0 = (size_t)b * nh + (size_t)h * groups;
  const int c0 = split * kChunk;

  // Loads that do not depend on the length are issued beside it: q, and in
  // write mode the new K row (warp 0) and V row (warp 1).
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

  if (length < 1 || length > capacity) {
    // A length outside [1, capacity] is the caller's error. The wrapper
    // cannot raise on it without a host sync, so the cache is left untouched
    // and the row's output is NaN (the plain version raises).
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
  const int j_lo = max(lo - c0, 0), j_hi = min(length - c0, kChunk);
  const int j_new = length - 1 - c0;  // the new row's place, in the writer's chunk
  const bool writer = write && split == sp.hi;

  // 1. Write mode, in the chunk of pos = length - 1 only: quantize the new
  // rows with cache.quantize_kv's op order, write codes and scale to the
  // cache (in place) and straight into this block's tiles.
  if constexpr (sizeof(KV) == 1) {
    if (writer && w < 2) {
      size_t new_row, new_scale;
      rows.locate_new(length, new_row, new_scale);
      float amax = 0.f;
#pragma unroll
      for (int a = 0; a < NACC; ++a) amax = fmaxf(amax, fabsf(nrow[a]));
      amax = warp_max(amax);
      const float sc = amax / 127.f;
      const float inv = sc == 0.f ? 0.f : 1.f / sc;
      int8_t codes[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) codes[a] = quant_code(nrow[a] * inv);
      store_codes((w ? vc : kc) + new_row * hd + lane * NACC, codes);
      store_codes((w ? vtile + j_new * kRowBytes : ktile + j_new * kStride) + lane * NACC,
                  codes);
      if (lane == 0) {
        (w ? vs : ks)[new_scale] = sc;
        (w ? vst : kst)[j_new] = sc;
      }
    }
  }

  // 2. Stage rows [j_lo, j_hi) of the chunk (K padded; the writer's new row
  // is already there) and their scales, every load issued before any store.
  int4 kw[kVecs], vw[kVecs];
  auto staged = [&](int i) {
    const int r = 16 * (threadIdx.x + i * kThreads) / kRowBytes;
    return r >= j_lo && r < j_hi && !(writer && r == j_new);
  };
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    if (staged(i)) {
      const int e = 16 * (threadIdx.x + i * kThreads);
      const size_t off = rows.row(i, e / kRowBytes) * kRowBytes + e % kRowBytes;
      kw[i] = *reinterpret_cast<const int4*>(reinterpret_cast<const unsigned char*>(kc) + off);
      vw[i] = *reinterpret_cast<const int4*>(reinterpret_cast<const unsigned char*>(vc) + off);
    }
  }
  const int js = threadIdx.x;  // kChunk <= kThreads: one scale row a thread
  const bool scale_row = js >= j_lo && js < j_hi && !(writer && js == j_new);
  float k_sc = 1.f, v_sc = 1.f;
  if (scaled && scale_row) {
    k_sc = ks[rows.scale(js)];
    v_sc = vs[rows.scale(js)];
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

// Set a kernel's dynamic shared memory limit once it needs more than 48 KB.
template <typename K> int allow_smem(K kernel, size_t smem, size_t& configured) {
  if (smem <= 48 * 1024 || smem <= configured) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  configured = smem;
  return 0;
}

}  // namespace
