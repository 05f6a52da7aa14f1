// Causal prefill flash attention for Hopper (sm_90a).
//
// Replaces metalchat_tpu/ops/flash_attention_pallas.py: flash_attention
// (_flash_kernel). S new queries starting at start_pos (per batch row)
// attend over the head-major cache [B, n_kv, T, hd], causal, with an
// optional sliding window; f32 online softmax statistics.
//
// What bounds it on the H100: at prefill lengths the work is
// 4*hd*(visible keys) operations per query row, which the tensor cores could
// do far faster than this kernel's CUDA-core f32 loop; bytes (q, k, v, out
// read or written once) are small. So this first kernel is bound by its own
// arithmetic, not by the card. Design (simple first): one block per
// (64-query tile, head, batch row); K and V tiles of 64 positions are staged
// in shared memory as f32 and shared by the tile's 64 queries; tiles above
// the diagonal and below the window are skipped, as in the TPU kernel.
// Moving the two products onto wgmma is the next step.
#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256;

template <typename T, int NACC>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const int32_t* __restrict__ start_pos, T* __restrict__ out, int S, int nh,
             int nkv, int t_max, float scale, int window) {
  constexpr int hd = NACC * 32;
  constexpr int qk_stride = hd + 1;  // padded rows: conflict-free column reads
  constexpr int s_stride = kBK + 1;
  extern __shared__ float smem[];
  float* qs = smem;                   // [kBQ][qk_stride]
  float* ks = qs + kBQ * qk_stride;   // [kBK][qk_stride]
  float* vs = ks + kBK * qk_stride;   // [kBK][hd]
  float* ss = vs + kBK * hd;          // [kBQ][s_stride]
  float* m_s = ss + kBQ * s_stride;   // [kBQ]
  float* l_s = m_s + kBQ;             // [kBQ]
  float* a_s = l_s + kBQ;             // [kBQ]

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int kvh = h / (nh / nkv);
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, S - q0);
  const int q_first = start_pos[b] + q0;
  const int q_last = q_first + rows - 1;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    qs[i * qk_stride + d] =
        i < rows ? to_f32<T>(q[(((size_t)b * S + q0 + i) * nh + h) * hd + d]) : 0.f;
  }
  if (tid < kBQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // PV ownership: warp w holds rows 8w..8w+7, lane holds dims lane + 32a.
  const int lane = tid & 31, rw = tid >> 5;
  float acc[8][NACC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int a = 0; a < NACC; ++a) acc[r][a] = 0.f;

  const int k_end = min(q_last + 1, t_max);
  const int k_lo = window < 0 ? 0 : max(q_first - window + 1, 0);
  const T* kbase = k + ((size_t)b * nkv + kvh) * t_max * hd;
  const T* vbase = v + ((size_t)b * nkv + kvh) * t_max * hd;
  // Score ownership: rows 4*ti..4*ti+3, columns tj + 16c.
  const int ti = tid >> 4, tj = tid & 15;

  for (int kt = (k_lo / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      const bool ok = kt + j < t_max;
      const size_t off = (size_t)(kt + j) * hd + d;
      ks[j * qk_stride + d] = ok ? to_f32<T>(kbase[off]) : 0.f;
      vs[j * hd + d] = ok ? to_f32<T>(vbase[off]) : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[r][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(4 * ti + r) * qk_stride + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tj + 16 * c) * qk_stride + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[r][c] += qv[r] * kv[c];
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ti + r, qpos = q_first + i;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tj + 16 * c, kpos = kt + j;
        bool ok = kpos <= qpos && kpos < t_max;
        if (window >= 0) ok = ok && kpos > qpos - window;
        ss[i * s_stride + j] = ok ? sc[r][c] * scale : MC_MASK_VALUE;
      }
    }
    __syncthreads();

    if (tid < kBQ) {
      float* srow = ss + tid * s_stride;
      float mx = srow[0];
      for (int j = 1; j < kBK; ++j) mx = fmaxf(mx, srow[j]);
      const float m_prev = m_s[tid];
      const float m_next = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_next);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = expf(srow[j] - m_next);
        srow[j] = p;
        sum += p;
      }
      l_s[tid] = alpha * l_s[tid] + sum;
      m_s[tid] = m_next;
      a_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float alpha = a_s[8 * rw + r];
#pragma unroll
      for (int a = 0; a < NACC; ++a) acc[r][a] *= alpha;
    }
    for (int j = 0; j < kBK; ++j) {
      float vv[NACC];
#pragma unroll
      for (int a = 0; a < NACC; ++a) vv[a] = vs[j * hd + lane + 32 * a];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float p = ss[(8 * rw + r) * s_stride + j];
#pragma unroll
        for (int a = 0; a < NACC; ++a) acc[r][a] += p * vv[a];
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int i = 8 * rw + r;
    if (i >= rows) continue;
    const float l = l_s[i];
    const float l_inv = l == 0.f ? 1.f : 1.f / l;
    T* o = out + (((size_t)b * S + q0 + i) * nh + h) * hd;
#pragma unroll
    for (int a = 0; a < NACC; ++a) o[lane + 32 * a] = from_f32<T>(acc[r][a] * l_inv);
  }
}

template <typename T, int NACC>
int launch(const void* q, const void* k, const void* v, const void* start_pos, void* out,
           int B, int S, int nh, int nkv, int t_max, float scale, int window,
           cudaStream_t st) {
  constexpr int hd = NACC * 32;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (hd + 1) + (size_t)kBK * hd
                                       + (size_t)kBQ * (kBK + 1) + 3 * kBQ);
  auto kernel = flash_kernel<T, NACC>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, nh, B);
  kernel<<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int32_t*>(start_pos), static_cast<T*>(out), S, nh, nkv, t_max,
      scale, window);
  return (int)cudaGetLastError();
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* k, const void* v, const void* start_pos,
                void* out, int B, int S, int nh, int nkv, int t_max, float scale, int window,
                cudaStream_t st) {
  switch (hd) {
    case 64: return launch<T, 2>(q, k, v, start_pos, out, B, S, nh, nkv, t_max, scale, window, st);
    case 128: return launch<T, 4>(q, k, v, start_pos, out, B, S, nh, nkv, t_max, scale, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [B, S, nh, hd]; k/v [B, nkv, t_max, hd] (bf16 if x_bf16 else f32);
// start_pos int32 [B]; window < 0 means global; out [B, S, nh, hd].
int flash_attention(const void* q, const void* k, const void* v, const void* start_pos,
                    void* out, int B, int S, int nh, int nkv, int t_max, int hd,
                    float scale, int window, int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return by_head_dim<__nv_bfloat16>(hd, q, k, v, start_pos, out, B, S, nh, nkv, t_max,
                                      scale, window, st);
  return by_head_dim<float>(hd, q, k, v, start_pos, out, B, S, nh, nkv, t_max, scale,
                            window, st);
}

}  // extern "C"
