// Causal prefill flash attention for Hopper (sm_90a).
//
// Replaces metalchat_tpu/ops/flash_attention_pallas.py: flash_attention
// (_flash_kernel). S new queries starting at start_pos (per batch row)
// attend over the head-major cache [B, n_kv, T, hd], causal, with an
// optional sliding window; f32 online softmax statistics.
//
// What bounds it on the H100: at a 512-token prefill the bound is bytes (q,
// k, v, out read or written once: about 3.1 us a layer) ahead of the bf16
// tensor-core operations (about 2.2 us); the kernel is held by how fast one
// SM works through its tiles. The same design on mma.sync took as long per
// tile and SM with 4 warps resident as with 8, i.e. it was held by
// mma.sync's rate; on wgmma it is faster (PERF.md, the kernel table).
//
// Design of the bf16 kernel (flash_wgmma_kernel), FlashAttention-2 shaped:
// * one block = one warpgroup (4 warps, 16 query rows each) per (query
//   head, 64-query tile, batch row); q tiles are launched heaviest first
//   (the tile nearest the diagonal sees the most keys);
// * K/V tiles of 64 positions arrive by cp.async 16-byte copies into a
//   three-stage ring (copies past t_max are zero-filled), two tiles in
//   flight while one is used, one barrier a tile. Every [64][hd] tile is
//   stored as hd / 64 atoms of [64 rows][128 bytes], 1024-byte aligned,
//   with the hardware's 128-byte swizzle, so wgmma reads it through a
//   descriptor. Q 16 KB + 3 x (K + V) 32 KB = 112 KB at hd = 128: two
//   blocks an SM, and a 512-token prefill's 256 blocks fill one wave;
// * S = QK^T by wgmma m64n64k16, Q and K from shared memory (both
//   K-major), bf16 in, f32 accumulate: every product of two bf16 values is
//   exact in f32, so only the summation order differs from the TPU
//   kernel's f32 dot;
// * the online softmax runs in registers (wgmma's accumulator layout is
//   mma.sync's m16n8 layout; row max reduced over each quad with
//   __shfl_xor_sync; exponentials as ex2.approx of the difference times
//   log2 e; the row sum kept per thread and reduced once at the end). Masks
//   are applied only on tiles that cross the causal diagonal, the window's
//   lower edge or t_max; tiles above the diagonal and below the window are
//   skipped;
// * O += P V by wgmma m64n{hd}k16 with P from registers and V from shared
//   memory (MN-major). P is split into two bf16 parts, hi = bf16(p) and
//   lo = bf16(p - hi), both multiplied into the same f32 accumulator: p
//   keeps about 16 significant bits. Rounding P to one bf16 (the usual
//   FlashAttention-2 choice) puts the output several times outside one
//   bf16 step of the TPU kernel's f32 result (tests/test_torch_checks.py,
//   faults "p_bf16" and "p_split"). The row sum l is taken from the f32 p.
//   The split costs a third more tensor work.
// Each tile's products are waited for before the tile's softmax or the
// next tile; the second block on the SM fills those gaps. (Issuing the next
// tile's QK^T under this tile's softmax made ptxas serialize the wgmmas,
// C7514, and ran slower.)
//
// f32 q/k/v take flash_simt_kernel, f32 products on CUDA cores (no bf16
// tensor-core product gives f32 results). The choice is by dtype: each
// dtype has exactly one kernel, and neither is a fallback for the other.
#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64;

// -- bf16, tensor cores -------------------------------------------------------

constexpr int kMmaThreads = 128;  // one warpgroup

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !ok (no read).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving uses of wgmma's registers across the
// wait, or reusing its A registers before it.
template <int N>
__device__ __forceinline__ void reg_fence(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void reg_fence(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d[32] (+)= A B for this warpgroup, A and B in shared memory (descriptors,
// both K-major), bf16 in, f32 accumulate; scale_d == 0 ignores d's value.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float* d, uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d[32] += A B for this warpgroup, A from registers (each warp its 16 rows
// in the mma.sync m16n8k16 A layout), B in shared memory MN-major, bf16 in,
// f32 accumulate.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[64] += A B for this warpgroup, A from registers (each warp its 16 rows
// in the mma.sync m16n8k16 A layout), B in shared memory MN-major, bf16 in,
// f32 accumulate.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float* d, const uint32_t* a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// Descriptor of a 128-byte-swizzled operand at shared address addr: lbo and
// sbo in bytes (K-major: sbo = the 8-row group stride, lbo unused; MN-major:
// lbo = the stride between 64-element atoms along MN, sbo = the 8-row group
// stride along K).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk c of row r in a [64][HD] bf16 tile stored as
// HD / 64 atoms of [64 rows][128 bytes], 1024-byte aligned, the chunk index
// XORed with r % 8: the hardware's 128-byte swizzle, which wgmma reads.
template <int HD>
__device__ __forceinline__ uint32_t atom_off(int r, int c) {
  return (uint32_t)((c >> 3) * (64 * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// A [64][HD] tile from rows g + i * stride (i < n_valid; the rest zeroed).
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* g, size_t stride,
                                          int n_valid) {
  constexpr int kChunks = HD / 8;
  for (int e = threadIdx.x; e < 64 * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = e % kChunks;
    const bool ok = r < n_valid;
    cp_async16(dst + atom_off<HD>(r, c), g + (size_t)(ok ? r : 0) * stride + c * 8, ok);
  }
}

constexpr int kStages = 3;  // K/V tiles in flight: the ring's depth
constexpr float kLog2e = 1.4426950408889634f;

// 2^x by the special-function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, far under any bf16 step of the output).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t* a, uint64_t desc_v) {
  if constexpr (HD == 128) wgmma_rs_m64n128k16(o, a, desc_v);
  else wgmma_rs_m64n64k16(o, a, desc_v);
}

template <int HD>
__global__ void __launch_bounds__(kMmaThreads, 2)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, const int32_t* __restrict__ start_pos,
                   int start, __nv_bfloat16* __restrict__ out, int S, int nh, int nkv,
                   int t_max, float scale, int window) {
  constexpr int kTile = kBK * HD * 2;  // bytes of one [64][HD] bf16 tile
  constexpr int KD = HD / 16;          // k-steps of QK^T
  extern __shared__ unsigned char smem[];
  // Q, then stage s: K at tile 1 + 2s, V at 2 + 2s; 1024-byte aligned atoms.
  const uint32_t sq = (smem_u32(smem) + 1023) & ~1023u;

  const int h = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kvh = h / (nh / nkv);
  const int q0 = qt * kBQ;
  const int rows = min(kBQ, S - q0);
  const int q_first = (start_pos ? start_pos[b] : start) + q0;
  const int q_last = q_first + rows - 1;
  const int k_end = min(q_last + 1, t_max);
  const int k_lo = window < 0 ? 0 : max(q_first - window + 1, 0);
  const int kt0 = (k_lo / kBK) * kBK;
  const int n_tiles = k_end > kt0 ? (k_end - kt0 + kBK - 1) / kBK : 0;
  const __nv_bfloat16* kbase = k + ((size_t)b * nkv + kvh) * t_max * HD;
  const __nv_bfloat16* vbase = v + ((size_t)b * nkv + kvh) * t_max * HD;
  // Tile j into its stage; one commit group a tile, empty past the last.
  auto load_kv = [&](int j) {
    if (j < n_tiles) {
      const int kt = kt0 + j * kBK;
      const uint32_t st = sq + kTile * (1 + 2 * (j % kStages));
      load_tile<HD>(st, kbase + (size_t)kt * HD, HD, t_max - kt);
      load_tile<HD>(st + kTile, vbase + (size_t)kt * HD, HD, t_max - kt);
    }
    cp_async_commit();
  };

  load_tile<HD>(sq, q + (((size_t)b * S + q0) * nh + h) * HD, (size_t)nh * HD, rows);
  cp_async_commit();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) load_kv(j);

  // This thread's rows: r and r + 8 of the warp's 16 (wgmma's accumulator
  // layout is mma.sync's m16n8 layout, warp w on rows 16w..16w+15).
  const int r0 = warp * 16 + (lane >> 2);
  const int qpos0 = q_first + r0, qpos1 = qpos0 + 8;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    // Tile j (and Q) have landed once at most kStages - 2 later groups are
    // pending; the proxy fence makes the copies visible to wgmma, and the
    // barrier retires every read of the stage refilled next (tile j - 1's;
    // each tile's wgmmas are waited for before the tile ends).
    cp_async_wait<kStages - 2>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    load_kv(j + kStages - 1);
    const int kt = kt0 + j * kBK;
    const uint32_t sk = sq + kTile * (1 + 2 * (j % kStages));
    const uint32_t sv = sk + kTile;

    // S = Q K^T: one m64n64k16 a k-step of 16 head dims (32 bytes into an
    // atom, the next atom every 4 steps).
    float s[8][4] = {};
    reg_fence<32>(&s[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const uint32_t off = (kk >> 2) * (64 * 128) + (kk & 3) * 32;
      wgmma_ss_m64n64k16(&s[0][0], smem_desc(sq + off, 16, 1024), smem_desc(sk + off, 16, 1024),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence<32>(&s[0][0]);

    // Scale, mask where the tile crosses an edge, online softmax.
    const bool edge = kt + kBK - 1 > q_first || kt + kBK > t_max
                      || (window >= 0 && kt <= q_last - window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale;
        if (edge) {
          const int kpos = kt + n * 8 + 2 * (lane & 3) + (e & 1);
          const int qpos = e < 2 ? qpos0 : qpos1;
          bool ok = kpos <= qpos && kpos < t_max;
          if (window >= 0) ok = ok && kpos > qpos - window;
          x = ok ? x : MC_MASK_VALUE;
        }
        s[n][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, d));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, d));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = ex2((m0 - mn0) * kLog2e), a1 = ex2((m1 - mn1) * kLog2e);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = ex2((s[n][0] - mn0) * kLog2e);
      s[n][1] = ex2((s[n][1] - mn0) * kLog2e);
      s[n][2] = ex2((s[n][2] - mn1) * kLog2e);
      s[n][3] = ex2((s[n][3] - mn1) * kLog2e);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V with P = hi + lo, both parts bf16: 4 k-steps of 16 keys (two
    // 8-row groups of V, 2048 bytes, a step). The A fragments must stay put
    // until the wgmmas are waited for.
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = s[2 * kk + (i >> 1)] + 2 * (i & 1);
        const __nv_bfloat162 ph = __floats2bfloat162_rn(p[0], p[1]);
        hi[kk][i] = *reinterpret_cast<const uint32_t*>(&ph);
        lo[kk][i] = pack_bf16(p[0] - __low2float(ph), p[1] - __high2float(ph));
      }
    reg_fence<HD / 2>(&o[0][0]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(sv + kk * 2048, 64 * 128, 1024);
      wgmma_pv<HD>(&o[0][0], hi[kk], dv);
      wgmma_pv<HD>(&o[0][0], lo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence<HD / 2>(&o[0][0]);
    reg_fence<16>(&hi[0][0]);
    reg_fence<16>(&lo[0][0]);
  }

#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, d);
    l1 += __shfl_xor_sync(0xffffffffu, l1, d);
  }
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  const int col = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    if (r >= rows) continue;
    const float inv = half ? inv1 : inv0;
    __nv_bfloat16* orow = out + (((size_t)b * S + q0 + r) * nh + h) * HD + col;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* start_pos, int start,
                 void* out, int B, int S, int nh, int nkv, int t_max, float scale,
                 int window, cudaStream_t st) {
  // Q + the ring of K and V, and room to align the atoms to 1024 bytes.
  const int smem = (1 + 2 * kStages) * kBK * HD * 2 + 1024;
  auto kernel = flash_wgmma_kernel<HD>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid(nh, (S + kBQ - 1) / kBQ, B);
  kernel<<<grid, kMmaThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int32_t*>(start_pos), start,
      static_cast<__nv_bfloat16*>(out), S, nh, nkv, t_max, scale, window);
  return (int)cudaGetLastError();
}

// -- f32, CUDA cores ----------------------------------------------------------

constexpr int kSimtThreads = 256;

// One block per (64-query tile, head, batch row); K and V tiles of 64
// positions staged in shared memory and shared by the tile's 64 queries.
template <int NACC>
__global__ void __launch_bounds__(kSimtThreads)
flash_simt_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int32_t* __restrict__ start_pos,
                  int start, float* __restrict__ out, int S, int nh, int nkv, int t_max,
                  float scale, int window) {
  constexpr int hd = NACC * 32;
  constexpr int qk_stride = hd + 1;  // padded rows: conflict-free column reads
  constexpr int s_stride = kBK + 1;
  extern __shared__ float smem_f[];
  float* qs = smem_f;                 // [kBQ][qk_stride]
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
  const int q_first = (start_pos ? start_pos[b] : start) + q0;
  const int q_last = q_first + rows - 1;

  for (int e = tid; e < kBQ * hd; e += kSimtThreads) {
    const int i = e / hd, d = e % hd;
    qs[i * qk_stride + d] = i < rows ? q[(((size_t)b * S + q0 + i) * nh + h) * hd + d] : 0.f;
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
  const float* kbase = k + ((size_t)b * nkv + kvh) * t_max * hd;
  const float* vbase = v + ((size_t)b * nkv + kvh) * t_max * hd;
  // Score ownership: rows 4*ti..4*ti+3, columns tj + 16c.
  const int ti = tid >> 4, tj = tid & 15;

  for (int kt = (k_lo / kBK) * kBK; kt < k_end; kt += kBK) {
    __syncthreads();
    for (int e = tid; e < kBK * hd; e += kSimtThreads) {
      const int j = e / hd, d = e % hd;
      const bool ok = kt + j < t_max;
      const size_t off = (size_t)(kt + j) * hd + d;
      ks[j * qk_stride + d] = ok ? kbase[off] : 0.f;
      vs[j * hd + d] = ok ? vbase[off] : 0.f;
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
    float* o = out + (((size_t)b * S + q0 + i) * nh + h) * hd;
#pragma unroll
    for (int a = 0; a < NACC; ++a) o[lane + 32 * a] = acc[r][a] * l_inv;
  }
}

template <int NACC>
int launch_simt(const void* q, const void* k, const void* v, const void* start_pos, int start,
                void* out, int B, int S, int nh, int nkv, int t_max, float scale, int window,
                cudaStream_t st) {
  constexpr int hd = NACC * 32;
  const size_t smem = sizeof(float) * ((size_t)(kBQ + kBK) * (hd + 1) + (size_t)kBK * hd
                                       + (size_t)kBQ * (kBK + 1) + 3 * kBQ);
  auto kernel = flash_simt_kernel<NACC>;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((S + kBQ - 1) / kBQ, nh, B);
  kernel<<<grid, kSimtThreads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int32_t*>(start_pos), start, static_cast<float*>(out), S, nh, nkv,
      t_max, scale, window);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, S, nh, hd]; k/v [B, nkv, t_max, hd] (bf16 if x_bf16 else f32);
// start_pos int32 [B], or null for `start` in every row; window < 0 means
// global; out [B, S, nh, hd].
int flash_attention(const void* q, const void* k, const void* v, const void* start_pos,
                    int start, void* out, int B, int S, int nh, int nkv, int t_max, int hd,
                    float scale, int window, int x_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd * 2 + (x_bf16 ? 1 : 0)) {
    case 129: return launch_wgmma<64>(q, k, v, start_pos, start, out, B, S, nh, nkv, t_max, scale, window, st);
    case 257: return launch_wgmma<128>(q, k, v, start_pos, start, out, B, S, nh, nkv, t_max, scale, window, st);
    case 128: return launch_simt<2>(q, k, v, start_pos, start, out, B, S, nh, nkv, t_max, scale, window, st);
    case 256: return launch_simt<4>(q, k, v, start_pos, start, out, B, S, nh, nkv, t_max, scale, window, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
