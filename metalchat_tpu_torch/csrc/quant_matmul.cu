// Weight-only group-quantized matmul for decode-sized row counts, Hopper (sm_90a).
//
// Replaces metalchat_tpu/ops/quant_matmul_pallas.py: quant_matmul_pallas
// (_int8_kernel, _int4_kernel). One C entry, quant_matmul:
//   x (bf16/f32) [B, in], B <= 32  @  dequant(q, scales)  ->  out [B, out] in x's dtype
// or, with out_f32, in f32 (the same sums without the last rounding: a
// row-parallel partial that is summed over ranks before it is rounded).
// Each weight element is T(float(q) * float(T(s))) in the activation dtype T,
// x is read as T, products are summed in f32 and the output rounded to T:
// for bf16 the TPU kernel's rounding (both products are exact in f32, only
// the summation order differs), for f32 the JAX package's f32 quant_matmul.
// Both storage orientations of the JAX package:
//   transposed:     q [out, in(/2)], scales [out, in/g]
//   non-transposed: q [in(/2), out], scales [in/g, out]
// with per-channel scales (g == in) [1, out] in both, which the index
// o * n_groups + grp (resp. grp * out + o) covers with n_groups = 1. int4 is
// half-split with an offset-binary low nibble: packed row r holds input r
// (low nibble, +8) and input r + in/2 (high nibble, two's complement).
//
// What bounds it on the H100: the weight stream. At B <= 32 each weight
// element is used B times, far below the ~295 bf16 operations per byte where
// the tensor cores would become the limit, so the least time is the packed
// bytes plus the group scales over the HBM rate. While HBM delivers one
// byte the card issues about 8.8 lane-instructions (132 SMs x 128 lanes x
// ~1.75 GHz against 3.35e12 B/s), and an int4 byte is two weights: the
// dequantization itself is what can make the kernel issue-bound.
//
// Lean bf16 dequantization (int4, bf16 activations): a nibble n becomes
// bf16 by OR-ing it into the mantissa of 128.0 (0x4300 | n == 128 + n, the
// high nibble XOR 8 first, which makes it offset-binary too) and one exact
// bf16x2 subtraction of 136. One bf16x2 multiply by T(s) then rounds the
// exact product once to nearest: T(float(q) * float(T(s))) bit for bit.
// Two weights a 32-bit word, the same byte position of two bytes (0 and 2,
// 1 and 3), so one LOP3 (and a shift) builds a pair.
//
// Non-transposed (wo, w2): qmm_natural, split over k. Each thread owns C
// consecutive output columns (16 at one row, 8 up to 8 rows, 4 above, so
// that its C x B f32 accumulators stay in registers) and reads them with
// one C-byte load a packed row: a warp covers a strip of 32 C columns, and
// the 8 warps of a block split the block's packed rows into contiguous runs
// with kNatUnroll rows of loads in flight. Blocks split the packed rows
// (grid strips x n_split, planned by the wrapper so that the card holds
// about two blocks an SM). A block stages its slice of x once in shared
// memory as f32 and reads the C scales of a group once. The warps' sums
// meet in shared memory in warp order; the block's f32 partial goes to a
// workspace [n_split, B, out], and the last block of a strip to arrive
// (arrive_last on a per-strip counter, which it resets) sums the partials
// in split order, rounds to T and stores: one launch, reproducible, and
// capturable in a CUDA graph.
//
// Transposed (wqkv, w13, lm_head), bf16 activations: qmm_mma on tensor cores,
// mma.sync m16n8k16 bf16 with f32 accumulators. A block owns 16 output rows
// (the mma's M), its 8 warps split k in 64-byte steps. In a step lane (g =
// lane/4, t = lane%4) loads the 16 bytes [16t, 16t + 16) of weight rows g
// and g + 8, dequantizes them into bf16 pairs and feeds them as the A
// operand; x row g of each n-tile of 8 rows (rows >= B are zero) gives the
// matching pairs as B. The pairs of a register are two inputs of one 16-byte
// chunk (bytes 0/2 or 1/3 of a word, low or high nibbles), which is one
// permutation of k applied to both operands. Int8 weights become f32 by a
// byte permute (the magic-number trick is not exact for 8-bit codes),
// are multiplied by T(s) in f32 and rounded to a bf16 pair by one cvt.
// The warps' f32 partials are summed in shared memory in warp order.
// f32 activations keep qmm_transposed on the CUDA cores (TF32 would break the
// f32 contract): one warp an output row, 16-byte loads.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// Element i of the output: the f32 total itself (out_f32) or rounded to T.
template <typename T>
__device__ __forceinline__ void store_out(void* out, int out_f32, size_t i, float v) {
  if (out_f32)
    static_cast<float*>(out)[i] = v;
  else
    static_cast<T*>(out)[i] = from_f32<T>(v);
}

// 16 consecutive values of x as f32.
template <typename T> __device__ __forceinline__ void load16(const T* p, float* v);
template <> __device__ __forceinline__ void load16<float>(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + i);
    v[4 * i] = f.x; v[4 * i + 1] = f.y; v[4 * i + 2] = f.z; v[4 * i + 3] = f.w;
  }
}
template <> __device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                                   float* v) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int4 raw = __ldg(reinterpret_cast<const int4*>(p) + i);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[8 * i + j] = __bfloat162float(h[j]);
  }
}

// A scale as the activation dtype sees it: T(s).
template <typename T, typename S> __device__ __forceinline__ float scale_as(S s) {
  return round_through<T>(to_f32<S>(s));
}

// The bits of bf16(s).
template <typename S> __device__ __forceinline__ uint32_t bf16_bits(S s);
template <> __device__ __forceinline__ uint32_t bf16_bits<__nv_bfloat16>(__nv_bfloat16 s) {
  return __bfloat16_as_ushort(s);
}
template <> __device__ __forceinline__ uint32_t bf16_bits<float>(float s) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(s));
}

__device__ __forceinline__ uint32_t bf2_sub(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ uint32_t bf2_mul(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}
__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

constexpr uint32_t kMagic = 0x43004300u;   // 128.0 in both halves
constexpr uint32_t kMagicHi = 0x43084308u;  // the same, XOR 8 on the nibble
constexpr uint32_t k136 = 0x43084308u;      // 136.0 in both halves

// The four bf16 pairs of int4 codes in word w, scaled: lo nibbles of bytes
// (0, 2) and (1, 3), hi nibbles of bytes (0, 2) and (1, 3); s[k] the
// matching scale pairs.
__device__ __forceinline__ void dequant_word4(uint32_t w, const uint32_t (&s)[4],
                                              uint32_t (&p)[4]) {
  p[0] = bf2_mul(bf2_sub((w & 0x000F000Fu) | kMagic, k136), s[0]);
  p[1] = bf2_mul(bf2_sub(((w >> 8) & 0x000F000Fu) | kMagic, k136), s[1]);
  p[2] = bf2_mul(bf2_sub(((w >> 4) & 0x000F000Fu) ^ kMagicHi, k136), s[2]);
  p[3] = bf2_mul(bf2_sub(((w >> 12) & 0x000F000Fu) ^ kMagicHi, k136), s[3]);
}

// Signed byte i of w as f32, exactly, by a byte permute (common.cuh s8_at).
__device__ __forceinline__ float s8_f32(uint32_t w, int i) { return s8_at(w ^ 0x80808080u, i); }
__device__ __forceinline__ uint32_t pack_bf2(float lo, float hi) {
  __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&r);
}

// 16 weight bytes streamed once: not kept in L1, where x lives.
__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  int4 v;
  asm("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// ---------------------------------------------------------------------------
// f32 activations, transposed: the CUDA-core loop.

template <int MAXB, int BITS, typename T, typename S>
__global__ void __launch_bounds__(kThreads)
qmm_transposed(const T* __restrict__ x, const int8_t* __restrict__ q,
               const S* __restrict__ s, void* __restrict__ out, int out_f32, int B, int in_f,
               int out_f, int g) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int half = in_f / 2;
  const int k = BITS == 4 ? half : in_f;
  const int n_groups = in_f / g;
  for (int o = blockIdx.x * kWarps + warp; o < out_f; o += gridDim.x * kWarps) {
    const int8_t* wrow = q + (size_t)o * k;
    const S* srow = s + (size_t)o * n_groups;
    float acc[MAXB];
#pragma unroll
    for (int b = 0; b < MAXB; ++b) acc[b] = 0.f;
    for (int c = lane * 16; c < k; c += 32 * 16) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(wrow + c));
      const int8_t* wb = reinterpret_cast<const int8_t*>(&raw);
      float w_lo[16], w_hi[16];
      if (BITS == 8) {
        const float sc = scale_as<T, S>(srow[c / g]);
#pragma unroll
        for (int j = 0; j < 16; ++j) w_lo[j] = round_through<T>((float)wb[j] * sc);
      } else {
        const float s_lo = scale_as<T, S>(srow[c / g]);
        const float s_hi = scale_as<T, S>(srow[(half + c) / g]);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          w_lo[j] = round_through<T>((float)((wb[j] & 15) - 8) * s_lo);
          w_hi[j] = round_through<T>((float)(wb[j] >> 4) * s_hi);
        }
      }
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b >= B) break;
        float xv[16];
        load16<T>(x + (size_t)b * in_f + c, xv);
#pragma unroll
        for (int j = 0; j < 16; ++j) acc[b] = fmaf(xv[j], w_lo[j], acc[b]);
        if (BITS == 4) {
          load16<T>(x + (size_t)b * in_f + half + c, xv);
#pragma unroll
          for (int j = 0; j < 16; ++j) acc[b] = fmaf(xv[j], w_hi[j], acc[b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      if (b >= B) break;
      const float total = warp_sum(acc[b]);
      if (lane == 0) store_out<T>(out, out_f32, (size_t)b * out_f + o, total);
    }
  }
}

// ---------------------------------------------------------------------------
// Non-transposed: split over k (see the note at the top).

constexpr int kNatUnroll = 8;  // packed rows of loads in flight a thread

template <int MAXB> struct NatCols {
  static constexpr int C = MAXB == 1 ? 16 : MAXB <= 8 ? 8 : 4;  // columns a thread
};

template <int C> struct Bytes { uint32_t w[C / 4]; };

template <int C>
__device__ __forceinline__ Bytes<C> load_cols(const int8_t* p, bool vec, int live) {
  Bytes<C> v;
  if (vec) {
    if constexpr (C == 16) {
      const int4 r = ld_stream(p);
      v.w[0] = r.x; v.w[1] = r.y; v.w[2] = r.z; v.w[3] = r.w;
    } else if constexpr (C == 8) {
      const uint2 r = __ldcs(reinterpret_cast<const uint2*>(p));
      v.w[0] = r.x; v.w[1] = r.y;
    } else {
      v.w[0] = __ldcs(reinterpret_cast<const unsigned int*>(p));
    }
  } else {  // a ragged or unaligned edge: byte by byte, zeros past out
#pragma unroll
    for (int i = 0; i < C / 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (4 * i + j < live) word |= (uint32_t)(uint8_t)p[4 * i + j] << (8 * j);
      v.w[i] = word;
    }
  }
  return v;
}

// One f32 total of a block of the split-K routes: the output itself when k
// is not split, else the block's partial in the workspace [n_split, B, out].
template <typename T>
__device__ __forceinline__ void split_store(void* out, int out_f32, float* ws, int split,
                                            int n_split, int B, int out_f, int b, int col,
                                            float total) {
  if (n_split == 1)
    store_out<T>(out, out_f32, (size_t)b * out_f + col, total);
  else
    ws[((size_t)split * B + b) * out_f + col] = total;
}

// After every thread of the block has stored its partials: the last block of
// the strip [col0, col0 + width) to arrive sums the partials in split order,
// rounds to T (unless out_f32) and stores (arrive_last resets the strip's counter).
template <typename T>
__device__ __forceinline__ void merge_splits(void* out, int out_f32, const float* ws,
                                             int* counter, int n_split, int B, int out_f,
                                             int col0, int width, int* flag) {
  if (n_split == 1 || !arrive_last(counter, n_split, flag)) return;
  const size_t stride = (size_t)B * out_f;
  for (int e = threadIdx.x; e < B * width; e += blockDim.x) {
    const int b = e / width, col = col0 + e % width;
    if (col >= out_f) continue;
    const float* p = ws + (size_t)b * out_f + col;
    float total = 0.f;
#pragma unroll 16
    for (int sidx = 0; sidx < n_split; ++sidx) total += __ldcg(p + sidx * stride);
    store_out<T>(out, out_f32, (size_t)b * out_f + col, total);
  }
}

// Rows [r, min(r + U, r1)) of this thread's columns.
template <int C, int U>
__device__ __forceinline__ void load_rows(Bytes<C> (&wv)[U], const int8_t* qcol, int r, int r1,
                                          int out_f, bool vec, int live) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (r + u < r1) wv[u] = load_cols<C>(qcol + (size_t)(r + u) * out_f, vec, live);
}

template <typename S> __device__ __forceinline__ void prefetch_l2(const S* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The scales of every group that packed rows [ra, rb) read (lo, and the hi
// groups of int4), at this thread's columns, to L2: a run's group changes
// then wait on L2, not on HBM.
template <int BITS, typename S>
__device__ __forceinline__ void prefetch_groups(const S* s, int out_f, int col, int ra, int rb,
                                                int g, int half) {
  if (ra >= rb) return;
  for (int grp = ra / g; grp <= (rb - 1) / g; ++grp) prefetch_l2(s + (size_t)grp * out_f + col);
  if (BITS == 4)
    for (int grp = (ra + half) / g; grp <= (rb - 1 + half) / g; ++grp)
      prefetch_l2(s + (size_t)grp * out_f + col);
}

template <int MAXB, int BITS, typename T, typename S>
__global__ void __launch_bounds__(kThreads, MAXB == 1 ? 2 : 1)
qmm_natural(const T* __restrict__ x, const int8_t* __restrict__ q, const S* __restrict__ s,
            void* __restrict__ out, int out_f32, float* __restrict__ ws,
            int* __restrict__ counters, int B, int in_f, int out_f, int g, int per_split) {
  constexpr int C = NatCols<MAXB>::C;
  constexpr int kStrip = 32 * C;
  // The lean bf16x2 dequantization (int4 codes, bf16 activations).
  constexpr bool kLean = BITS == 4 && sizeof(T) == 2;
  constexpr int NH = BITS == 4 ? 2 : 1;  // x halves a packed row reads
  extern __shared__ __align__(16) float smem_f[];
  __shared__ int last_flag;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int strip = blockIdx.x, split = blockIdx.y, n_split = gridDim.y;
  const int half = in_f / 2;
  const int k = BITS == 4 ? half : in_f;  // packed rows
  const int r0 = split * per_split;
  const int r1 = min(k, r0 + per_split);
  const int nr = r1 - r0;

  // This warp's contiguous run of packed rows. Its first loads (and its
  // first group's scales, to L2) are issued before x is staged.
  const int col = strip * kStrip + lane * C;
  const int live = max(0, min(C, out_f - col));
  const bool vec = (out_f % 16) == 0;  // every row start 16-byte aligned
  const int per_warp = (nr + kWarps - 1) / kWarps;
  const int rw0 = r0 + warp * per_warp;
  const int rw1 = min(r1, rw0 + per_warp);
  const int8_t* qcol = q + col;
  Bytes<C> wv[kNatUnroll];
  if (live > 0 && rw0 < rw1) {
    load_rows<C, kNatUnroll>(wv, qcol, rw0, rw1, out_f, vec, live);
    prefetch_groups<BITS>(s, out_f, col, rw0, rw1, g, half);
  }

  // 1. The block's slice of x, once, as f32: xs[h][b][j] = x[b][h * half + r0 + j].
  float* xs = smem_f;
  for (int i = threadIdx.x; i < NH * B * nr; i += kThreads) {
    const int j = i % nr, hb = i / nr, b = hb % B, h = hb / B;
    xs[(h * B + b) * per_split + j] = to_f32<T>(x[(size_t)b * in_f + h * half + r0 + j]);
  }
  __syncthreads();

  // 2. The run, kNatUnroll rows of loads at a time.
  float acc[MAXB][C];
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
#pragma unroll
    for (int c = 0; c < C; ++c) acc[b][c] = 0.f;
  uint32_t sp[C / 4][4];  // kLean: scale pairs per word (lo 02, lo 13, hi 02, hi 13)
  float sl[C], sh[C];     // otherwise: T(s) of each column, lo and hi group
  int next_lo = rw0, next_hi = rw0;
  if (live > 0) {
    for (int r = rw0; r < rw1; r += kNatUnroll) {
      if (r != rw0) load_rows<C, kNatUnroll>(wv, qcol, r, rw1, out_f, vec, live);
#pragma unroll
      for (int u = 0; u < kNatUnroll; ++u) {
        const int rr = r + u;
        if (rr >= rw1) break;
        if (rr == next_lo || rr == next_hi) {  // a new group (warp-uniform)
          const int gl = rr / g, gh = (rr + half) / g;
          next_lo = (gl + 1) * g;
          next_hi = BITS == 4 ? (gh + 1) * g - half : next_lo;
          const S* s_lo = s + (size_t)gl * out_f + col;
          const S* s_hi = s + (size_t)gh * out_f + col;
          if constexpr (kLean) {
#pragma unroll
            for (int i = 0; i < C / 4; ++i) {
              uint32_t l[4], h[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const bool in = 4 * i + j < live;
                l[j] = in ? bf16_bits<S>(s_lo[4 * i + j]) : 0u;
                h[j] = in ? bf16_bits<S>(s_hi[4 * i + j]) : 0u;
              }
              sp[i][0] = l[0] | (l[2] << 16); sp[i][1] = l[1] | (l[3] << 16);
              sp[i][2] = h[0] | (h[2] << 16); sp[i][3] = h[1] | (h[3] << 16);
            }
          } else {
#pragma unroll
            for (int c = 0; c < C; ++c) {
              sl[c] = c < live ? scale_as<T, S>(s_lo[c]) : 0.f;
              if (BITS == 4) sh[c] = c < live ? scale_as<T, S>(s_hi[c]) : 0.f;
            }
          }
        }
        float wl[C], wh[C];
#pragma unroll
        for (int i = 0; i < C / 4; ++i) {
          const uint32_t w = wv[u].w[i];
          if constexpr (kLean) {
            uint32_t p[4];
            dequant_word4(w, sp[i], p);
            wl[4 * i] = bf_lo(p[0]); wl[4 * i + 1] = bf_lo(p[1]);
            wl[4 * i + 2] = bf_hi(p[0]); wl[4 * i + 3] = bf_hi(p[1]);
            wh[4 * i] = bf_lo(p[2]); wh[4 * i + 1] = bf_lo(p[3]);
            wh[4 * i + 2] = bf_hi(p[2]); wh[4 * i + 3] = bf_hi(p[3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int c = 4 * i + j;
              const int pb = (int)(int8_t)(w >> (8 * j));
              if (BITS == 4) {
                wl[c] = round_through<T>((float)((pb & 15) - 8) * sl[c]);
                wh[c] = round_through<T>((float)(pb >> 4) * sh[c]);
              } else {
                wl[c] = round_through<T>((float)pb * sl[c]);
              }
            }
          }
        }
        const int j = rr - r0;
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          if (b >= B) break;
          const float xl = xs[b * per_split + j];
#pragma unroll
          for (int c = 0; c < C; ++c) acc[b][c] = fmaf(xl, wl[c], acc[b][c]);
          if (BITS == 4) {
            const float xh = xs[(B + b) * per_split + j];
#pragma unroll
            for (int c = 0; c < C; ++c) acc[b][c] = fmaf(xh, wh[c], acc[b][c]);
          }
        }
      }
    }
  }

  // 3. The warps' sums in shared memory (over x's slice), added in warp order.
  __syncthreads();
  float* red = smem_f;  // [kWarps][B][kStrip]
#pragma unroll
  for (int b = 0; b < MAXB; ++b) {
    if (b >= B) break;
    float* dst = red + ((size_t)warp * B + b) * kStrip + lane * C;
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<float4*>(dst + c) =
          make_float4(acc[b][c], acc[b][c + 1], acc[b][c + 2], acc[b][c + 3]);
  }
  __syncthreads();
  const int col0 = strip * kStrip;
  for (int e = threadIdx.x; e < B * kStrip; e += kThreads) {
    const int b = e / kStrip, cx = e % kStrip;
    if (col0 + cx >= out_f) continue;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[((size_t)w * B + b) * kStrip + cx];
    split_store<T>(out, out_f32, ws, split, n_split, B, out_f, b, col0 + cx, total);
  }
  // 4. The last block of this strip sums the partials in split order.
  merge_splits<T>(out, out_f32, ws, counters + strip, n_split, B, out_f, col0, kStrip,
                  &last_flag);
}

// ---------------------------------------------------------------------------
// Transposed, bf16 activations: tensor cores (see the note at the top).

constexpr int kTileRows = 16;  // output rows a block (the mma's M)
constexpr int kStep = 64;      // packed bytes a weight row per step (4 lanes x 16 B)

// c += A (16 x 16, row-major) * B (16 x 8, col-major), bf16 in, f32 out.
// A: a0 row g, k pair t; a1 row g + 8, pair t; a2 row g, pair t + 4; a3 row
// g + 8, pair t + 4. B: b0 column g, pair t; b1 pair t + 4. C: c0/c1 row g,
// columns 2t and 2t + 1; c2/c3 row g + 8.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const int4& v, int i) {
  return (uint32_t)(i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w);
}

// The x pairs of a 16-input chunk (two 16-byte loads of bf16): for input
// word j of the weights (inputs 4j .. 4j + 3), (x0, x2) and (x1, x3).
__device__ __forceinline__ void x_pairs(int4 a, int4 b, uint32_t (&p)[8]) {
  const uint32_t v[8] = {word(a, 0), word(a, 1), word(a, 2), word(a, 3),
                         word(b, 0), word(b, 1), word(b, 2), word(b, 3)};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[2 * j] = __byte_perm(v[2 * j], v[2 * j + 1], 0x5410);
    p[2 * j + 1] = __byte_perm(v[2 * j], v[2 * j + 1], 0x7632);
  }
}

// The scaled bf16 pairs of one weight row's 16 bytes: int4 gives 16 pairs
// (word j: lo 02, lo 13, hi 02, hi 13), int8 gives 8 (word j: 02, 13).
template <int BITS, typename S>
__device__ __forceinline__ void row_pairs(int4 raw, S s_lo, S s_hi, uint32_t (&p)[16]) {
  if constexpr (BITS == 4) {
    const uint32_t bl = bf16_bits<S>(s_lo), bh = bf16_bits<S>(s_hi);
    const uint32_t sl = bl | (bl << 16), sh = bh | (bh << 16);
    const uint32_t sc[4] = {sl, sl, sh, sh};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t q[4];
      dequant_word4(word(raw, j), sc, q);
#pragma unroll
      for (int i = 0; i < 4; ++i) p[4 * j + i] = q[i];
    }
  } else {
    const float sc = __uint_as_float(bf16_bits<S>(s_lo) << 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w = word(raw, j);
      p[2 * j] = pack_bf2(s8_f32(w, 0) * sc, s8_f32(w, 2) * sc);
      p[2 * j + 1] = pack_bf2(s8_f32(w, 1) * sc, s8_f32(w, 3) * sc);
    }
  }
}

// NT n-tiles of 8 x rows (B <= 8 * NT), kU steps of loads in flight a warp.
template <int BITS, int NT, typename S>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 3 : 1)
qmm_mma(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
        const S* __restrict__ s, void* __restrict__ out, int out_f32, int B, int in_f,
        int out_f, int g) {
  constexpr int kU = NT == 1 ? 2 : 1;
  constexpr int NP = BITS == 4 ? 16 : 8;  // pairs a row's 16 bytes
  __shared__ float red[kWarps][NT * 4][32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gq = lane >> 2, t = lane & 3;
  const int half = in_f / 2;
  const int k = BITS == 4 ? half : in_f;  // packed bytes a weight row
  const int n_groups = in_f / g;
  const int o0 = blockIdx.x * kTileRows + gq;
  const bool live0 = o0 < out_f, live1 = o0 + 8 < out_f;
  const int8_t* w0 = q + (size_t)(live0 ? o0 : 0) * k + 16 * t;
  const int8_t* w1 = q + (size_t)(live1 ? o0 + 8 : 0) * k + 16 * t;
  const S* s0 = s + (size_t)(live0 ? o0 : 0) * n_groups;
  const S* s1 = s + (size_t)(live1 ? o0 + 8 : 0) * n_groups;
  const __nv_bfloat16* xr[NT];
  bool xlive[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    xlive[j] = 8 * j + gq < B;
    xr[j] = x + (size_t)(xlive[j] ? 8 * j + gq : 0) * in_f + 16 * t;
  }
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int4 zero = make_int4(0, 0, 0, 0);
  const int steps = (k + kStep - 1) / kStep;
  for (int st0 = warp; st0 < steps; st0 += kWarps * kU) {
    // The weights (and their scales) of kU steps in flight; x, which every
    // block reads, comes from L1 as each step is used.
    int4 wa[kU], wb[kU];
    S sa[kU][2], sb[kU][2];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = (st0 + u * kWarps) * kStep;  // this step's first byte
      const bool in = c + 16 * t < k;             // k % 16 == 0: all in or out
      const int cl = c + 16 * t;                  // this lane's chunk: lo inputs
      wa[u] = in && live0 ? ld_stream(w0 + c) : zero;
      wb[u] = in && live1 ? ld_stream(w1 + c) : zero;
      const int gl = in ? cl / g : 0, gh = in ? (half + cl) / g : 0;
      sa[u][0] = s0[gl]; sb[u][0] = s1[gl];
      sa[u][1] = BITS == 4 ? s0[gh] : sa[u][0];
      sb[u][1] = BITS == 4 ? s1[gh] : sb[u][0];
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int c = (st0 + u * kWarps) * kStep;
      const bool in = c + 16 * t < k;
      uint32_t pa[16], pb[16];
      row_pairs<BITS, S>(wa[u], sa[u][0], sa[u][1], pa);
      row_pairs<BITS, S>(wb[u], sb[u][0], sb[u][1], pb);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool x_in = in && xlive[j];
        const int4* xp = reinterpret_cast<const int4*>(xr[j] + c);
        uint32_t xpl[8], xph[8];
        x_pairs(x_in ? __ldg(xp) : zero, x_in ? __ldg(xp + 1) : zero, xpl);
        if (BITS == 4) {
          const int4* xq = reinterpret_cast<const int4*>(xr[j] + half + c);
          x_pairs(x_in ? __ldg(xq) : zero, x_in ? __ldg(xq + 1) : zero, xph);
        }
        // mma m takes pairs 2m (slot t) and 2m + 1 (slot t + 4) of each row.
#pragma unroll
        for (int m = 0; m < NP / 2; ++m) {
          uint32_t b0, b1;
          if (BITS == 4) {  // word m/2: lo pairs for even m, hi pairs for odd m
            const uint32_t* xp = (m & 1) ? xph : xpl;
            b0 = xp[2 * (m >> 1)];
            b1 = xp[2 * (m >> 1) + 1];
          } else {
            b0 = xpl[2 * m];
            b1 = xpl[2 * m + 1];
          }
          mma_bf16(acc[j], pa[2 * m], pb[2 * m], pa[2 * m + 1], pb[2 * m + 1], b0, b1);
        }
      }
    }
  }

#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[warp][j * 4 + i][lane] = acc[j][i];
  __syncthreads();
  // One thread per (n-tile j, register i, lane): its output element.
  for (int e = threadIdx.x; e < NT * 4 * 32; e += kThreads) {
    const int ln = e & 31, j = e >> 7, i = (e >> 5) & 3;
    const int o = blockIdx.x * kTileRows + (ln >> 2) + (i >= 2 ? 8 : 0);
    const int b = 8 * j + 2 * (ln & 3) + (i & 1);
    if (o >= out_f || b >= B) continue;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += red[w][j * 4 + i][ln];
    store_out<__nv_bfloat16>(out, out_f32, (size_t)b * out_f + o, total);
  }
}

// ---------------------------------------------------------------------------

template <typename K> int set_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

int max_blocks() {
  static int blocks = 0;
  if (blocks == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = sms * 8;
  }
  return blocks;
}

template <int MAXB, int BITS, typename T, typename S>
int launch(int transposed, const void* x, const void* q, const void* s, void* out, int out_f32,
           void* ws, void* counters, int B, int in_f, int out_f, int g, int cols, int n_split,
           int per_split, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const int8_t* qt = static_cast<const int8_t*>(q);
  const S* st_ = static_cast<const S*>(s);
  if (transposed) {
    if constexpr (sizeof(T) == 2) {
      const int grid = (out_f + kTileRows - 1) / kTileRows;
      const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xt);
      if (B <= 8)
        qmm_mma<BITS, 1, S><<<grid, kThreads, 0, st>>>(xb, qt, st_, out, out_f32, B, in_f,
                                                        out_f, g);
      else
        qmm_mma<BITS, 4, S><<<grid, kThreads, 0, st>>>(xb, qt, st_, out, out_f32, B, in_f,
                                                        out_f, g);
    } else {
      int grid = (out_f + kWarps - 1) / kWarps;
      if (grid > max_blocks()) grid = max_blocks();
      qmm_transposed<MAXB, BITS, T, S><<<grid, kThreads, 0, st>>>(xt, qt, st_, out, out_f32,
                                                                  B, in_f, out_f, g);
    }
  } else {
    constexpr int C = NatCols<MAXB>::C;
    const int k = BITS == 4 ? in_f / 2 : in_f;
    if (cols != C || per_split < 1 || n_split != (k + per_split - 1) / per_split)
      return (int)cudaErrorInvalidValue;
    const size_t stage = sizeof(float) * (BITS == 4 ? 2 : 1) * B * per_split;
    const size_t reduce = sizeof(float) * kWarps * B * 32 * C;
    const size_t smem = stage > reduce ? stage : reduce;
    auto kernel = qmm_natural<MAXB, BITS, T, S>;
    const int err = set_smem(kernel, smem);
    if (err) return err;
    dim3 grid((out_f + 32 * C - 1) / (32 * C), n_split);
    kernel<<<grid, kThreads, smem, st>>>(xt, qt, st_, out, out_f32, static_cast<float*>(ws),
                                         static_cast<int*>(counters), B, in_f, out_f, g,
                                         per_split);
  }
  return (int)cudaGetLastError();
}

template <int BITS, typename T, typename S>
int by_rows(int transposed, const void* x, const void* q, const void* s, void* out, int out_f32,
            void* ws, void* counters, int B, int in_f, int out_f, int g, int cols, int n_split,
            int per_split, cudaStream_t st) {
  if (B == 1)
    return launch<1, BITS, T, S>(transposed, x, q, s, out, out_f32, ws, counters, B, in_f,
                                 out_f, g, cols, n_split, per_split, st);
  if (B <= 8)
    return launch<8, BITS, T, S>(transposed, x, q, s, out, out_f32, ws, counters, B, in_f,
                                 out_f, g, cols, n_split, per_split, st);
  return launch<32, BITS, T, S>(transposed, x, q, s, out, out_f32, ws, counters, B, in_f, out_f,
                                g, cols, n_split, per_split, st);
}

template <typename T, typename S>
int by_bits(int bits, int transposed, const void* x, const void* q, const void* s, void* out,
            int out_f32, void* ws, void* counters, int B, int in_f, int out_f, int g, int cols,
            int n_split, int per_split, cudaStream_t st) {
  if (bits == 4)
    return by_rows<4, T, S>(transposed, x, q, s, out, out_f32, ws, counters, B, in_f, out_f, g,
                            cols, n_split, per_split, st);
  return by_rows<8, T, S>(transposed, x, q, s, out, out_f32, ws, counters, B, in_f, out_f, g,
                          cols, n_split, per_split, st);
}

}  // namespace

extern "C" {

// x: [B, in] bf16 (x_bf16=1) or f32; q: int8 as described above; s: f32 or
// bf16 (s_bf16=1); out: [B, out] in x's dtype, or f32 with out_f32=1 (the
// sums not rounded to x's dtype). 1 <= B <= 32, in % 32 == 0, g % 16 == 0
// and in % g == 0 (checked by the caller). Non-transposed only: the
// wrapper's plan (ops/quant_matmul.py natural_plan) of `cols` columns a
// thread and n_split blocks of per_split packed rows along k; ws: f32
// [n_split, B, out] (unused when n_split is 1); counters: one int32 per strip
// of 32 * cols columns, zero before the first launch (each launch leaves
// them zero).
int quant_matmul(const void* x, const void* q, const void* s, void* out, void* ws,
                 void* counters, int B, int in_f, int out_f, int g, int bits, int transposed,
                 int x_bf16, int s_bf16, int out_f32, int cols, int n_split, int per_split,
                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && s_bf16)
    return by_bits<__nv_bfloat16, __nv_bfloat16>(bits, transposed, x, q, s, out, out_f32, ws,
                                                 counters, B, in_f, out_f, g, cols, n_split,
                                                 per_split, st);
  if (x_bf16)
    return by_bits<__nv_bfloat16, float>(bits, transposed, x, q, s, out, out_f32, ws, counters,
                                         B, in_f, out_f, g, cols, n_split, per_split, st);
  if (s_bf16)
    return by_bits<float, __nv_bfloat16>(bits, transposed, x, q, s, out, out_f32, ws, counters,
                                         B, in_f, out_f, g, cols, n_split, per_split, st);
  return by_bits<float, float>(bits, transposed, x, q, s, out, out_f32, ws, counters, B, in_f,
                               out_f, g, cols, n_split, per_split, st);
}

}  // extern "C"
