// Merged post-attention block for W4A8 / W8A8 decode, Hopper (sm_90a): ONE
// cooperative launch per layer.
//
// Replaces metalchat_tpu/ops/ffn_block_pallas.py: ffn_block_stacked
// (_ffn_block_kernel). For rows b < B <= 16:
//   x2  = x + T(wo(attn))                               (phase A)
//   xn  = T(rmsnorm(x2) * (offset + norm_w))            (prologue of phase B)
//   h   = T(act_f32(gate) * up),  [gate | up] = w13(xn) (phase B)
//   out = x2 + T(w2(h))                                 (phase C)
// where every linear is the W4A8/W8A8 matvec of a8_matvec.cu: per-token int8
// act-quant of its input, s8 x s8 -> s32 against the layer's packed weights
// [out, in(/2)], then T(acc * sx * s_col). The activation runs in f32 (silu or
// gelu_tanh), as in the TPU kernel.
//
// What bounds it on the H100: the weight stream of wo, w13 and w2 (out*in/2
// bytes each for int4), as for the separate matvecs. Two grid-wide
// dependencies sit inside the block (the norm of x2 needs every wo output,
// the act-quant of h needs all of F), so the phases meet at
// cooperative_groups::this_grid().sync(); at most as many blocks as can be
// resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor with the
// ring's shared memory), launched with cudaLaunchCooperativeKernel.
//
// PR 7's kernel quantized each phase's whole input in every block, one row
// after another, straight from global memory, while HBM sat idle, and it
// stopped the weight stream at each sync. Here the weights stream from the
// first cycle and through the syncs: every block walks its tiles of each
// phase through one ring of kStages stages of 16 KB in shared memory
// (Ring below: 1-D bulk copies on an mbarrier a stage, issued by warp
// 0), whose feed runs on from wo into w13 and w2, so the first stages of the
// next phase are in flight while the grid syncs and the next prologue runs
// (the weights are read-only, so loading them early is legal). The
// epilogues' scales and x are loaded into shared memory under the first
// prologue, and x2 stays there for phase C. The act-quant:
//   one row (NT = 0): each block quantizes the row itself (quantize_staged:
//     the row and norm weights staged in shared memory, a8_matvec's op
//     order), codes in shared memory; warp w dots row w of each 8-row tile
//     with dp4a (row_dot_chunk). Two syncs a layer. Measured faster on the
//     H100 than block 0 quantizing for all behind one more sync a phase, and
//     than the tensor-core tile below on the block's own codes (PERF.md, PR 8).
//   2-16 rows (NT = 1, 2; SHARED): block b quantizes row b once a phase and
//     writes its codes, sx and corr to the scratch the wrapper allocates; after
//     a sync every block reads the codes through L1 (plain loads, a stage
//     ahead; each phase has its own buffer, and the sync's acquire makes them
//     visible). The dot is a8_mma_kernel's tensor-core tile (common.cuh
//     mma_step / mma_reduce) on tiles of 16 rows, k split over the 8 warps in
//     64-byte steps; stage rows are padded to 1088 bytes so that the lanes'
//     16-byte reads of rows g and g + 8 fall in distinct banks. Five syncs a
//     layer.
// The codes, integer sums and f32 epilogues are those of the separate
// matvecs; x2 and h live in device memory the wrapper allocates.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// 16 bytes of int8 codes from the scratch, through L1 (`ld.global.ca`:
// codes another block wrote before a grid-wide sync, whose acquire makes a
// plain load see them; never `.nc`).
__device__ __forceinline__ int4 load_codes(const int8_t* p) {
  return __ldca(reinterpret_cast<const int4*>(p));
}

// Integer dot products of one weight row with one row of int8 codes, a chunk
// at a time: `len` bytes of the row (16-byte aligned, len % 16 == 0) at byte
// column c0 of its k = in_f/2 packed int4 bytes (half-split, offset-binary
// low nibble) or in_f int8 bytes, against the codes xq [in_f] in shared
// memory; one warp, 16-byte loads, neighbouring lanes on neighbouring
// addresses. The int4 nibbles are never unpacked: dp4a on (p & 0x0F0F0F0F)
// gives sum x_lo*(lo+8) into lo and on (p & 0xF0F0F0F0) 16*sum x_hi*hi into
// hi, both exact; row_dot_total finishes them with corr = 8*sum(x_lo) and an
// arithmetic >> 4 (the TPU kernel's identities). Integer sums are
// order-free, so the totals are exact whatever the chunking.
template <int BITS>
__device__ __forceinline__ void row_dot_chunk(const int8_t* wrow, int len, int c0,
                                              const int8_t* xq, int in_f, int& lo, int& hi) {
  const int lane = threadIdx.x & 31;
  const int half = in_f / 2;
#pragma unroll 4
  for (int c = lane * 16; c < len; c += 32 * 16) {
    const int4 w = *reinterpret_cast<const int4*>(wrow + c);
    if (BITS == 4) {
      const int4 xl = *reinterpret_cast<const int4*>(xq + c0 + c);
      const int4 xh = *reinterpret_cast<const int4*>(xq + half + c0 + c);
      const int ml = 0x0F0F0F0F, mh = (int)0xF0F0F0F0u;
      lo = __dp4a(w.x & ml, xl.x, lo);
      lo = __dp4a(w.y & ml, xl.y, lo);
      lo = __dp4a(w.z & ml, xl.z, lo);
      lo = __dp4a(w.w & ml, xl.w, lo);
      hi = __dp4a(w.x & mh, xh.x, hi);
      hi = __dp4a(w.y & mh, xh.y, hi);
      hi = __dp4a(w.z & mh, xh.z, hi);
      hi = __dp4a(w.w & mh, xh.w, hi);
    } else {
      const int4 xv = *reinterpret_cast<const int4*>(xq + c0 + c);
      lo = __dp4a(w.x, xv.x, lo);
      lo = __dp4a(w.y, xv.y, lo);
      lo = __dp4a(w.z, xv.z, lo);
      lo = __dp4a(w.w, xv.w, lo);
    }
  }
}

// The row's total over the warp, on every lane (see row_dot_chunk).
template <int BITS>
__device__ __forceinline__ int row_dot_total(int lo, int hi, int corr) {
  const int t = warp_sum_int(lo);
  return BITS == 4 ? (t - corr) + (warp_sum_int(hi) >> 4) : t;
}

// -- Weight tiles streamed through a ring in shared memory --------------------
//
// ffn_block's three matvecs are a read of the weights and little else, so
// HBM must stream from the launch's first cycle, under the act-quant
// prologues and the grid-wide syncs. A block walks tiles of ROWS weight rows
// (blockIdx.x, + gridDim.x, ...); each tile's k bytes are cut into chunks of
// up to CHUNK bytes, and one stage of the ring holds one chunk of one tile:
// ROWS rows, row r at byte r * PITCH. Warp 0 fills a stage with 1-D bulk
// copies (cp.async.bulk, completing on the stage's mbarrier), one a live
// row, lanes in parallel (one for the stage where whole rows lie back to
// back); every thread waits on that mbarrier before reading the stage. A
// stage is refilled only after a __syncthreads that follows every read of it
// (the consumers' release). NS stages are in flight before the prologue.

__device__ __forceinline__ uint32_t shared_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A matvec's weights [rows][k] (k % 16 == 0, 16-byte aligned) as this block
// streams them. A tile may hold SUBS sub-tiles, sub-tile j of tile u at rows
// j * sub_stride + u * ROWS (w13: the gate rows, then the up rows F later).
template <int ROWS, int CHUNK>
struct WeightStream {
  const int8_t* p;
  int rows, k, subs, sub_stride, nk, stages;

  WeightStream() = default;
  __device__ WeightStream(const int8_t* p_, int rows_, int k_, int subs_ = 1, int stride_ = 0)
      : p(p_), rows(rows_), k(k_), subs(subs_), sub_stride(stride_) {
    nk = (k + CHUNK - 1) / CHUNK;
    const int tiles = (rows + ROWS - 1) / ROWS;
    const int mine = tiles > (int)blockIdx.x ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
    stages = mine * subs * nk;
  }
  // Stage s of this block: tile, sub-tile and chunk.
  __device__ int tile(int s) const { return blockIdx.x + s / (subs * nk) * gridDim.x; }
  __device__ int sub(int s) const { return s / nk % subs; }
  __device__ int chunk(int s) const { return s % nk; }
  __device__ bool last_chunk(int s) const { return s % nk == nk - 1; }
  __device__ int len(int s) const { return min(CHUNK, k - chunk(s) * CHUNK); }
  __device__ int live_rows(int s) const { return min(ROWS, rows - tile(s) * ROWS); }
};

template <int NS, int ROWS, int CHUNK, int PITCH>
struct Ring {
  static constexpr int kStageBytes = ROWS * PITCH;
  using Stream = WeightStream<ROWS, CHUNK>;
  int8_t* buf;          // [NS][ROWS][PITCH], 16-byte aligned
  uint64_t* full;       // [NS] mbarriers
  uint32_t used = 0;    // stages consumed (every thread counts)
  uint32_t issued = 0;  // stages issued (warp 0 counts)

  // Warp 0, before any use; a __syncthreads must follow.
  __device__ void init() {
    if (threadIdx.x == 0) {
      for (int i = 0; i < NS; ++i)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(shared_u32(&full[i]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncwarp();
  }

  // Warp 0: stage s of `st` into the next slot (a free one: issued - used <
  // NS). Lane r copies row r; whole rows that lie back to back in both
  // places (k == PITCH) go in one copy.
  __device__ void issue(const Stream& st, int s) {
    const int lane = threadIdx.x & 31;
    const int slot = issued % NS;
    const int live = st.live_rows(s);
    const uint32_t len = st.len(s);
    const int8_t* src = st.p + ((size_t)st.sub(s) * st.sub_stride + (size_t)st.tile(s) * ROWS) *
                                   st.k + (size_t)st.chunk(s) * CHUNK;
    int8_t* dst = buf + slot * kStageBytes;
    const uint32_t bar = shared_u32(&full[slot]);
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                   "r"(live * len) : "memory");
    __syncwarp();
    const bool whole = st.k == PITCH && len == (uint32_t)PITCH;
    for (int r = lane; r < (whole ? 1 : live); r += 32)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];" ::"r"(shared_u32(dst + r * PITCH)), "l"(src + (size_t)r * st.k),
          "r"(whole ? live * len : len), "r"(bar) : "memory");
    ++issued;
  }

  // Every thread: the next stage to consume, once its bytes have landed.
  __device__ const int8_t* wait() const {
    const int slot = used % NS;
    const uint32_t bar = shared_u32(&full[slot]), parity = (used / NS) & 1;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
          "selp.u32 %0, 1, 0, p; }"
          : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return buf + slot * kStageBytes;
  }

  // Every thread, after a __syncthreads that follows its last read of the
  // stage: the slot is free, and warp 0 refills it from `feed`.
  template <typename Feed>
  __device__ void release(Feed& feed) {
    ++used;
    if (threadIdx.x < 32) feed.next(*this);
  }
};

// The stages of N streams in order, as warp 0 issues them: the next
// stream's first stages follow the last of the one before, so a phase's
// weights stream while the phase before it ends.
template <int N, typename R>
struct Feed {
  typename R::Stream st[N];
  int cur = 0, s = 0;

  __device__ void next(R& ring) {
    while (cur < N && s >= st[cur].stages) { ++cur; s = 0; }
    if (cur < N) ring.issue(st[cur], s++);
  }
  // Warp 0: set up a fresh ring and fill every slot; a __syncthreads must follow.
  __device__ void start(R& ring, int ns) {
    ring.init();
    for (int i = 0; i < ns; ++i) next(ring);
  }
};

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 3;  // 4 and 6 were slower at 1 and 8 rows on the H100
constexpr int kMaxRows = 16;

struct Args {
  const void* attn;   // [B, H] in T
  const void* x;      // [B, H] in T
  const int8_t* wo;   // [H, kwo]   (layer l)
  const void* wo_s;   // [H]        in S
  const void* nw;     // [H]        in T
  const int8_t* w13;  // [2F, k13]
  const void* w13_s;  // [2F]
  const int8_t* w2;   // [H, k2]
  const void* w2_s;   // [H]
  void* x2;           // scratch [B, H] in T
  void* h;            // scratch [B, F] in T
  void* out;          // [B, H] in T
  int8_t* codes;      // scratch [3][B * max(H, F)]: each phase's codes [B][n] (SHARED)
  float* sx;          // scratch [3][B]
  int* corr;          // scratch [3][B]
  int B, H, F, act;   // act: 0 silu, 1 gelu_tanh
  float eps, offset;
};

__device__ __forceinline__ float activation(float g, int act) {
  if (act == 1) {  // gelu, tanh approximation (PyTorch's constants)
    const float kBeta = 0.7978845608028654f;  // sqrt(2 / pi)
    const float kKappa = 0.044715f;
    const float cube = g * g * g;
    return 0.5f * g * (1.f + tanhf(kBeta * (g + kKappa * cube)));
  }
  return g / (1.f + expf(-g));  // silu
}

// The ring's geometry by route: tiles of 8 rows (a warp each) and 2 KB
// chunks at one row; tiles of 16 rows (the mma's M) and 1 KB chunks in rows
// padded to 1088 bytes at 2-16 rows. 16 KB of weights a stage either way.
template <int NT>
struct Geometry {
  static constexpr int kRows = NT == 0 ? 8 : kMmaRows;
  static constexpr int kChunk = NT == 0 ? 2048 : 1024;
  static constexpr int kPitch = NT == 0 ? kChunk : kChunk + 64;
  using R = Ring<kStages, kRows, kChunk, kPitch>;
};

// Where a phase's codes are: in the block's shared memory (each block
// quantized the row itself) or in the launch's scratch (SHARED).
struct Codes {
  const int8_t* q;  // [B][n]
  const float* sx;  // [B]
  const int* corr;  // [B]
};

// One phase's act-quant of src [B][n]. Own codes (one row, !SHARED): every
// block, into q_s (shared memory). SHARED: block b < B quantizes row b and
// writes the scratch of phase `ph`; after a grid sync every block copies the
// scales and corrections into sx_s and corr_s. Either way sx_s / corr_s
// [B] (shared memory) hold them.
template <int BITS, bool SHARED, bool NORM, bool COHERENT, typename T>
__device__ Codes prologue(const Args& a, cg::grid_group& grid, int ph, const T* src, int n,
                          const T* nw, T* xs, int8_t* q_s, float* sx_s, int* corr_s,
                          float* scratch, int* iscratch) {
  const float eps = NORM ? a.eps : 0.f, offset = NORM ? a.offset : 0.f;
  T* nws = xs + n;  // the staged norm weights (NORM: n = H)
  if (!SHARED) {
    quantize_staged<T, NORM, COHERENT>(src, nw, n, eps, offset, xs, nws, q_s, sx_s,
                                       BITS == 4 ? corr_s : nullptr, scratch, iscratch);
    return {q_s, sx_s, corr_s};
  }
  int8_t* q = a.codes + (size_t)ph * a.B * (a.H > a.F ? a.H : a.F);  // rows of n codes
  float* sx = a.sx + ph * a.B;
  int* corr = a.corr + ph * a.B;
  const int b = blockIdx.x;
  if (b < a.B)  // the codes go straight to the scratch
    quantize_staged<T, NORM, COHERENT>(src + (size_t)b * n, nw, n, eps, offset, xs, nws,
                                       q + (size_t)b * n, &sx[b],
                                       BITS == 4 ? &corr[b] : nullptr, scratch, iscratch);
  grid.sync();
  if (threadIdx.x < a.B) {
    sx_s[threadIdx.x] = __ldcg(sx + threadIdx.x);
    if (BITS == 4) corr_s[threadIdx.x] = __ldcg(corr + threadIdx.x);
  }
  __syncthreads();
  return {q, sx_s, corr_s};
}

// One row: consume a phase's stages, warp w on row w of each tile;
// finish(row, sub-tile, total) on every lane of the warp.
template <int BITS, typename R, typename Fd, typename Finish>
__device__ void run_rows(R& ring, Fd& feed, const typename R::Stream& st, const Codes& c,
                         int in_f, Finish&& finish) {
  using G = Geometry<0>;
  const int warp = threadIdx.x >> 5;
  const int corr = BITS == 4 ? c.corr[0] : 0;
  int lo = 0, hi = 0;
  for (int s = 0; s < st.stages; ++s) {
    const int8_t* tile = ring.wait();
    const int r = st.tile(s) * G::kRows + warp;  // warp-uniform
    if (r < st.rows)
      row_dot_chunk<BITS>(tile + warp * G::kPitch, st.len(s), st.chunk(s) * G::kChunk,
                                   c.q, in_f, lo, hi);
    if (st.last_chunk(s)) {
      if (r < st.rows) finish(r, st.sub(s), row_dot_total<BITS>(lo, hi, corr));
      lo = hi = 0;
    }
    __syncthreads();  // every read of the stage is done: release it
    ring.release(feed);
  }
}

// 2-16 rows: consume a phase's stages on the int8 tensor cores;
// finish(row, sub-tile, b, total) once for each live (row, code row).
template <int BITS, int NT, typename R, typename Fd, typename Finish>
__device__ void run_mma(R& ring, Fd& feed, const typename R::Stream& st, const Codes& c,
                        int in_f, int B, int* red, Finish&& finish) {
  using G = Geometry<NT>;
  constexpr int NA = mma_terms<BITS, false>();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int half = in_f / 2;
  const int8_t* xr[NT];
  bool xlive[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    xlive[j] = 8 * j + g < B;
    xr[j] = c.q + (size_t)(xlive[j] ? 8 * j + g : 0) * in_f + 16 * t;
  }
  int acc[NT][NA][4];
  auto clear = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[j][a][i] = 0;
  };
  clear();
  const int4 zero = make_int4(0, 0, 0, 0);
  // A warp's steps of a stage (steps w, w + kMmaSplit, ... of its chunk) and
  // their codes, loaded a stage ahead: the codes come through L1 or L2, and
  // a stage whose mmas waited for them would hold the ring.
  constexpr int kPer = G::kChunk / kMmaStep / kMmaSplit;
  int4 xl[kPer][NT], xh[kPer][NT];
  auto load_codes_of = [&](int s) {
    const int len = st.len(s), c0 = st.chunk(s) * G::kChunk;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int off = (warp + i * kMmaSplit) * kMmaStep;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const bool x_in = off + 16 * t < len && xlive[j];
        xl[i][j] = x_in ? load_codes(xr[j] + c0 + off) : zero;
        xh[i][j] = x_in && BITS == 4 ? load_codes(xr[j] + half + c0 + off) : zero;
      }
    }
  };
  if (st.stages > 0) load_codes_of(0);
  for (int s = 0; s < st.stages; ++s) {
    const int8_t* tile = ring.wait();
    int4 cl[kPer][NT], ch[kPer][NT];
#pragma unroll
    for (int i = 0; i < kPer; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        cl[i][j] = xl[i][j];
        ch[i][j] = xh[i][j];
      }
    if (s + 1 < st.stages) load_codes_of(s + 1);
    const int len = st.len(s);
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int col = (warp + i * kMmaSplit) * kMmaStep + 16 * t;
      const bool in = col < len;  // len % 16 == 0: a 16-byte chunk is all in or out
      const int4 wa = in ? *reinterpret_cast<const int4*>(tile + g * G::kPitch + col) : zero;
      const int4 wb = in ? *reinterpret_cast<const int4*>(tile + (g + 8) * G::kPitch + col)
                         : zero;
      mma_step<BITS, NT, NA, false>(acc, wa, wb, cl[i], ch[i]);
    }
    if (st.last_chunk(s)) {
      const int tile_row = st.tile(s) * G::kRows, sub = st.sub(s);
      mma_reduce<NT, NA>(acc, red, B, [&](int r, int b, const int* tot) {
        if (tile_row + r >= st.rows) return;
        const int total = BITS == 4 ? (tot[0] - c.corr[b]) + (tot[1] >> 4) : tot[0];
        finish(tile_row + r, sub, b, total);
      });
      clear();
    }
    __syncthreads();  // every read of the stage (and of red) is done: release it
    ring.release(feed);
  }
}

template <int BITS, int NT, typename T, typename S>
__global__ void __launch_bounds__(kThreads) ffn_block_kernel(Args a) {
  constexpr bool SHARED = NT > 0;  // 2-16 rows share each phase's codes
  using G = Geometry<NT>;
  using R = typename G::R;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ float sx_s[kMaxRows];
  __shared__ int corr_s[kMaxRows];
  __shared__ float scratch[kWarps];
  __shared__ int iscratch[kWarps];
  __shared__ float gate_s[NT == 0 ? 1 : kMmaRows][NT == 0 ? 1 : kMaxRows];
  cg::grid_group grid = cg::this_grid();

  const int B = a.B, H = a.H, F = a.F;
  const int nmax = H > F ? H : F;
  const int pack = BITS == 4 ? 2 : 1;
  R ring{reinterpret_cast<int8_t*>(smem), full};
  // The codes (own codes: [nmax]), then the staged row and norm weights
  // ([max(F, 2H)]; with SHARED only blocks b < B use them).
  int8_t* q_s = reinterpret_cast<int8_t*>(smem + kStages * R::kStageBytes);
  T* xs = reinterpret_cast<T*>(q_s + (SHARED ? 0 : nmax));
  constexpr int NA = mma_terms<BITS, false>();
  int* red = reinterpret_cast<int*>(xs + (F > 2 * H ? F : 2 * H));  // (NT > 0)
  // red: [kMmaSplit][NT * NA * 4][32]. Then the epilogues' operands for the
  // block's rows, f32, loaded under the first prologue (an epilogue that
  // waited on global memory would hold its stage): the scales of wo (sA),
  // w2 (sC), gate and up (sG, sU), x and then x2 (xA, x2s [row][b]).
  float* sA = reinterpret_cast<float*>(red + (NT == 0 ? 0 : kMmaSplit * NT * NA * 4 * 32));
  const int nA = ((H + G::kRows - 1) / G::kRows + gridDim.x - 1) / gridDim.x * G::kRows;
  const int nB = ((F + G::kRows - 1) / G::kRows + gridDim.x - 1) / gridDim.x * G::kRows;
  float* sC = sA + nA;
  float* sG = sC + nA;
  float* sU = sG + nB;
  float* xA = sU + nB;
  float* x2s = xA + nA * B;
  // The block-local index of row o of its tiles.
  auto local = [](int o) {
    return ((o / G::kRows - (int)blockIdx.x) / (int)gridDim.x) * G::kRows + o % G::kRows;
  };
  Feed<3, R> feed{{typename R::Stream(a.wo, H, H / pack),
                   typename R::Stream(a.w13, F, H / pack, 2, F),
                   typename R::Stream(a.w2, H, F / pack)}};
  if (threadIdx.x < 32) feed.start(ring, kStages);  // wo streams under the first prologue
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const T* x = static_cast<const T*>(a.x);
  T* x2 = static_cast<T*>(a.x2);
  T* h = static_cast<T*>(a.h);
  T* out = static_cast<T*>(a.out);
  const S* wo_s = static_cast<const S*>(a.wo_s);
  const S* w13_s = static_cast<const S*>(a.w13_s);
  const S* w2_s = static_cast<const S*>(a.w2_s);
  for (int l = threadIdx.x; l < nA; l += blockDim.x) {
    const int o = (blockIdx.x + l / G::kRows * gridDim.x) * G::kRows + l % G::kRows;
    const bool in = o < H;
    sA[l] = in ? to_f32<S>(wo_s[o]) : 0.f;
    sC[l] = in ? to_f32<S>(w2_s[o]) : 0.f;
    for (int b = 0; b < B; ++b) xA[l * B + b] = in ? to_f32<T>(x[(size_t)b * H + o]) : 0.f;
  }
  for (int l = threadIdx.x; l < nB; l += blockDim.x) {
    const int j = (blockIdx.x + l / G::kRows * gridDim.x) * G::kRows + l % G::kRows;
    sG[l] = j < F ? to_f32<S>(w13_s[j]) : 0.f;
    sU[l] = j < F ? to_f32<S>(w13_s[F + j]) : 0.f;
  }

  // Each phase: the act-quant, then the stream; finish(o, sub, b, total).
  auto phase = [&](const typename R::Stream& st, const Codes& c, int in_f, auto&& finish) {
    if constexpr (NT == 0) {
      run_rows<BITS>(ring, feed, st, c, in_f, [&](int o, int sub, int total) {
        finish(o, sub, 0, total);
      });
    } else {
      run_mma<BITS, NT>(ring, feed, st, c, in_f, B, red, finish);
    }
  };

  // Phase A: x2 = x + wo(attn).
  Codes c = prologue<BITS, SHARED, false, false>(a, grid, 0, static_cast<const T*>(a.attn), H,
                                                 static_cast<const T*>(nullptr), xs, q_s, sx_s,
                                                 corr_s, scratch, iscratch);
  phase(feed.st[0], c, H, [&](int o, int, int b, int t) {
    if (NT == 0 && lane != 0) return;
    const int l = local(o);
    const float y = round_through<T>(((float)t * c.sx[b]) * sA[l]);
    const T v = from_f32<T>(xA[l * B + b] + y);
    x2[(size_t)b * H + o] = v;
    x2s[l * B + b] = to_f32<T>(v);
  });
  grid.sync();

  // Phase B: h = act(gate(xn)) * up(xn), xn the normed x2.
  c = prologue<BITS, SHARED, true, true>(a, grid, 1, x2, H, static_cast<const T*>(a.nw), xs,
                                         q_s, sx_s, corr_s, scratch, iscratch);
  float gate = 0.f;  // one row: the warp's gate value, between its two sub-tiles
  phase(feed.st[1], c, H, [&](int j, int sub, int b, int t) {
    const float sx = c.sx[b];
    const int l = local(j);
    if (sub == 0) {
      const float g = ((float)t * sx) * sG[l];
      if constexpr (NT == 0) gate = g; else gate_s[j % kMmaRows][b] = g;
      return;
    }
    if (NT == 0 && lane != 0) return;
    const float up = ((float)t * sx) * sU[l];
    const float g = NT == 0 ? gate : gate_s[j % kMmaRows][b];
    h[(size_t)b * F + j] = from_f32<T>(activation(g, a.act) * up);
  });
  grid.sync();

  // Phase C: out = x2 + w2(h).
  c = prologue<BITS, SHARED, false, true>(a, grid, 2, static_cast<const T*>(h), F,
                                          static_cast<const T*>(nullptr), xs, q_s, sx_s, corr_s,
                                          scratch, iscratch);
  phase(feed.st[2], c, F, [&](int o, int, int b, int t) {
    if (NT == 0 && lane != 0) return;
    const int l = local(o);
    const float ffn = round_through<T>(((float)t * c.sx[b]) * sC[l]);
    out[(size_t)b * H + o] = from_f32<T>(x2s[l * B + b] + ffn);
  });
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

// Resident blocks of `kernel` an SM at `threads` threads and `smem` bytes of
// dynamic shared memory (0 on error), remembered for the few (kernel, size)
// pairs a model asks for.
int blocks_per_sm(const void* kernel, int threads, size_t smem) {
  static const void* kernels[16];
  static size_t sizes[16];
  static int blocks[16];
  static int n = 0;
  for (int i = 0; i < n; ++i)
    if (kernels[i] == kernel && sizes[i] == smem) return blocks[i];
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
      cudaSuccess)
    return 0;
  if (n < 16) {
    kernels[n] = kernel;
    sizes[n] = smem;
    blocks[n++] = per_sm;
  }
  return per_sm;
}

template <int BITS, int NT, typename T, typename S>
int launch(Args a, cudaStream_t stream) {
  using G = Geometry<NT>;
  constexpr bool SHARED = NT > 0;
  auto kernel = ffn_block_kernel<BITS, NT, T, S>;
  const int nmax = a.H > a.F ? a.H : a.F;
  constexpr int NA = mma_terms<BITS, false>();
  const int staged = a.F > 2 * a.H ? a.F : 2 * a.H;  // a row, or x2 and the norm weights
  // The epilogues' operands: at most as many rows a block as with one block
  // an SM (a grid is never smaller unless the tiles are fewer still).
  const int sms = sm_count();
  const int nA = ((a.H + G::kRows - 1) / G::kRows + sms - 1) / sms * G::kRows;
  const int nB = ((a.F + G::kRows - 1) / G::kRows + sms - 1) / sms * G::kRows;
  const size_t smem = (size_t)kStages * G::R::kStageBytes + (SHARED ? 0 : nmax) +
                      staged * sizeof(T) +
                      (NT == 0 ? 0 : (size_t)kMmaSplit * NT * NA * 4 * 32 * sizeof(int)) +
                      (size_t)(2 * nA + 2 * nB + 2 * nA * a.B) * sizeof(float);
  static size_t configured = 0;
  if (smem > configured) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  const int per_sm = blocks_per_sm((const void*)kernel, kThreads, smem);
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  // Every phase's tiles spread over the grid; with SHARED, block b quantizes row b.
  int grid = (nmax + G::kRows - 1) / G::kRows;
  if (grid > per_sm * sm_count()) grid = per_sm * sm_count();
  if (SHARED && grid < a.B) grid = a.B;
  if (grid > per_sm * sm_count()) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  cudaError_t err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(kThreads),
                                                args, smem, stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BITS, typename T, typename S>
int by_rows(Args a, cudaStream_t st) {
  if (a.B == 1) return launch<BITS, 0, T, S>(a, st);
  if (a.B <= 8) return launch<BITS, 1, T, S>(a, st);
  return launch<BITS, 2, T, S>(a, st);
}

template <typename T, typename S>
int by_bits(int bits, Args a, cudaStream_t st) {
  if (bits == 4) return by_rows<4, T, S>(a, st);
  return by_rows<8, T, S>(a, st);
}

}  // namespace

extern "C" {

// attn, x, out: [B, H] bf16 (x_bf16=1) or f32; wo [H, H(/2)], w13 [2F, H(/2)],
// w2 [H, F(/2)] int8 (layer l); wo_s [H], w13_s [2F], w2_s [H] f32 or bf16
// (s_bf16=1); nw [H] in x's dtype; x2 [B, H] and h [B, F] scratch in x's
// dtype; codes [3][B][max(H, F)] int8, sx [3][B] f32, corr [3][B] int32
// scratch at 2-16 rows (unused at one row, may be NULL). 1 <= B <= 16,
// H % 32 == 0, F % 32 == 0 (checked by the caller); every pointer 16-byte
// aligned.
int ffn_block(const void* attn, const void* x, const void* wo, const void* wo_s,
              const void* nw, const void* w13, const void* w13_s, const void* w2,
              const void* w2_s, void* x2, void* h, void* out, void* codes, void* sx,
              void* corr, int B, int H, int F, int bits, int act, int x_bf16, int s_bf16,
              float eps, float offset, void* stream) {
  Args a{attn, x, static_cast<const int8_t*>(wo), wo_s, nw,
         static_cast<const int8_t*>(w13), w13_s, static_cast<const int8_t*>(w2), w2_s,
         x2, h, out, static_cast<int8_t*>(codes), static_cast<float*>(sx),
         static_cast<int*>(corr), B, H, F, act, eps, offset};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16 && s_bf16) return by_bits<__nv_bfloat16, __nv_bfloat16>(bits, a, st);
  if (x_bf16) return by_bits<__nv_bfloat16, float>(bits, a, st);
  if (s_bf16) return by_bits<float, __nv_bfloat16>(bits, a, st);
  return by_bits<float, float>(bits, a, st);
}

}  // extern "C"
