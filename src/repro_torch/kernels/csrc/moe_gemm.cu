// Grouped-expert SwiGLU over sorted ragged segments — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py (moe_grouped_ffn_pallas:
// _grouped_ffn_fwd, body _kernel, schedule make_group_metadata).
//
// What it computes.  x (T, d) holds rows sorted by group: segment g is the
// group_sizes[g] consecutive rows after the segments before it (empty
// segments allowed).  Row r of segment g uses expert e = group_experts[g]
// (e = g when no map is given) and becomes
//   h_r = silu(x_r . Wg[e]) * (x_r . Wu[e])      in f32
//   y_r = h_r . Wd[e]                             in f32, stored in x's type
// with Wg/Wu (E, d, f) and Wd (E, f, d).  Rows past sum(group_sizes) are
// written as zeros.  A non-empty group whose expert lies outside [0, E)
// has its rows written as NaN: the kernel cannot raise, and a NaN is loud.
//
// Schedule.  The TPU kernel walks a sequential grid of "logical tiles", one
// per (group, row tile of M rows) pair a segment overlaps.  Here every
// logical tile is a row of blocks that run in parallel, in two launches:
//   1. up, grid (f tile, logical tile): h for the tile's rows;
//   2. down, grid (d tile, logical tile): y from h.
// h is per row, so each launch has its own M tile and its own logical
// tiles.  The column tile is the fast grid index, so the blocks that read
// one expert's columns (one logical tile, and the next tile of the same
// segment) run together and share the L2.  A block finds its tile on the
// device: warp 0 reads the G sizes 32 at a time and takes prefix sums of
// the rows and of the tiles each segment spans by shuffles, so the host
// never reads the sizes (no synchronisation per layer).  The grid is the
// static worst case, ceil(T/M) + G logical tiles: at most ceil(T/M) + G - 1
// are in use, so at least one block row is spare; spare blocks of the down
// launch zero the rows past sum(group_sizes), the others exit.
//
// Row invariance, bitwise.  A row's bits depend on the row and its expert
// alone: not on T, on the group sizes or on where the row sits in a tile.
// That is what keeps one-shot prefill == chunked prefill == decode for MoE
// models.  The order of every reduction is fixed by (d, f, dtype) alone:
// no split-K across blocks or warps, no atomics, the k16 steps in index
// order inside one warp.  The M and N tiles and the warps may change with
// T, because an mma.sync output element depends only on its own row of A
// and its own column of B.
//
// Bound.  Every byte is read once at best: x, the weights of the experts
// that have rows, and y; the products are 6 T d f operations.  At the
// serving shapes (granite: d 1536, f 512, 40 experts, T = 32 at decode and
// 2048 at prefill) the weights dominate, so the kernel is memory-bound:
//   (x + used experts' Wg, Wu, Wd + y) / 3.35 TB/s   (H100 SXM HBM3).
//
// bf16 runs on tensor cores.  What the first (SIMT) version had, and what
// this one does about it:
//   - Scalar 2-byte loads, few bytes in flight (about 5% of HBM at decode):
//     every tile of x, h and the weights comes by 16-byte cp.async through
//     a 3-stage ring of 64-deep k steps, two steps in flight while one is
//     multiplied, one barrier a step.
//   - No tensor cores: both products are mma.sync m16n8k16 (bf16 in, f32
//     accumulate).  The weights are the B operand as they lie, (d, f) and
//     (f, d) row-major with the output columns contiguous, into shared
//     tiles padded by 8 elements a row (the eight 16-byte rows an ldmatrix
//     reads fall on distinct banks), and reach the fragments by
//     ldmatrix.trans.  One ldmatrix.x4.trans brings the gate and the up
//     fragments of the same 8 columns, so silu(g) * u forms in registers.
//   - Weights re-read for every 16-row tile.  At prefill (segments of tens
//     of rows) the up launch takes 128-row tiles of 64 columns, 8 warps of
//     16 rows each, and a warp whose rows lie outside the tile's segment
//     skips its products; the down launch takes 64-row tiles of 128
//     columns, 8 warps of 16 x 64.  At T = 2048 over 40 experts that is
//     about 55 + 71 logical tiles instead of 168 + 168.  (64-row up tiles
//     with 4 warps were slower: one m16 fragment a warp reads the whole B
//     tile from shared memory, and there were more weight re-reads.)
//   - Too few blocks at decode (one expert a row or two): 16-row tiles,
//     the up launch 32 columns a block (about 24 logical tiles x 16 =
//     384 busy blocks on 132 SMs, each keeping about 20 KB in flight), the
//     down launch 128 (about 288 busy blocks).
//   - h keeps about 16 bits of its f32 value.  The down product's A
//     operand is bf16, so the up launch stores hi = bf16(h) and lo =
//     bf16(h - hi) (the bytes of the f32 scratch), and the down launch
//     accumulates hi . Wd then lo . Wd for every k16 step, in that order.
//   - The ragged edges are masked: columns past d or f are not stored,
//     rows outside the tile's segment and the reduction tails past d or f
//     are zero-filled by cp.async (source size 0).  d and f must be
//     multiples of 8, so each 16-byte copy is whole or absent.
//
// float32 runs on the card only in the checks (held to 2e-5, which bf16 or
// TF32 operands cannot meet): it keeps the SIMT kernels, 16-row tiles, one
// thread a column, each output element one thread's serial fmaf loop in
// index order, h through an f32 scratch.
//
// kernels/moe_gemm.py `plan` picks the route and each launch's tiles,
// warps, stages and shared memory from (T, d, f, E, G, dtype); the
// launcher refuses a plan that is not one of this file's configurations.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int kMaxGroups = 1024;  // MAX_GROUPS in moe_gemm.py
// float32, SIMT
constexpr int kRows = 16;         // rows per logical tile
constexpr int kCols = 64;         // output columns per block = threads
constexpr int kChunk = 128;       // reduction elements staged per step
// bfloat16, tensor cores
constexpr int kBK = 64;           // the k step: rows of a weight tile
constexpr int kPad = 8;           // row padding of a shared tile (elements)

// What warp 0 finds for logical tile `tile`.
struct TileInfo {
  int found;   // 1: rows [lo, hi) of group `group`
  int group;
  int lo;
  int hi;
  int used;    // when not found: logical tiles in use
  int total;   // when not found: rows covered by the segments
};

__device__ __forceinline__ int warp_inclusive_sum(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

// Run by the 32 lanes of warp 0.  Segment g covers rows [start, end)
// clamped to T (sizes below 0 count as 0) and overlaps row tiles
// start/M .. (end-1)/M; the logical tiles are those (group, row tile)
// pairs in order (the pairs make_group_metadata makes for block_t = M).
__device__ void find_tile(const int* __restrict__ sizes, int G, int T,
                          int M, int tile, TileInfo* info) {
  const int lane = threadIdx.x & 31;
  int rows = 0, tiles = 0;            // before this chunk of 32 groups
  int next = lane < G ? sizes[lane] : 0;
  for (int g0 = 0; g0 < G; g0 += 32) {
    const int g = g0 + lane;
    const int n = g < G ? min(max(next, 0), T) : 0;
    if (g + 32 < G) next = sizes[g + 32];   // in flight during the sums
    const int incl = warp_inclusive_sum(n, lane);
    const int start = min(rows + incl - n, T);
    const int end = min(rows + incl, T);
    const int span = end > start ? (end - 1) / M - start / M + 1 : 0;
    const int tincl = warp_inclusive_sum(span, lane);
    const int before = tiles + tincl - span;
    const unsigned hit = __ballot_sync(
        0xffffffffu, tile >= before && tile < before + span);
    if (hit) {                        // uniform across the warp
      if (lane == __ffs(hit) - 1) {
        const int m = start / M + (tile - before);
        info->found = 1;
        info->group = g;
        info->lo = max(start, m * M);
        info->hi = min(end, (m + 1) * M);
      }
      return;
    }
    rows = min(rows + __shfl_sync(0xffffffffu, incl, 31), T);
    tiles += __shfl_sync(0xffffffffu, tincl, 31);
  }
  if (lane == 0) {
    info->found = 0;
    info->used = tiles;
    info->total = rows;
  }
}

// Shared prologue of every launch: warp 0 finds the block's logical tile
// (blockIdx.y) for tiles of M rows.
__device__ __forceinline__ void locate(const int* __restrict__ sizes, int G,
                                       int T, int M, TileInfo* info) {
  if (threadIdx.x < 32) find_tile(sizes, G, T, M, blockIdx.y, info);
  __syncthreads();
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}
__device__ __forceinline__ float silu_mul(float g, float u) {
  return g / (1.f + expf(-g)) * u;
}

// Rows [total, rows) of columns [c0, c0 + n) of out, strided over the
// spare block rows (there is always at least one).
template <typename T>
__device__ void zero_tail(T* __restrict__ out, const TileInfo& info,
                          int rows, int d, int c0, int n) {
  const int spare = blockIdx.y - info.used;
  const int stride = gridDim.y - info.used;
  for (int r = info.total + spare; r < rows; r += stride)
    for (int c = threadIdx.x; c < n; c += blockDim.x)
      if (c0 + c < d) out[(long long)r * d + c0 + c] = from_f32<T>(0.f);
}

// Rows [lo, hi) of columns [c0, c0 + n) of out as NaN: the group's expert
// lies outside [0, E).
template <typename T>
__device__ void nan_rows(T* __restrict__ out, int lo, int hi, int d, int c0,
                         int n) {
  for (int r = lo; r < hi; ++r)
    for (int c = threadIdx.x; c < n; c += blockDim.x)
      if (c0 + c < d)
        out[(long long)r * d + c0 + c] =
            from_f32<T>(__int_as_float(0x7fc00000));
}

// ------------------------------------------------------------ f32 (SIMT)
// Launch 1: h[r, j] = silu(x_r . Wg[e][:, j]) * (x_r . Wu[e][:, j]).
__global__ void __launch_bounds__(kCols)
moe_up_simt(const float* __restrict__ x, const float* __restrict__ wg,
            const float* __restrict__ wu, const int* __restrict__ sizes,
            const int* __restrict__ experts, float* __restrict__ h, int rows,
            int d, int f, int E, int G) {
  __shared__ TileInfo info;
  __shared__ float x_s[kChunk][kRows];        // a chunk of d, 16 rows
  locate(sizes, G, rows, kRows, &info);
  if (!info.found) return;                    // uniform across the block
  const int lo = info.lo, n = info.hi - info.lo;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) return;                // the down launch writes NaN
  const int j = blockIdx.x * kCols + threadIdx.x;
  const float* wg_e = wg + (long long)e * d * f;
  const float* wu_e = wu + (long long)e * d * f;
  float g_acc[kRows], u_acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) g_acc[r] = u_acc[r] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    __syncthreads();                          // previous chunk consumed
    for (int i = threadIdx.x; i < kRows * kChunk; i += kCols) {
      const int r = i / kChunk, c = i - r * kChunk;
      x_s[c][r] = (r < n && c < kc) ? x[(long long)(lo + r) * d + k0 + c]
                                    : 0.f;
    }
    __syncthreads();
    if (j < f) {
      for (int c = 0; c < kc; ++c) {
        const long long w = (long long)(k0 + c) * f + j;
        const float wgv = wg_e[w];
        const float wuv = wu_e[w];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          g_acc[r] = fmaf(x_s[c][r], wgv, g_acc[r]);
          u_acc[r] = fmaf(x_s[c][r], wuv, u_acc[r]);
        }
      }
    }
  }
  if (j < f) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < n) h[(long long)(lo + r) * f + j] = silu_mul(g_acc[r], u_acc[r]);
  }
}

// Launch 2: y[r, c] = h_r . Wd[e][:, c]; spare blocks zero the tail rows.
__global__ void __launch_bounds__(kCols)
moe_down_simt(const float* __restrict__ h, const float* __restrict__ wd,
              const int* __restrict__ sizes,
              const int* __restrict__ experts, float* __restrict__ out,
              int rows, int d, int f, int E, int G) {
  __shared__ TileInfo info;
  __shared__ float h_s[kChunk][kRows];        // a chunk of f, 16 rows
  locate(sizes, G, rows, kRows, &info);
  const int c0 = blockIdx.x * kCols;
  if (!info.found) {
    zero_tail(out, info, rows, d, c0, kCols);
    return;
  }
  const int lo = info.lo, n = info.hi - info.lo;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) {
    nan_rows(out, lo, info.hi, d, c0, kCols);
    return;
  }
  const int c = c0 + threadIdx.x;
  const float* wd_e = wd + (long long)e * f * d;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < f; k0 += kChunk) {
    const int kc = min(kChunk, f - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kChunk; i += kCols) {
      const int r = i / kChunk, k = i - r * kChunk;
      h_s[k][r] = (r < n && k < kc) ? h[(long long)(lo + r) * f + k0 + k]
                                    : 0.f;
    }
    __syncthreads();
    if (c < d) {
      for (int k = 0; k < kc; ++k) {
        const float w = wd_e[(long long)(k0 + k) * d + c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h_s[k][r], w, acc[r]);
      }
    }
  }
  if (c < d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < n) out[(long long)(lo + r) * d + c] = acc[r];
  }
}

// ------------------------------------------------- bf16 (tensor cores)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Waits until at most N of this thread's newest groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) . b (16x8, col); bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows [m0, m0 + BM) of a (rows, width) bf16 matrix, columns [k0, k0 +
// kBK), into a shared (BM, kBK + kPad) tile; rows outside [lo, hi) and
// columns past width are zero-filled.
template <int BM, int NT>
__device__ __forceinline__ void issue_rows(bf16* dst, const bf16* src,
                                           int m0, int lo, int hi, int k0,
                                           int width) {
  constexpr int CH = kBK / 8, LD = kBK + kPad;
  for (int i = threadIdx.x; i < BM * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int row = m0 + r, col = k0 + c;
    const bool ok = row >= lo && row < hi && col < width;
    cp_async16(dst + r * LD + c,
               ok ? src + (long long)row * width + col : src, ok ? 16 : 0);
  }
}

// Rows [k0, k0 + kBK) of an (depth, width) bf16 weight matrix, columns
// [n0, n0 + BN), into a shared (kBK, BN + kPad) tile; rows past depth and
// columns past width are zero-filled.
template <int BN, int NT>
__device__ __forceinline__ void issue_weights(bf16* dst, const bf16* src,
                                              int k0, int depth, int n0,
                                              int width) {
  constexpr int CH = BN / 8, LD = BN + kPad;
  for (int i = threadIdx.x; i < kBK * CH; i += NT) {
    const int r = i / CH, c = (i - r * CH) * 8;
    const int k = k0 + r, col = n0 + c;
    const bool ok = k < depth && col < width;
    cp_async16(dst + r * LD + c,
               ok ? src + (long long)k * width + col : src, ok ? 16 : 0);
  }
}

constexpr size_t up_smem(int bm, int bn, int stages) {
  return sizeof(bf16) * stages * (bm * (kBK + kPad) + 2 * kBK * (bn + kPad));
}
constexpr size_t down_smem(int bm, int bn, int stages) {
  return sizeof(bf16) * stages * (2 * bm * (kBK + kPad) + kBK * (bn + kPad));
}

// Launch 1: h = silu(x Wg[e]) * (x Wu[e]) for a tile of BM rows and BN
// columns of f; W warps, WM along the rows and W / WM along the columns;
// S stages.  h leaves as hi = bf16(h) and lo = bf16(h - hi), each
// (rows, f).
template <int BM, int BN, int WM, int W, int S>
__global__ void __launch_bounds__(W * 32)
moe_up_mma(const bf16* __restrict__ x, const bf16* __restrict__ wg,
           const bf16* __restrict__ wu, const int* __restrict__ sizes,
           const int* __restrict__ experts, bf16* __restrict__ h_hi,
           bf16* __restrict__ h_lo, int rows, int d, int f, int E, int G) {
  constexpr int WN = W / WM;
  constexpr int MF = BM / WM / 16;        // m16 fragments a warp
  constexpr int NF = BN / WN / 8;         // n8 column tiles a warp
  constexpr int LDX = kBK + kPad, LDW = BN + kPad;
  constexpr int XS = BM * LDX, WS = kBK * LDW;
  static_assert(MF >= 1 && NF >= 1 && MF * WM * 16 == BM &&
                NF * WN * 8 == BN, "warp tiling");

  __shared__ TileInfo info;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* sx = reinterpret_cast<bf16*>(smem_b);   // S x (BM, LDX)
  bf16* sg = sx + S * XS;                        // S x (kBK, LDW)
  bf16* su = sg + S * WS;                        // S x (kBK, LDW)

  locate(sizes, G, rows, BM, &info);
  if (!info.found) return;                       // uniform across the block
  const int lo = info.lo, hi = info.hi;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) return;                   // the down launch: NaN
  const int m0 = lo / BM * BM;                   // the physical tile
  const int n0 = blockIdx.x * BN;
  const bf16* wg_e = wg + (long long)e * d * f;
  const bf16* wu_e = wu + (long long)e * d * f;
  const int nk = (d + kBK - 1) / kBK;

  // k step kt goes to stage kt % S, one cp.async group a step.
  auto issue = [&](int kt) {
    const int st = kt % S, k0 = kt * kBK;
    issue_rows<BM, W * 32>(sx + st * XS, x, m0, lo, hi, k0, d);
    issue_weights<BN, W * 32>(sg + st * WS, wg_e, k0, d, n0, f);
    issue_weights<BN, W * 32>(su + st * WS, wu_e, k0, d, n0, f);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  bool act[MF];                   // fragments holding rows of [lo, hi)
  bool any = false;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    const int r0 = m0 + (wm * MF + i) * 16;
    act[i] = r0 < hi && r0 + 16 > lo;
    any |= act[i];
  }
  float acc_g[MF][NF][4], acc_u[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc_g[i][j][v] = acc_u[i][j][v] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();                 // step kt landed; step kt-1 consumed
    if (kt + S - 1 < nk) issue(kt + S - 1);
    cp_async_commit();
    const int st = kt % S;
    const bf16* cx = sx + st * XS + wm * MF * 16 * LDX;
    // Lanes 0-15 address the gate tile's 16 k rows, lanes 16-31 the up
    // tile's: one ldmatrix.x4.trans gives b[0..1] of Wg, b[2..3] of Wu.
    const bf16* cw = ((lane & 16) ? su : sg) + st * WS + wn * NF * 8;
    if (!any) continue;           // this warp's rows are all outside
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t a[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i)
        if (act[i])
          ldmatrix_x4(a[i], cx + (i * 16 + (lane & 15)) * LDX + ks * 16 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, cw + (ks * 16 + (lane & 15)) * LDW + j * 8);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if (!act[i]) continue;
          mma_bf16(acc_g[i][j], a[i], b[0], b[1]);
          mma_bf16(acc_u[i][j], a[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // C fragment: (c0, c1) at row lane/4, columns 2*(lane%4) + {0, 1}; (c2,
  // c3) 8 rows below.  f is a multiple of 8: a pair is whole or absent.
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + (wm * MF + i) * 16 + (lane >> 2) + half * 8;
        const int c = n0 + (wn * NF + j) * 8 + (lane & 3) * 2;
        if (r < lo || r >= hi || c >= f) continue;
        const float h0 = silu_mul(acc_g[i][j][2 * half],
                                  acc_u[i][j][2 * half]);
        const float h1 = silu_mul(acc_g[i][j][2 * half + 1],
                                  acc_u[i][j][2 * half + 1]);
        const __nv_bfloat162 hv = __floats2bfloat162_rn(h0, h1);
        const __nv_bfloat162 lv = __floats2bfloat162_rn(
            h0 - __low2float(hv), h1 - __high2float(hv));
        const long long at = (long long)r * f + c;
        *reinterpret_cast<__nv_bfloat162*>(h_hi + at) = hv;
        *reinterpret_cast<__nv_bfloat162*>(h_lo + at) = lv;
      }
}

// Launch 2: y = hi Wd[e] + lo Wd[e] for a tile of BM rows and BN columns
// of d, both products of a k step into one accumulator, hi first; spare
// blocks zero the tail rows.
template <int BM, int BN, int WM, int W, int S>
__global__ void __launch_bounds__(W * 32)
moe_down_mma(const bf16* __restrict__ h_hi, const bf16* __restrict__ h_lo,
             const bf16* __restrict__ wd, const int* __restrict__ sizes,
             const int* __restrict__ experts, bf16* __restrict__ out,
             int rows, int d, int f, int E, int G) {
  constexpr int WN = W / WM;
  constexpr int MF = BM / WM / 16;
  constexpr int NF = BN / WN / 8;         // even: ldmatrix.x4 takes 16
  constexpr int LDH = kBK + kPad, LDW = BN + kPad;
  constexpr int HS = BM * LDH, WS = kBK * LDW;
  static_assert(MF >= 1 && NF >= 2 && NF % 2 == 0 && MF * WM * 16 == BM &&
                NF * WN * 8 == BN, "warp tiling");

  __shared__ TileInfo info;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* shi = reinterpret_cast<bf16*>(smem_b);  // S x (BM, LDH)
  bf16* slo = shi + S * HS;                     // S x (BM, LDH)
  bf16* sw = slo + S * HS;                      // S x (kBK, LDW)

  locate(sizes, G, rows, BM, &info);
  const int n0 = blockIdx.x * BN;
  if (!info.found) {
    zero_tail(out, info, rows, d, n0, BN);
    return;
  }
  const int lo = info.lo, hi = info.hi;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) {
    nan_rows(out, lo, hi, d, n0, BN);
    return;
  }
  const int m0 = lo / BM * BM;
  const bf16* wd_e = wd + (long long)e * f * d;
  const int nk = (f + kBK - 1) / kBK;

  auto issue = [&](int kt) {
    const int st = kt % S, k0 = kt * kBK;
    issue_rows<BM, W * 32>(shi + st * HS, h_hi, m0, lo, hi, k0, f);
    issue_rows<BM, W * 32>(slo + st * HS, h_lo, m0, lo, hi, k0, f);
    issue_weights<BN, W * 32>(sw + st * WS, wd_e, k0, f, n0, d);
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) issue(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  bool act[MF];
  bool any = false;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
    const int r0 = m0 + (wm * MF + i) * 16;
    act[i] = r0 < hi && r0 + 16 > lo;
    any |= act[i];
  }
  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < nk) issue(kt + S - 1);
    cp_async_commit();
    const int st = kt % S;
    const int a_off = st * HS + wm * MF * 16 * LDH;
    const bf16* cw = sw + st * WS + wn * NF * 8;
    if (!any) continue;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t ah[MF][4], al[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        if (!act[i]) continue;
        const int at = a_off + (i * 16 + (lane & 15)) * LDH + ks * 16 +
                       (lane >> 4) * 8;
        ldmatrix_x4(ah[i], shi + at);
        ldmatrix_x4(al[i], slo + at);
      }
#pragma unroll
      for (int jp = 0; jp < NF / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, cw + (ks * 16 + ((lane >> 3) & 1) * 8 +
                                   (lane & 7)) * LDW +
                                 jp * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if (!act[i]) continue;
          mma_bf16(acc[i][2 * jp], ah[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp], al[i], b[0], b[1]);
          mma_bf16(acc[i][2 * jp + 1], ah[i], b[2], b[3]);
          mma_bf16(acc[i][2 * jp + 1], al[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + (wm * MF + i) * 16 + (lane >> 2) + half * 8;
        const int c = n0 + (wn * NF + j) * 8 + (lane & 3) * 2;
        if (r < lo || r >= hi || c >= d) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * d + c) =
            __floats2bfloat162_rn(acc[i][j][2 * half],
                                  acc[i][j][2 * half + 1]);
      }
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

// One bf16 configuration: the up launch's M tile UM, N tile UN, warps UW
// (UWM along the rows) and stages US; the down launch's DM, DN, DW, DWM,
// DS.  Each launch has its own logical tiles: h is per row.
template <int UM, int UN, int UWM, int UW, int US, int DM, int DN, int DWM,
          int DW, int DS>
cudaError_t launch_mma(const void* x, const void* wg, const void* wu,
                       const void* wd, const int* sizes, const int* experts,
                       void* h, void* out, int rows, int d, int f, int E,
                       int G, cudaStream_t s) {
  bf16* hi = static_cast<bf16*>(h);
  bf16* lo = hi + (long long)rows * f;
  constexpr size_t up_bytes = up_smem(UM, UN, US);
  constexpr size_t down_bytes = down_smem(DM, DN, DS);
  cudaError_t err = allow_smem(moe_up_mma<UM, UN, UWM, UW, US>, up_bytes);
  if (err != cudaSuccess) return err;
  moe_up_mma<UM, UN, UWM, UW, US>
      <<<dim3(tiles(f, UN), tiles(rows, UM) + G), UW * 32, up_bytes, s>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(wg),
          static_cast<const bf16*>(wu), sizes, experts, hi, lo, rows, d, f,
          E, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(moe_down_mma<DM, DN, DWM, DW, DS>, down_bytes);
  if (err != cudaSuccess) return err;
  moe_down_mma<DM, DN, DWM, DW, DS>
      <<<dim3(tiles(d, DN), tiles(rows, DM) + G), DW * 32, down_bytes,
         s>>>(hi, lo, static_cast<const bf16*>(wd), sizes, experts,
              static_cast<bf16*>(out), rows, d, f, E, G);
  return cudaGetLastError();
}

cudaError_t launch_simt(const void* x, const void* wg, const void* wu,
                        const void* wd, const int* sizes, const int* experts,
                        void* h, void* out, int rows, int d, int f, int E,
                        int G, cudaStream_t s) {
  float* hs = static_cast<float*>(h);
  const int n_tiles = tiles(rows, kRows) + G;
  moe_up_simt<<<dim3(tiles(f, kCols), n_tiles), kCols, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(wg),
      static_cast<const float*>(wu), sizes, experts, hs, rows, d, f, E, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_simt<<<dim3(tiles(d, kCols), n_tiles), kCols, 0, s>>>(
      hs, static_cast<const float*>(wd), sizes, experts,
      static_cast<float*>(out), rows, d, f, E, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shapes and the plan of one call, every field 8 bytes wide
// (kernels/moe_gemm.py `_Args` mirrors it).  x (rows, d), Wg/Wu (E, d, f),
// Wd (E, f, d), out (rows, d), all contiguous and 16-byte aligned;
// group_sizes and group_experts (G,) int32 (experts may be null: group g
// uses expert g); h a scratch of rows * f * 4 bytes (f32 h, or the bf16
// hi and lo halves).  dtype 0 = float32 (SIMT), 1 = bfloat16 (tensor
// cores).  The plan's fields must name one configuration of this file.
struct MoeArgs {
  long long rows, d, f, E, G, dtype, k_step, up_m, up_n, up_warps,
      up_stages, up_smem, down_m, down_n, down_warps, down_stages,
      down_smem;
};

// Returns cudaGetLastError() after the launches (0 = both launched).
int moe_grouped_ffn_launch(const void* x, const void* w_gate,
                           const void* w_up, const void* w_down,
                           const void* group_sizes, const void* group_experts,
                           void* h, void* out, const MoeArgs* a,
                           void* stream) {
  const int rows = (int)a->rows, d = (int)a->d, f = (int)a->f,
            E = (int)a->E, G = (int)a->G;
  if (rows == 0) return 0;
  if (rows < 0 || d <= 0 || f <= 0 || E <= 0 || G <= 0 || G > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  const int* experts = static_cast<const int*>(group_experts);
  if (a->dtype == 0) {
    if (a->up_m != kRows || a->down_m != kRows || a->up_n != kCols ||
        a->down_n != kCols ||
        a->k_step != kChunk || a->up_stages != 1 || a->down_stages != 1 ||
        a->up_warps != kCols / 32 || a->down_warps != kCols / 32 ||
        a->up_smem != 0 || a->down_smem != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_simt(x, w_gate, w_up, w_down, sizes, experts, h, out,
                            rows, d, f, E, G, s);
  }
  if (a->dtype != 1 || d % 8 || f % 8 || a->k_step != kBK)
    return (int)cudaErrorInvalidValue;
#define MOE_CASE(UM, UN, UWM, UW, US, DM, DN, DWM, DW, DS)                 \
  if (a->up_m == UM && a->up_n == UN && a->up_warps == UW &&               \
      a->up_stages == US && a->down_m == DM && a->down_n == DN &&          \
      a->down_warps == DW && a->down_stages == DS &&                       \
      (size_t)a->up_smem == up_smem(UM, UN, US) &&                         \
      (size_t)a->down_smem == down_smem(DM, DN, DS))                       \
    return (int)launch_mma<UM, UN, UWM, UW, US, DM, DN, DWM, DW, DS>(      \
        x, w_gate, w_up, w_down, sizes, experts, h, out, rows, d, f, E, G, \
        s);
  MOE_CASE(16, 32, 1, 4, 3, 16, 128, 1, 4, 3)     // decode: short segments
  MOE_CASE(128, 64, 8, 8, 3, 64, 128, 4, 8, 3)    // prefill: tens of rows
#undef MOE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
