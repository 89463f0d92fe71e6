// Grouped-expert SwiGLU over sorted ragged segments — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py (moe_grouped_ffn_pallas:
// _grouped_ffn_fwd, body _kernel, schedule make_group_metadata) and, at
// the end of this file, its backward _ffn_bwd.
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

// =============================================================== backward
// Replaces the TPU kernel's custom VJP, repro/kernels/moe_gemm.py _ffn_bwd
// (an exact recompute through the jnp oracle).  The gradient of the
// function above against dy (rows, d), in three launches, no atomics
// (kernels/moe_gemm.py moe_grouped_ffn_bwd_cuda):
//   1. rows, grid (f tile, logical tile): g = x Wg[e], u = x Wu[e] and
//      da = dy Wd[e]^T for a tile of rows, then per element
//        s = sigmoid(g), a = silu(g) u, dg = da u s (1 + g (1 - s)),
//        du = da silu(g)
//      into an f32 scratch (a, dg, du: rows x f each);
//   2. dx, grid (d tile, logical tile): dx = dg Wg[e]^T + du Wu[e]^T;
//      spare blocks zero the rows past the segments, a group whose expert
//      is out of range gets NaN rows;
//   3. weights, grid (output tile, expert e): dWg[e] = x^T dg,
//      dWu[e] = x^T du, dWd[e] = a^T dy.  The block walks e's groups in
//      ascending order and each group's rows in fixed steps, accumulating
//      in registers; an expert without rows gets zeros.
// Launches 1 and 2 use the forward's logical tiles (find_tile), so the
// host never reads the group sizes.  Launch 3 finds e's segments on the
// device (expert_segments).  Every output's bits depend only on the
// shapes, the dtype and the rows it sums over: the order of every
// reduction is fixed, no sum is split across blocks.
//
// Bound.  16 rows d f operations (recompute 2, da 1, dx 2, dW 3, each
// 2 rows d f); the weights read and their gradients written, x, dy and dx
// once, the f32 scratch written once and read once.  At training's shape
// (rows = 2 x 2048 x 8 = 32768, d 1536, f 512) the operations bind it:
// 412 GFLOP, 0.417 ms at 989 TF/s (H100 SXM, bf16 tensor cores).
//
// bf16 runs on tensor cores (mma.sync m16n8k16, 2-stage cp.async rings
// of 64-deep k steps, the forward's tile helpers).  The scratch holds each
// f32 intermediate as a bf16 hi/lo pair (hi = bf16(v), lo = bf16(v - hi),
// the bytes of the f32 array), as the forward carries h: a product with a
// scratch operand is hi . B then lo . B (or A . hi then A . lo) into one
// f32 accumulator.  Launch 3 reads its operands transposed in place:
// x^T and a^T come by ldmatrix.trans from (rows, d) and (rows, f) tiles,
// Wd (f, d) and Wg/Wu (d, f) reach launches 1 and 2 as column-major B by
// plain ldmatrix.  float32 (the checks only) runs SIMT kernels, each
// output element one thread's serial fmaf loop in index order.

constexpr int kBwdChunk = 64;     // f32: reduction elements staged a step
constexpr int kWTile = 64;        // f32 launch 3: output tile edge
constexpr int kWRows = 16;        // f32 launch 3: rows staged a step

__host__ __device__ constexpr int cdiv(int n, int t) { return (n + t - 1) / t; }

__device__ __forceinline__ void swiglu_grad(float g, float u, float da,
                                            float* a, float* dg, float* du) {
  const float s = 1.f / (1.f + expf(-g));
  const float silu = g * s;
  *a = silu_mul(g, u);                        // the forward's h, bitwise
  *dg = da * u * s * (1.f + g * (1.f - s));
  *du = da * silu;
}

// Rows [lo, hi) of each of expert e's groups, in ascending group order,
// into seg_lo / seg_hi (*n_seg of them).  Segments as find_tile clamps
// them.  Run by the whole block; warp 0 does the work.
__device__ void expert_segments(const int* __restrict__ sizes,
                                const int* __restrict__ experts, int G,
                                int T, int e, int* seg_lo, int* seg_hi,
                                int* n_seg) {
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int rows = 0, count = 0;
    for (int g0 = 0; g0 < G; g0 += 32) {
      const int g = g0 + lane;
      const int n = g < G ? min(max(sizes[g], 0), T) : 0;
      const int incl = warp_inclusive_sum(n, lane);
      const int start = min(rows + incl - n, T);
      const int end = min(rows + incl, T);
      const int ex = g < G ? (experts ? experts[g] : g) : -1;
      const bool mine = ex == e && end > start;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      if (mine) {
        const int at = count + __popc(m & ((1u << lane) - 1u));
        seg_lo[at] = start;
        seg_hi[at] = end;
      }
      count += __popc(m);
      rows = min(rows + __shfl_sync(0xffffffffu, incl, 31), T);
    }
    if (lane == 0) *n_seg = count;
  }
  __syncthreads();
}

// One output of launch 3: C (M, N) = A^T B summed over rows, A (rows, M)
// and B (rows, N) row-major; a_lo / b_lo the lo halves of a scratch
// operand (bf16), null otherwise.
template <typename T>
struct WeightJob {
  const T* a;
  const T* a_lo;
  const T* b;
  const T* b_lo;
  T* out;
  int M, N, m0, n0;
};

// Output tile t of launch 3 for expert e: the tiles of dWg, then dWu,
// then dWd, each row-major over (M / TM, N / TN).
template <typename T>
__device__ WeightJob<T> weight_job(int t, int TM, int TN, const T* x,
                                   const T* dy, const T* dg, const T* dg_lo,
                                   const T* du, const T* du_lo, const T* a,
                                   const T* a_lo, T* dwg, T* dwu, T* dwd,
                                   int d, int f, int e) {
  const int n1 = cdiv(d, TM) * cdiv(f, TN);
  WeightJob<T> j;
  if (t < 2 * n1) {
    const bool up = t >= n1;
    if (up) t -= n1;
    j = {x, nullptr, up ? du : dg, up ? du_lo : dg_lo,
         (up ? dwu : dwg) + (long long)e * d * f, d, f, 0, 0};
  } else {
    t -= 2 * n1;
    j = {a, a_lo, dy, nullptr, dwd + (long long)e * f * d, f, d, 0, 0};
  }
  const int tn = cdiv(j.N, TN);
  j.m0 = (t / tn) * TM;
  j.n0 = (t % tn) * TN;
  return j;
}

// ------------------------------------------------- backward, f32 (SIMT)
// Launch 1: 16 rows a block, one thread a column of f.
__global__ void __launch_bounds__(kCols)
moe_bwd_rows_simt(const float* __restrict__ x, const float* __restrict__ wg,
                  const float* __restrict__ wu, const float* __restrict__ wd,
                  const int* __restrict__ sizes,
                  const int* __restrict__ experts,
                  const float* __restrict__ dy, float* __restrict__ a_out,
                  float* __restrict__ dg_out, float* __restrict__ du_out,
                  int rows, int d, int f, int E, int G) {
  __shared__ TileInfo info;
  __shared__ float x_s[kBwdChunk][kRows];
  __shared__ float dy_s[kBwdChunk][kRows];
  __shared__ float wd_s[kCols][kBwdChunk + 1];   // Wd[e] rows j, a chunk
  locate(sizes, G, rows, kRows, &info);
  if (!info.found) return;
  const int lo = info.lo, n = info.hi - info.lo;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) return;                  // launch 2 writes NaN
  const int j0 = blockIdx.x * kCols, j = j0 + threadIdx.x;
  const float* wg_e = wg + (long long)e * d * f;
  const float* wu_e = wu + (long long)e * d * f;
  const float* wd_e = wd + (long long)e * f * d;
  float g_acc[kRows], u_acc[kRows], da_acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) g_acc[r] = u_acc[r] = da_acc[r] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kBwdChunk) {
    const int kc = min(kBwdChunk, d - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kBwdChunk; i += kCols) {
      const int r = i / kBwdChunk, c = i - r * kBwdChunk;
      const bool ok = r < n && c < kc;
      const long long at = (long long)(lo + r) * d + k0 + c;
      x_s[c][r] = ok ? x[at] : 0.f;
      dy_s[c][r] = ok ? dy[at] : 0.f;
    }
    for (int i = threadIdx.x; i < kCols * kBwdChunk; i += kCols) {
      const int jj = i / kBwdChunk, c = i - jj * kBwdChunk;
      wd_s[jj][c] = (j0 + jj < f && c < kc)
                        ? wd_e[(long long)(j0 + jj) * d + k0 + c] : 0.f;
    }
    __syncthreads();
    if (j < f) {
      for (int c = 0; c < kc; ++c) {
        const long long w = (long long)(k0 + c) * f + j;
        const float wgv = wg_e[w], wuv = wu_e[w];
        const float wdv = wd_s[threadIdx.x][c];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          g_acc[r] = fmaf(x_s[c][r], wgv, g_acc[r]);
          u_acc[r] = fmaf(x_s[c][r], wuv, u_acc[r]);
          da_acc[r] = fmaf(dy_s[c][r], wdv, da_acc[r]);
        }
      }
    }
  }
  if (j < f) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (r >= n) continue;
      const long long at = (long long)(lo + r) * f + j;
      swiglu_grad(g_acc[r], u_acc[r], da_acc[r], a_out + at, dg_out + at,
                  du_out + at);
    }
  }
}

// Launch 2: dx[r, c] = sum_j dg[r, j] Wg[e][c, j] + du[r, j] Wu[e][c, j].
__global__ void __launch_bounds__(kCols)
moe_bwd_dx_simt(const float* __restrict__ dg, const float* __restrict__ du,
                const float* __restrict__ wg, const float* __restrict__ wu,
                const int* __restrict__ sizes,
                const int* __restrict__ experts, float* __restrict__ dx,
                int rows, int d, int f, int E, int G) {
  __shared__ TileInfo info;
  __shared__ float dg_s[kBwdChunk][kRows];
  __shared__ float du_s[kBwdChunk][kRows];
  __shared__ float wg_s[kCols][kBwdChunk + 1];  // Wg[e] rows c, a chunk
  __shared__ float wu_s[kCols][kBwdChunk + 1];
  locate(sizes, G, rows, kRows, &info);
  const int c0 = blockIdx.x * kCols;
  if (!info.found) {
    zero_tail(dx, info, rows, d, c0, kCols);
    return;
  }
  const int lo = info.lo, n = info.hi - info.lo;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) {
    nan_rows(dx, lo, info.hi, d, c0, kCols);
    return;
  }
  const int c = c0 + threadIdx.x;
  const float* wg_e = wg + (long long)e * d * f;
  const float* wu_e = wu + (long long)e * d * f;
  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;

  for (int j0 = 0; j0 < f; j0 += kBwdChunk) {
    const int jc = min(kBwdChunk, f - j0);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * kBwdChunk; i += kCols) {
      const int r = i / kBwdChunk, k = i - r * kBwdChunk;
      const bool ok = r < n && k < jc;
      const long long at = (long long)(lo + r) * f + j0 + k;
      dg_s[k][r] = ok ? dg[at] : 0.f;
      du_s[k][r] = ok ? du[at] : 0.f;
    }
    for (int i = threadIdx.x; i < kCols * kBwdChunk; i += kCols) {
      const int cc = i / kBwdChunk, k = i - cc * kBwdChunk;
      const bool ok = c0 + cc < d && k < jc;
      const long long at = (long long)(c0 + cc) * f + j0 + k;
      wg_s[cc][k] = ok ? wg_e[at] : 0.f;
      wu_s[cc][k] = ok ? wu_e[at] : 0.f;
    }
    __syncthreads();
    if (c < d) {
      for (int k = 0; k < jc; ++k) {
        const float wgv = wg_s[threadIdx.x][k], wuv = wu_s[threadIdx.x][k];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r] = fmaf(dg_s[k][r], wgv, acc[r]);
          acc[r] = fmaf(du_s[k][r], wuv, acc[r]);
        }
      }
    }
  }
  if (c < d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < n) dx[(long long)(lo + r) * d + c] = acc[r];
  }
}

// Launch 3: a 64 x 64 tile of one weight gradient for expert e, 256
// threads of 4 x 4 elements, rows staged 16 at a time, each element a
// serial fmaf loop over e's rows in stream order.
__global__ void __launch_bounds__(256)
moe_bwd_weights_simt(const float* __restrict__ x,
                     const float* __restrict__ dy,
                     const float* __restrict__ a, const float* __restrict__ dg,
                     const float* __restrict__ du,
                     const int* __restrict__ sizes,
                     const int* __restrict__ experts, float* __restrict__ dwg,
                     float* __restrict__ dwu, float* __restrict__ dwd,
                     int rows, int d, int f, int E, int G) {
  __shared__ int seg_lo[kMaxGroups], seg_hi[kMaxGroups];
  __shared__ int n_seg;
  __shared__ float a_s[kWRows][kWTile];
  __shared__ float b_s[kWRows][kWTile];
  const int e = blockIdx.y;
  const WeightJob<float> job = weight_job<float>(
      blockIdx.x, kWTile, kWTile, x, dy, dg, nullptr, du, nullptr, a,
      nullptr, dwg, dwu, dwd, d, f, e);
  expert_segments(sizes, experts, G, rows, e, seg_lo, seg_hi, &n_seg);
  const int tm = threadIdx.x / 16, tn = threadIdx.x % 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.f;

  for (int s = 0; s < n_seg; ++s) {
    const int hi = seg_hi[s];
    for (int r0 = seg_lo[s]; r0 < hi; r0 += kWRows) {
      const int rc = min(kWRows, hi - r0);
      __syncthreads();
      for (int i = threadIdx.x; i < kWRows * kWTile; i += 256) {
        const int r = i / kWTile, c = i - r * kWTile;
        const bool in = r < rc;
        a_s[r][c] = in && job.m0 + c < job.M
                        ? job.a[(long long)(r0 + r) * job.M + job.m0 + c]
                        : 0.f;
        b_s[r][c] = in && job.n0 + c < job.N
                        ? job.b[(long long)(r0 + r) * job.N + job.n0 + c]
                        : 0.f;
      }
      __syncthreads();
      for (int r = 0; r < rc; ++r) {
        float av[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          av[i] = a_s[r][tm * 4 + i];
          bv[i] = b_s[r][tn * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(av[i], bv[k], acc[i][k]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = job.m0 + tm * 4 + i;
    if (m >= job.M) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int nn = job.n0 + tn * 4 + k;
      if (nn < job.N) job.out[(long long)m * job.N + nn] = acc[i][k];
    }
  }
}

// ------------------------------------------ backward, bf16 (tensor cores)
// Two neighbouring f32 values as bf16 hi and lo pairs at `at` of each
// plane, as the forward's up launch stores h.
__device__ __forceinline__ void store_hilo(bf16* hi, bf16* lo, long long at,
                                           float v0, float v1) {
  const __nv_bfloat162 hv = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 lv =
      __floats2bfloat162_rn(v0 - __low2float(hv), v1 - __high2float(hv));
  *reinterpret_cast<__nv_bfloat162*>(hi + at) = hv;
  *reinterpret_cast<__nv_bfloat162*>(lo + at) = lv;
}

constexpr size_t bwd_rows_smem(int bm, int bn, int stages) {
  return sizeof(bf16) * stages *
         (2 * bm * (kBK + kPad) + 2 * kBK * (bn + kPad) + bn * (kBK + kPad));
}
constexpr size_t bwd_dx_smem(int bm, int bn, int stages) {
  return sizeof(bf16) * stages *
         (4 * bm * (kBK + kPad) + 2 * bn * (kBK + kPad));
}
constexpr size_t bwd_weights_smem(int bm, int bn, int stages) {
  return sizeof(bf16) * stages *
         (2 * kBK * (bm + kPad) + 2 * kBK * (bn + kPad));
}

// Launch 1: g = x Wg[e], u = x Wu[e], da = dy Wd[e]^T for BM rows and BN
// columns of f; W warps, WM along the rows; S stages.  a, dg, du leave as
// hi/lo pairs.  Wd[e] (f, d) is B in column-major form as it lies: its
// (BN, kBK) tile reaches the fragments by plain ldmatrix.
template <int BM, int BN, int WM, int W, int S>
__global__ void __launch_bounds__(W * 32)
moe_bwd_rows_mma(const bf16* __restrict__ x, const bf16* __restrict__ wg,
                 const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                 const int* __restrict__ sizes,
                 const int* __restrict__ experts,
                 const bf16* __restrict__ dy, bf16* __restrict__ scratch,
                 int rows, int d, int f, int E, int G) {
  constexpr int WN = W / WM;
  constexpr int MF = BM / WM / 16;
  constexpr int NF = BN / WN / 8;         // even: ldmatrix.x4 takes 16
  constexpr int LDX = kBK + kPad, LDW = BN + kPad;
  constexpr int XS = BM * LDX, WS = kBK * LDW, DS = BN * LDX;
  static_assert(MF >= 1 && NF >= 2 && NF % 2 == 0 && MF * WM * 16 == BM &&
                NF * WN * 8 == BN, "warp tiling");

  __shared__ TileInfo info;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* sx = reinterpret_cast<bf16*>(smem_b);   // S x (BM, LDX)
  bf16* sdy = sx + S * XS;                      // S x (BM, LDX)
  bf16* sg = sdy + S * XS;                      // S x (kBK, LDW)
  bf16* su = sg + S * WS;                       // S x (kBK, LDW)
  bf16* sw = su + S * WS;                       // S x (BN, LDX): Wd rows

  locate(sizes, G, rows, BM, &info);
  if (!info.found) return;
  const int lo = info.lo, hi = info.hi;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) return;
  const int m0 = lo / BM * BM;
  const int n0 = blockIdx.x * BN;
  const bf16* wg_e = wg + (long long)e * d * f;
  const bf16* wu_e = wu + (long long)e * d * f;
  const bf16* wd_e = wd + (long long)e * f * d;
  const int nk = (d + kBK - 1) / kBK;

  auto issue = [&](int kt) {
    const int st = kt % S, k0 = kt * kBK;
    issue_rows<BM, W * 32>(sx + st * XS, x, m0, lo, hi, k0, d);
    issue_rows<BM, W * 32>(sdy + st * XS, dy, m0, lo, hi, k0, d);
    issue_weights<BN, W * 32>(sg + st * WS, wg_e, k0, d, n0, f);
    issue_weights<BN, W * 32>(su + st * WS, wu_e, k0, d, n0, f);
    issue_rows<BN, W * 32>(sw + st * DS, wd_e, n0, 0, f, k0, d);
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
  float acc_g[MF][NF][4], acc_u[MF][NF][4], acc_d[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        acc_g[i][j][v] = acc_u[i][j][v] = acc_d[i][j][v] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < nk) issue(kt + S - 1);
    cp_async_commit();
    const int st = kt % S;
    const int a_off = st * XS + wm * MF * 16 * LDX;
    const bf16* cw = ((lane & 16) ? su : sg) + st * WS + wn * NF * 8;
    const bf16* cd = sw + st * DS + wn * NF * 8 * LDX;
    if (!any) continue;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t ax[MF][4], ay[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        if (!act[i]) continue;
        const int at = a_off + (i * 16 + (lane & 15)) * LDX + ks * 16 +
                       (lane >> 4) * 8;
        ldmatrix_x4(ax[i], sx + at);
        ldmatrix_x4(ay[i], sdy + at);
      }
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, cw + (ks * 16 + (lane & 15)) * LDW + j * 8);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if (!act[i]) continue;
          mma_bf16(acc_g[i][j], ax[i], b[0], b[1]);
          mma_bf16(acc_u[i][j], ax[i], b[2], b[3]);
        }
      }
#pragma unroll
      for (int jp = 0; jp < NF / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, cd + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LDX +
                           ks * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if (!act[i]) continue;
          mma_bf16(acc_d[i][2 * jp], ay[i], b[0], b[1]);
          mma_bf16(acc_d[i][2 * jp + 1], ay[i], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const long long plane = (long long)rows * f;
  bf16* a_hi = scratch;
  bf16* dg_hi = scratch + 2 * plane;
  bf16* du_hi = scratch + 4 * plane;
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + (wm * MF + i) * 16 + (lane >> 2) + half * 8;
        const int c = n0 + (wn * NF + j) * 8 + (lane & 3) * 2;
        if (r < lo || r >= hi || c >= f) continue;
        float a2[2], dg2[2], du2[2];
#pragma unroll
        for (int v = 0; v < 2; ++v)
          swiglu_grad(acc_g[i][j][2 * half + v], acc_u[i][j][2 * half + v],
                      acc_d[i][j][2 * half + v], &a2[v], &dg2[v], &du2[v]);
        const long long at = (long long)r * f + c;
        store_hilo(a_hi, a_hi + plane, at, a2[0], a2[1]);
        store_hilo(dg_hi, dg_hi + plane, at, dg2[0], dg2[1]);
        store_hilo(du_hi, du_hi + plane, at, du2[0], du2[1]);
      }
}

// Launch 2: dx = dg Wg[e]^T + du Wu[e]^T for BM rows and BN columns of d,
// the four products of a k step (dg hi, dg lo, du hi, du lo) into one
// accumulator in that order.  Wg[e] and Wu[e] (d, f) are B in
// column-major form as they lie.  Spare blocks zero the tail rows.
template <int BM, int BN, int WM, int W, int S>
__global__ void __launch_bounds__(W * 32)
moe_bwd_dx_mma(const bf16* __restrict__ scratch, const bf16* __restrict__ wg,
               const bf16* __restrict__ wu, const int* __restrict__ sizes,
               const int* __restrict__ experts, bf16* __restrict__ dx,
               int rows, int d, int f, int E, int G) {
  constexpr int WN = W / WM;
  constexpr int MF = BM / WM / 16;
  constexpr int NF = BN / WN / 8;
  constexpr int LD = kBK + kPad;
  constexpr int AS = BM * LD, BS = BN * LD;
  static_assert(MF >= 1 && NF >= 2 && NF % 2 == 0 && MF * WM * 16 == BM &&
                NF * WN * 8 == BN, "warp tiling");

  __shared__ TileInfo info;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* sa = reinterpret_cast<bf16*>(smem_b);   // 4 x S x (BM, LD)
  bf16* sb = sa + 4 * S * AS;                   // 2 x S x (BN, LD)

  locate(sizes, G, rows, BM, &info);
  const int n0 = blockIdx.x * BN;
  if (!info.found) {
    zero_tail(dx, info, rows, d, n0, BN);
    return;
  }
  const int lo = info.lo, hi = info.hi;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) {
    nan_rows(dx, lo, hi, d, n0, BN);
    return;
  }
  const int m0 = lo / BM * BM;
  const long long plane = (long long)rows * f;
  // dg hi, dg lo, du hi, du lo: planes 2..5 of the scratch.
  const bf16* src_a[4] = {scratch + 2 * plane, scratch + 3 * plane,
                          scratch + 4 * plane, scratch + 5 * plane};
  const bf16* src_b[2] = {wg + (long long)e * d * f,
                          wu + (long long)e * d * f};
  const int nk = (f + kBK - 1) / kBK;

  auto issue = [&](int kt) {
    const int st = kt % S, k0 = kt * kBK;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      issue_rows<BM, W * 32>(sa + (q * S + st) * AS, src_a[q], m0, lo, hi,
                             k0, f);
#pragma unroll
    for (int q = 0; q < 2; ++q)
      issue_rows<BN, W * 32>(sb + (q * S + st) * BS, src_b[q], n0, 0, d, k0,
                             f);
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
    const int a_off = st * AS + wm * MF * 16 * LD;
    const int b_off = st * BS + wn * NF * 8 * LD;
    if (!any) continue;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      uint32_t af[4][MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        if (!act[i]) continue;
        const int at = a_off + (i * 16 + (lane & 15)) * LD + ks * 16 +
                       (lane >> 4) * 8;
#pragma unroll
        for (int q = 0; q < 4; ++q) ldmatrix_x4(af[q][i], sa + q * S * AS + at);
      }
#pragma unroll
      for (int jp = 0; jp < NF / 2; ++jp) {
        const int at = b_off + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                       ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bg[4], bu[4];
        ldmatrix_x4(bg, sb + at);
        ldmatrix_x4(bu, sb + S * BS + at);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          if (!act[i]) continue;
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            float (&c)[4] = acc[i][2 * jp + t];
            mma_bf16(c, af[0][i], bg[2 * t], bg[2 * t + 1]);
            mma_bf16(c, af[1][i], bg[2 * t], bg[2 * t + 1]);
            mma_bf16(c, af[2][i], bu[2 * t], bu[2 * t + 1]);
            mma_bf16(c, af[3][i], bu[2 * t], bu[2 * t + 1]);
          }
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
        *reinterpret_cast<__nv_bfloat162*>(dx + (long long)r * d + c) =
            __floats2bfloat162_rn(acc[i][j][2 * half],
                                  acc[i][j][2 * half + 1]);
      }
}

// Launch 3: a (BM, BN) tile of one weight gradient of expert blockIdx.y,
// C = A^T B over e's rows, kBK rows a step through an S-stage ring.  The
// A tile (kBK, BM) and the B tile (kBK, BN) lie row-major as in global
// memory; A's fragments come by ldmatrix.trans (A^T), B's as in the
// forward's down launch.  Per k16 step: A . B, then A_lo . B or
// A . B_lo, whichever operand is a scratch pair.
template <int BM, int BN, int WM, int W, int S>
__global__ void __launch_bounds__(W * 32)
moe_bwd_weights_mma(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                    const bf16* __restrict__ scratch,
                    const int* __restrict__ sizes,
                    const int* __restrict__ experts, bf16* __restrict__ dwg,
                    bf16* __restrict__ dwu, bf16* __restrict__ dwd, int rows,
                    int d, int f, int E, int G) {
  constexpr int WN = W / WM;
  constexpr int MF = BM / WM / 16;
  constexpr int NF = BN / WN / 8;
  constexpr int LDA = BM + kPad, LDB = BN + kPad;
  constexpr int AS = kBK * LDA, BS = kBK * LDB;
  static_assert(MF >= 1 && NF >= 2 && NF % 2 == 0 && MF * WM * 16 == BM &&
                NF * WN * 8 == BN, "warp tiling");

  __shared__ int seg_lo[kMaxGroups], seg_hi[kMaxGroups];
  __shared__ int n_seg;
  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* sa = reinterpret_cast<bf16*>(smem_b);   // 2 x S x (kBK, LDA)
  bf16* sb = sa + 2 * S * AS;                   // 2 x S x (kBK, LDB)

  const int e = blockIdx.y;
  const long long plane = (long long)rows * f;
  const WeightJob<bf16> job = weight_job<bf16>(
      blockIdx.x, BM, BN, x, dy, scratch + 2 * plane, scratch + 3 * plane,
      scratch + 4 * plane, scratch + 5 * plane, scratch, scratch + plane,
      dwg, dwu, dwd, d, f, e);
  expert_segments(sizes, experts, G, rows, e, seg_lo, seg_hi, &n_seg);
  int steps = 0;
  for (int s = 0; s < n_seg; ++s)
    steps += (seg_hi[s] - seg_lo[s] + kBK - 1) / kBK;

  // Step i covers rows [r, min(r + kBK, hi)) of one segment; each thread
  // walks the steps in order with its own cursor.
  int cur_seg = 0, cur_row = n_seg > 0 ? seg_lo[0] : 0;
  auto issue = [&](int kt) {
    const int st = kt % S, hi = seg_hi[cur_seg];
    issue_weights<BM, W * 32>(sa + st * AS, job.a, cur_row, hi, job.m0,
                              job.M);
    if (job.a_lo)
      issue_weights<BM, W * 32>(sa + (S + st) * AS, job.a_lo, cur_row, hi,
                                job.m0, job.M);
    issue_weights<BN, W * 32>(sb + st * BS, job.b, cur_row, hi, job.n0,
                              job.N);
    if (job.b_lo)
      issue_weights<BN, W * 32>(sb + (S + st) * BS, job.b_lo, cur_row, hi,
                                job.n0, job.N);
    cur_row += kBK;
    if (cur_row >= hi && ++cur_seg < n_seg) cur_row = seg_lo[cur_seg];
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < steps) issue(s);
    cp_async_commit();
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / WN, wn = warp % WN;
  float acc[MF][NF][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.f;

  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<S - 2>();
    __syncthreads();
    if (kt + S - 1 < steps) issue(kt + S - 1);
    cp_async_commit();
    const int st = kt % S;
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const int krow = ks * 16 + (lane & 7) + ((lane >> 4) & 1) * 8;
      uint32_t ah[MF][4], al[MF][4];
#pragma unroll
      for (int i = 0; i < MF; ++i) {
        const int at = st * AS + krow * LDA + (wm * MF + i) * 16 +
                       ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(ah[i], sa + at);
        if (job.a_lo) ldmatrix_x4_trans(al[i], sa + S * AS + at);
      }
#pragma unroll
      for (int jp = 0; jp < NF / 2; ++jp) {
        const int at = st * BS +
                       (ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDB +
                       wn * NF * 8 + jp * 16 + (lane >> 4) * 8;
        uint32_t bh[4], bl[4];
        ldmatrix_x4_trans(bh, sb + at);
        if (job.b_lo) ldmatrix_x4_trans(bl, sb + S * BS + at);
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int t = 0; t < 2; ++t) {
            float (&c)[4] = acc[i][2 * jp + t];
            mma_bf16(c, ah[i], bh[2 * t], bh[2 * t + 1]);
            if (job.a_lo) mma_bf16(c, al[i], bh[2 * t], bh[2 * t + 1]);
            if (job.b_lo) mma_bf16(c, ah[i], bl[2 * t], bl[2 * t + 1]);
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
        const int m = job.m0 + (wm * MF + i) * 16 + (lane >> 2) + half * 8;
        const int n = job.n0 + (wn * NF + j) * 8 + (lane & 3) * 2;
        if (m >= job.M || n >= job.N) continue;
        *reinterpret_cast<__nv_bfloat162*>(job.out + (long long)m * job.N +
                                           n) =
            __floats2bfloat162_rn(acc[i][j][2 * half],
                                  acc[i][j][2 * half + 1]);
      }
}

int weight_tiles(int d, int f, int tm, int tn) {
  return 2 * cdiv(d, tm) * cdiv(f, tn) + cdiv(f, tm) * cdiv(d, tn);
}

// One bf16 backward configuration: launch 1 (RM rows, RN columns of f,
// RW warps, RWM along the rows), launch 2 (XM, XN columns of d, XW, XWM),
// launch 3 (a WM x WN tile, WW warps, WWM along M); S stages each.
template <int RM, int RN, int RWM, int RW, int XM, int XN, int XWM, int XW,
          int WM, int WN, int WWM, int WW, int S>
cudaError_t launch_bwd_mma(const void* x, const void* wg, const void* wu,
                           const void* wd, const int* sizes,
                           const int* experts, const void* dy, void* scratch,
                           void* dx, void* dwg, void* dwu, void* dwd,
                           int rows, int d, int f, int E, int G,
                           cudaStream_t s) {
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gb = static_cast<const bf16*>(wg);
  const bf16* ub = static_cast<const bf16*>(wu);
  const bf16* db = static_cast<const bf16*>(wd);
  const bf16* yb = static_cast<const bf16*>(dy);
  bf16* sc = static_cast<bf16*>(scratch);
  constexpr size_t r_bytes = bwd_rows_smem(RM, RN, S);
  constexpr size_t x_bytes = bwd_dx_smem(XM, XN, S);
  constexpr size_t w_bytes = bwd_weights_smem(WM, WN, S);
  auto k1 = moe_bwd_rows_mma<RM, RN, RWM, RW, S>;
  auto k2 = moe_bwd_dx_mma<XM, XN, XWM, XW, S>;
  auto k3 = moe_bwd_weights_mma<WM, WN, WWM, WW, S>;
  cudaError_t err = allow_smem(k1, r_bytes);
  if (err != cudaSuccess) return err;
  k1<<<dim3(tiles(f, RN), tiles(rows, RM) + G), RW * 32, r_bytes, s>>>(
      xb, gb, ub, db, sizes, experts, yb, sc, rows, d, f, E, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(k2, x_bytes);
  if (err != cudaSuccess) return err;
  k2<<<dim3(tiles(d, XN), tiles(rows, XM) + G), XW * 32, x_bytes, s>>>(
      sc, gb, ub, sizes, experts, static_cast<bf16*>(dx), rows, d, f, E, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(k3, w_bytes);
  if (err != cudaSuccess) return err;
  k3<<<dim3(weight_tiles(d, f, WM, WN), E), WW * 32, w_bytes, s>>>(
      xb, yb, sc, sizes, experts, static_cast<bf16*>(dwg),
      static_cast<bf16*>(dwu), static_cast<bf16*>(dwd), rows, d, f, E, G);
  return cudaGetLastError();
}

cudaError_t launch_bwd_simt(const void* x, const void* wg, const void* wu,
                            const void* wd, const int* sizes,
                            const int* experts, const void* dy, void* scratch,
                            void* dx, void* dwg, void* dwu, void* dwd,
                            int rows, int d, int f, int E, int G,
                            cudaStream_t s) {
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(dy);
  float* a = static_cast<float*>(scratch);
  float* dg = a + (long long)rows * f;
  float* du = dg + (long long)rows * f;
  const int n_tiles = tiles(rows, kRows) + G;
  moe_bwd_rows_simt<<<dim3(tiles(f, kCols), n_tiles), kCols, 0, s>>>(
      xf, static_cast<const float*>(wg), static_cast<const float*>(wu),
      static_cast<const float*>(wd), sizes, experts, yf, a, dg, du, rows, d,
      f, E, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_bwd_dx_simt<<<dim3(tiles(d, kCols), n_tiles), kCols, 0, s>>>(
      dg, du, static_cast<const float*>(wg), static_cast<const float*>(wu),
      sizes, experts, static_cast<float*>(dx), rows, d, f, E, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_bwd_weights_simt<<<dim3(weight_tiles(d, f, kWTile, kWTile), E), 256,
                         0, s>>>(
      xf, yf, a, dg, du, sizes, experts, static_cast<float*>(dwg),
      static_cast<float*>(dwu), static_cast<float*>(dwd), rows, d, f, E, G);
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

// The backward's shapes and plan (kernels/moe_gemm.py `_BwdArgs`); each
// launch's (M tile, N tile, warps, stages, dynamic shared memory).
struct MoeBwdArgs {
  long long rows, d, f, E, G, dtype, k_step, rows_m, rows_n, rows_warps,
      rows_stages, rows_smem, dx_m, dx_n, dx_warps, dx_stages, dx_smem, w_m,
      w_n, w_warps, w_stages, w_smem;
};

// dy (rows, d) like x; scratch rows * f * 12 bytes (a, dg, du in f32, or
// each as bf16 hi and lo planes: a hi, a lo, dg hi, dg lo, du hi, du lo);
// dx like x, dWg/dWu/dWd like the weights.  Returns cudaGetLastError()
// after the three launches (0 = all launched).
int moe_grouped_ffn_bwd_launch(const void* x, const void* w_gate,
                               const void* w_up, const void* w_down,
                               const void* group_sizes,
                               const void* group_experts, const void* dy,
                               void* scratch, void* dx, void* dw_gate,
                               void* dw_up, void* dw_down,
                               const MoeBwdArgs* a, void* stream) {
  const int rows = (int)a->rows, d = (int)a->d, f = (int)a->f,
            E = (int)a->E, G = (int)a->G;
  if (rows <= 0 || d <= 0 || f <= 0 || E <= 0 || G <= 0 || G > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  const int* experts = static_cast<const int*>(group_experts);
  if (a->dtype == 0) {
    if (a->k_step != kBwdChunk || a->rows_m != kRows ||
        a->rows_n != kCols || a->rows_warps != kCols / 32 ||
        a->dx_m != kRows || a->dx_n != kCols || a->dx_warps != kCols / 32 ||
        a->w_m != kWTile || a->w_n != kWTile || a->w_warps != 8 ||
        a->rows_stages != 1 || a->dx_stages != 1 || a->w_stages != 1 ||
        a->rows_smem != 0 || a->dx_smem != 0 || a->w_smem != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_bwd_simt(x, w_gate, w_up, w_down, sizes, experts, dy,
                                scratch, dx, dw_gate, dw_up, dw_down, rows, d,
                                f, E, G, s);
  }
  if (a->dtype != 1 || d % 8 || f % 8 || a->k_step != kBK)
    return (int)cudaErrorInvalidValue;
#define MOE_BWD_CASE(RM, RN, RWM, RW, XM, XN, XWM, XW, WM, WN, WWM, WW, S)  \
  if (a->rows_m == RM && a->rows_n == RN && a->rows_warps == RW &&         \
      a->dx_m == XM && a->dx_n == XN && a->dx_warps == XW &&               \
      a->w_m == WM && a->w_n == WN && a->w_warps == WW &&                  \
      a->rows_stages == S && a->dx_stages == S && a->w_stages == S &&      \
      (size_t)a->rows_smem == bwd_rows_smem(RM, RN, S) &&                  \
      (size_t)a->dx_smem == bwd_dx_smem(XM, XN, S) &&                      \
      (size_t)a->w_smem == bwd_weights_smem(WM, WN, S))                    \
    return (int)launch_bwd_mma<RM, RN, RWM, RW, XM, XN, XWM, XW, WM, WN,    \
                               WWM, WW, S>(                                 \
        x, w_gate, w_up, w_down, sizes, experts, dy, scratch, dx, dw_gate,  \
        dw_up, dw_down, rows, d, f, E, G, s);
  MOE_BWD_CASE(64, 64, 4, 4, 64, 128, 4, 8, 64, 64, 4, 4, 2)
#undef MOE_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
