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

#include <cuda.h>            // CUtensorMap and its enums (types only)
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
// 412 GFLOP, 0.417 ms at 989 TF/s (H100 SXM, bf16 tensor cores).  The
// scratch's hi/lo pairs (below) double every product with a scratch
// operand, 26 rows d f operations in all: this design's own floor is
// 0.678 ms.  What bounds each launch, and what the design does about it:
//   1. rows (6 rows d f): x and dy are read once per f tile.  128-row
//      tiles over two consumer warpgroups with three accumulators (g, u,
//      da) of 64 columns each; the column tile is the fast grid index, so
//      the 8 blocks of a row tile read x and dy from the L2.
//   2. dx (8 rows d f): the four scratch planes are read once per d tile.
//      128 x 256 tiles (6 d tiles at granite's width), each step one
//      plane pair (dg or du, hi and lo) and its weight tile.
//   3. weights (12 rows d f, half of all the work): small output tiles
//      made x and the scratch planes be read again and again (about 7 GB
//      at training's shape with 64 x 64 tiles).  dWg and dWu share one
//      block and its x tile (one A, two accumulators), output tiles are
//      128 x 128 (128 x 256 for dWd), so each expert's operands are read
//      4 to 12 times, and the 72 blocks of an expert run together and
//      read them from the L2.
// On the card (H100 SXM) no launch reaches that: each main loop runs at
// the rate its tiles land in shared memory (with the products removed it
// takes as long), and each epilogue cost about as much again until it
// went through shared memory (below).  What did not pay, timed against
// this design in the same runs: two-block clusters multicasting the shared
// tiles, 128-column rows tiles (two stages fit; with 32-deep k steps,
// five), one n128 product for g and u or n256 ones in launch 3, and
// persistent blocks overlapping a tile's epilogue with the next tile's
// loads (slower: the epilogue then needs shared memory of its own, and
// the ring fewer stages).
//
// bf16 runs on Hopper's wgmma (m64nNk16, bf16 in, f32 accumulate) from
// 128-byte-swizzled shared tiles that TMA (cp.async.bulk.tensor) brings
// in.  Each block is three warpgroups: two consumers that issue wgmma and
// one producer whose first thread keeps an S-stage ring full, with an
// mbarrier per stage for "full" (the TMA bytes arrived) and one for
// "empty" (every consumer thread is done); setmaxnreg moves the
// producer's registers to the consumers.  Operands come as they lie:
// x^T and a^T reach launch 3 as MN-major A, dg, du and dy as MN-major B;
// Wg and Wu (d, f) reach launch 1 as MN-major B and launch 2 as K-major
// B, Wd (f, d) launch 1 as K-major B.  No transposed copies.  The host
// builds the tensor maps for each call (cuTensorMapEncodeTiled, fetched
// through cudaGetDriverEntryPoint) and passes them as __grid_constant__
// parameters, after binding the calling thread to the tensors' device
// (encoding needs a current context).  Rows of a physical tile outside
// its segment are loaded in launches 1 and 2 (each output row depends
// only on its own A row, and those rows are not stored); launch 3 zeroes
// the rows past a segment's end in every box of that step before the
// products.  The scratch holds
// each f32 intermediate as a bf16 hi/lo pair (hi = bf16(v), lo = bf16(v -
// hi), the bytes of the f32 array), as the forward carries h: a product
// with a scratch operand is A . hi then A . lo (or hi . B then lo . B) for
// each k16 into one f32 accumulator.  Every epilogue stages its tile in
// the idle ring and stores whole 16-byte row pieces.  float32 (the checks
// only) runs SIMT kernels, each output element one thread's serial fmaf
// loop in index order.

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

// The Hopper machinery of the bf16 backward: mbarrier rings, TMA tile
// loads, wgmma from 128-byte-swizzled shared tiles, warp specialisation.
constexpr int kWG = 128;                 // threads of a warpgroup
constexpr int kConsumers = 2 * kWG;      // two consumer warpgroups ...
constexpr int kBwdThreads = 3 * kWG;     // ... and the producer's
constexpr int kLine = 128;               // bytes of a swizzled tile row
constexpr int kAlign = 1024;             // a swizzle atom: 8 rows of kLine
// The tiles of the three launches (kernels/moe_gemm.py BWD_MMA): rows 128
// rows (64 a consumer warpgroup) by 64 columns of f; dx 128 rows by 256
// columns of d; weights 128 x 128 of dWg and dWu together, or 128 x 256
// of dWd.  kBK (64) is the k step of the rows and dx launches.
constexpr int kBwdM = 128;
constexpr int kRowsN = 64;
constexpr int kDxN = 256;
constexpr int kWN = 128;
constexpr int kWSlots = kBwdM / 64 + 4 * kWN / 64;  // boxes a weights stage

constexpr size_t bwd_rows_smem(int stages) {
  return (size_t)stages * (2 * kBwdM + 3 * kRowsN) * kBK * 2 + kAlign;
}
constexpr size_t bwd_dx_smem(int stages) {
  return (size_t)stages * (2 * kBwdM + kDxN) * kBK * 2 + kAlign;
}
constexpr size_t bwd_weights_smem(int stages, int step) {
  return (size_t)stages * kWSlots * step * kLine + kAlign;
}

__device__ __forceinline__ unsigned char* atom_aligned(unsigned char* p) {
  return p + ((kAlign - (smem_u32(p) & (kAlign - 1))) & (kAlign - 1));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}
// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t at = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(at), "r"(parity) : "memory");
  } while (!done);
}

// S stages: the producer's loads of step i land in stage i % S.  full[s]
// completes when the stage's bytes have arrived; empty[s] when every
// consumer thread is done with it.
template <int S>
struct Ring {
  uint64_t full[S], empty[S];

  __device__ void init() {             // one thread, before __syncthreads
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Producer: waits for step i's stage to be free and announces its bytes.
  __device__ int acquire(int i, int bytes) {
    const int st = i % S;
    mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
    mbar_expect_tx(&full[st], bytes);
    return st;
  }
  __device__ int wait_full(int i) {
    const int st = i % S;
    mbar_wait(&full[st], (i / S) & 1);
    return st;
  }
  __device__ void release(int i) { mbar_arrive(&empty[i % S]); }
};

// One box of a tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
// The two consumer warpgroups meet (named barrier 1; the producer's
// warpgroup never takes part).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// wgmma's descriptor of a shared tile as TMA's 128-byte swizzle lays it
// out: rows of kLine bytes, 8-row atoms 1024 bytes apart.  K-major (rows
// along M or N, K contiguous): advancing k by 16 adds 32 bytes, the
// leading offset is unused.  MN-major (one row per k, M or N contiguous):
// advancing k by 16 adds two atoms; 64-column blocks lie `block` bytes
// apart.
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lead >> 4) << 16) | ((uint64_t)(stride >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t kmajor(const void* p) {
  return gmma_desc(p, 16, 8 * kLine);
}
__device__ __forceinline__ uint64_t mnmajor(const void* p, uint32_t block) {
  return gmma_desc(p, block, 8 * kLine);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator accesses across the waits.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (m64 x nN, f32) += A (64 x 16) . B (16 x N), bf16 from shared tiles.
// TA / TB: 0 K-major, 1 MN-major.  Accumulator fragment: thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8), columns 8 j +
// 2 (t % 4) (+ 1) in d[4 j + {0, 1}] (d[4 j + {2, 3}] for the lower row).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// The epilogue goes through shared memory: a consumer warpgroup writes its
// 64 x N tile there as bf16 (the ring is idle once both warpgroups have
// passed their last product), then stores it a row at a time in 16-byte
// pieces.  Stored straight from the fragments, each warp instruction wrote
// 16 bytes into each of 8 rows, and the stores took about as long as the
// main loop.  A staged row is N + 8 elements, so the fragment's 8 rows
// fall on distinct banks.
template <int N>
__host__ __device__ constexpr int staged_bytes() {
  return 64 * (N + 8) * (int)sizeof(bf16);
}

// Where the fragment's pair (n8 block j, lower rows if half) lies in a
// staged tile of N columns.
template <int N>
__device__ __forceinline__ int staged_at(int j, int half) {
  const int t = threadIdx.x % kWG, lane = t & 31;
  return ((t >> 5) * 16 + (lane >> 2) + half * 8) * (N + 8) + j * 8 +
         (lane & 3) * 2;
}

// An accumulator as bf16 into a staged tile.
template <int N>
__device__ __forceinline__ void stage_acc(const float (&acc)[N / 2],
                                          bf16* stage) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<__nv_bfloat162*>(stage + staged_at<N>(j, half)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half],
                                acc[4 * j + 2 * half + 1]);
}

// A staged 64 x N tile to rows r0.. and columns c0.. of out (row stride
// `ld`), where inside [lo, hi) x [0, width); width a multiple of 8.
template <int N>
__device__ __forceinline__ void store_staged(const bf16* stage,
                                             bf16* __restrict__ out,
                                             long long ld, int r0, int lo,
                                             int hi, int c0, int width) {
  constexpr int CH = N / 8;                     // 16-byte pieces a row
  for (int i = threadIdx.x % kWG; i < 64 * CH; i += kWG) {
    const int r = r0 + i / CH, c = c0 + (i % CH) * 8;
    if (r < lo || r >= hi || c >= width) continue;
    *reinterpret_cast<uint4*>(out + r * ld + c) =
        *reinterpret_cast<const uint4*>(stage + (i / CH) * (N + 8) +
                                        (i % CH) * 8);
  }
}

// Both consumer warpgroups past their products: the ring may be reused.
// Then warpgroup wg's staging area, `bytes` a warpgroup.
__device__ __forceinline__ bf16* staging(unsigned char* tiles, int wg,
                                         int bytes) {
  consumers_sync();
  return reinterpret_cast<bf16*>(tiles + wg * bytes);
}

// Launch 1: g = x Wg[e], u = x Wu[e], da = dy Wd[e]^T for kBwdM rows (64 a
// consumer warpgroup) and kRowsN columns of f, over k steps of kBK of d
// through an S-stage ring.  A stage: the x and dy row tiles (K-major A),
// the Wg and Wu tiles as they lie ((d, f): MN-major B) and the Wd tile
// ((f, d): K-major B).  a, dg, du leave as hi/lo pairs.  Rows of the
// physical tile outside [lo, hi) are loaded and multiplied but not stored.
template <int S>
__global__ void __launch_bounds__(kBwdThreads, 1)
moe_bwd_rows_wgmma(__grid_constant__ const CUtensorMap tm_x,
                   __grid_constant__ const CUtensorMap tm_dy,
                   __grid_constant__ const CUtensorMap tm_wg,
                   __grid_constant__ const CUtensorMap tm_wu,
                   __grid_constant__ const CUtensorMap tm_wd,
                   const int* __restrict__ sizes,
                   const int* __restrict__ experts,
                   bf16* __restrict__ scratch, int rows, int d, int f, int E,
                   int G) {
  constexpr int XB = kBwdM * kLine, WB = kBK * kLine;
  constexpr int STAGE = 2 * XB + 3 * WB;
  __shared__ TileInfo info;
  __shared__ Ring<S> ring;
  extern __shared__ __align__(16) unsigned char smem_b[];
  unsigned char* tiles = atom_aligned(smem_b);
  if (threadIdx.x == 0) ring.init();
  locate(sizes, G, rows, kBwdM, &info);
  if (!info.found) return;                       // uniform across the block
  const int lo = info.lo, hi = info.hi;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) return;                   // launch 2 writes NaN
  const int m0 = lo / kBwdM * kBwdM, n0 = blockIdx.x * kRowsN;
  const int steps = cdiv(d, kBK);
  const int wg = threadIdx.x / kWG;
  if (wg == 2) {                                 // the producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWG) {
      for (int i = 0; i < steps; ++i) {
        const int st = ring.acquire(i, STAGE);
        unsigned char* p = tiles + st * STAGE;
        uint64_t* bar = &ring.full[st];
        const int k0 = i * kBK;
        tma_2d(p, &tm_x, bar, k0, m0);
        tma_2d(p + XB, &tm_dy, bar, k0, m0);
        tma_3d(p + 2 * XB, &tm_wg, bar, n0, k0, e);
        tma_3d(p + 2 * XB + WB, &tm_wu, bar, n0, k0, e);
        tma_3d(p + 2 * XB + 2 * WB, &tm_wd, bar, k0, n0, e);
      }
    }
  } else {                                       // the consumers
    setmaxnreg_inc<240>();
    float acc_g[kRowsN / 2], acc_u[kRowsN / 2], acc_d[kRowsN / 2];
#pragma unroll
    for (int v = 0; v < kRowsN / 2; ++v) acc_g[v] = acc_u[v] = acc_d[v] = 0.f;
    fence_acc(acc_g);
    fence_acc(acc_u);
    fence_acc(acc_d);
    for (int i = 0; i < steps; ++i) {
      const unsigned char* p = tiles + ring.wait_full(i) * STAGE;
      const unsigned char* ax = p + wg * 64 * kLine;
      const unsigned char* bw = p + 2 * XB;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const uint64_t a = kmajor(ax + ks * 32);
        wgmma_n64<0, 1>(acc_g, a, mnmajor(bw + ks * 16 * kLine, WB));
        wgmma_n64<0, 1>(acc_u, a, mnmajor(bw + WB + ks * 16 * kLine, WB));
        wgmma_n64<0, 0>(acc_d, kmajor(ax + XB + ks * 32),
                        kmajor(bw + 2 * WB + ks * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();                 // step i - 1's products are done
      if (i > 0) ring.release(i - 1);
    }
    wgmma_wait<0>();
    fence_acc(acc_g);
    fence_acc(acc_u);
    fence_acc(acc_d);

    // a, dg, du as hi/lo pairs: six staged planes (a hi, a lo, dg hi, ...).
    constexpr int PE = staged_bytes<kRowsN>() / (int)sizeof(bf16);
    bf16* stage = staging(tiles, wg, 6 * staged_bytes<kRowsN>());
#pragma unroll
    for (int j = 0; j < kRowsN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float v[3][2];                           // a, dg, du
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int at = 4 * j + 2 * half + k;
          swiglu_grad(acc_g[at], acc_u[at], acc_d[at], &v[0][k], &v[1][k],
                      &v[2][k]);
        }
        const int at = staged_at<kRowsN>(j, half);
#pragma unroll
        for (int q = 0; q < 3; ++q)
          store_hilo(stage + 2 * q * PE, stage + (2 * q + 1) * PE, at,
                     v[q][0], v[q][1]);
      }
    consumers_sync();
    const long long plane = (long long)rows * f;
    for (int q = 0; q < 6; ++q)
      store_staged<kRowsN>(stage + q * PE, scratch + q * plane, f,
                           m0 + wg * 64, lo, hi, n0, f);
  }
}

// Launch 2: dx = dg Wg[e]^T + du Wu[e]^T for kBwdM rows and kDxN columns
// of d.  Step 2k + w takes the k-th kBK columns of f for w = 0 (dg hi and
// lo, Wg) and w = 1 (du, Wu): every operand K-major as it lies, the hi
// then the lo product of each k16 into one accumulator.  Spare blocks
// zero the tail rows; a group whose expert is out of range gets NaN rows.
template <int S>
__global__ void __launch_bounds__(kBwdThreads, 1)
moe_bwd_dx_wgmma(__grid_constant__ const CUtensorMap tm_s,
                 __grid_constant__ const CUtensorMap tm_wg,
                 __grid_constant__ const CUtensorMap tm_wu,
                 const int* __restrict__ sizes,
                 const int* __restrict__ experts, bf16* __restrict__ dx,
                 int rows, int d, int f, int E, int G) {
  constexpr int AB = kBwdM * kLine, BB = kDxN * kLine;
  constexpr int STAGE = 2 * AB + BB;
  __shared__ TileInfo info;
  __shared__ Ring<S> ring;
  extern __shared__ __align__(16) unsigned char smem_b[];
  unsigned char* tiles = atom_aligned(smem_b);
  if (threadIdx.x == 0) ring.init();
  locate(sizes, G, rows, kBwdM, &info);
  const int n0 = blockIdx.x * kDxN;
  if (!info.found) {
    zero_tail(dx, info, rows, d, n0, kDxN);
    return;
  }
  const int lo = info.lo, hi = info.hi;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) {
    nan_rows(dx, lo, hi, d, n0, kDxN);
    return;
  }
  const int m0 = lo / kBwdM * kBwdM;
  const int steps = 2 * cdiv(f, kBK);
  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWG) {
      for (int i = 0; i < steps; ++i) {
        const int st = ring.acquire(i, STAGE);
        unsigned char* p = tiles + st * STAGE;
        uint64_t* bar = &ring.full[st];
        const int k0 = (i >> 1) * kBK, w = i & 1;
        // Scratch planes 2, 3 (dg hi, lo) or 4, 5 (du hi, lo).
        tma_2d(p, &tm_s, bar, k0, (2 + 2 * w) * rows + m0);
        tma_2d(p + AB, &tm_s, bar, k0, (3 + 2 * w) * rows + m0);
        tma_3d(p + 2 * AB, w ? &tm_wu : &tm_wg, bar, k0, n0, e);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    float acc[kDxN / 2];
#pragma unroll
    for (int v = 0; v < kDxN / 2; ++v) acc[v] = 0.f;
    fence_acc(acc);
    for (int i = 0; i < steps; ++i) {
      const unsigned char* p = tiles + ring.wait_full(i) * STAGE;
      const unsigned char* ah = p + wg * 64 * kLine;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        const uint64_t b = kmajor(p + 2 * AB + ks * 32);
        wgmma_n256<0, 0>(acc, kmajor(ah + ks * 32), b);
        wgmma_n256<0, 0>(acc, kmajor(ah + AB + ks * 32), b);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (i > 0) ring.release(i - 1);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    bf16* stage = staging(tiles, wg, staged_bytes<kDxN>());
    stage_acc<kDxN>(acc, stage);
    consumers_sync();
    store_staged<kDxN>(stage, dx, d, m0 + wg * 64, lo, hi, n0, d);
  }
}

// Launch 3: one output tile of expert blockIdx.y, summed over e's rows:
// blocks [0, n1) take a kBwdM x kWN tile of dWg = x^T dg and the same tile
// of dWu = x^T du, sharing the x tile; the rest a kBwdM x 2 kWN tile of
// dWd = a^T dy.  A step is STEP rows of one segment (e's groups in
// ascending order, each group's rows ascending); a stage holds every
// operand's (STEP, 64) boxes as they lie in (rows, d) and (rows, f): x^T
// and a^T reach wgmma as MN-major A, dg, du and dy as MN-major B.  Rows of
// a segment's last step past its end are zeroed in every box before the
// products (they may hold another group's rows, or NaN from rows no
// launch wrote).  Per k16: acc0 += A.B_hi then A.B_lo (dg, or dWd's first
// 128 columns with a_hi then a_lo), the same into acc1 (du, or the next
// 128 columns).
template <int S, int STEP>
__global__ void __launch_bounds__(kBwdThreads, 1)
moe_bwd_weights_wgmma(__grid_constant__ const CUtensorMap tm_x,
                      __grid_constant__ const CUtensorMap tm_dy,
                      __grid_constant__ const CUtensorMap tm_s,
                      const int* __restrict__ sizes,
                      const int* __restrict__ experts,
                      bf16* __restrict__ dwg, bf16* __restrict__ dwu,
                      bf16* __restrict__ dwd, int rows, int d, int f, int E,
                      int G) {
  constexpr int BOX = STEP * kLine;              // one (STEP, 64) box
  constexpr int STAGE = kWSlots * BOX;
  static_assert(STEP % 16 == 0 && BOX % kAlign == 0, "step");
  __shared__ int seg_lo[kMaxGroups], seg_hi[kMaxGroups];
  __shared__ int n_seg;
  __shared__ Ring<S> ring;
  extern __shared__ __align__(16) unsigned char smem_b[];
  unsigned char* tiles = atom_aligned(smem_b);
  if (threadIdx.x == 0) ring.init();
  const int e = blockIdx.y;
  expert_segments(sizes, experts, G, rows, e, seg_lo, seg_hi, &n_seg);
  const int n1 = cdiv(d, kBwdM) * cdiv(f, kWN);
  const bool fused = (int)blockIdx.x < n1;
  int m0, n0;
  if (fused) {
    m0 = blockIdx.x / cdiv(f, kWN) * kBwdM;
    n0 = blockIdx.x % cdiv(f, kWN) * kWN;
  } else {
    const int t = blockIdx.x - n1, tn = cdiv(d, 2 * kWN);
    m0 = t / tn * kBwdM;
    n0 = t % tn * 2 * kWN;
  }
  // Stage slots (boxes): fused: x (2: M halves), dg hi, dg lo, du hi, du
  // lo (2 each: N halves); dWd: a hi, a lo (2 each), dy (4).
  const int boxes = fused ? kWSlots : 2 * kBwdM / 64 + 2 * kWN / 64;
  const int wg = threadIdx.x / kWG;
  if (wg == 2) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 2 * kWG) {
      int i = 0;
      for (int s = 0; s < n_seg; ++s)
        for (int r = seg_lo[s]; r < seg_hi[s]; r += STEP, ++i) {
          const int st = ring.acquire(i, boxes * BOX);
          unsigned char* p = tiles + st * STAGE;
          uint64_t* bar = &ring.full[st];
          if (fused) {
            tma_2d(p, &tm_x, bar, m0, r);
            tma_2d(p + BOX, &tm_x, bar, m0 + 64, r);
            for (int q = 0; q < 4; ++q) {        // scratch planes 2..5
              tma_2d(p + (2 + 2 * q) * BOX, &tm_s, bar, n0,
                     (2 + q) * rows + r);
              tma_2d(p + (3 + 2 * q) * BOX, &tm_s, bar, n0 + 64,
                     (2 + q) * rows + r);
            }
          } else {
            for (int q = 0; q < 2; ++q) {        // scratch planes 0, 1
              tma_2d(p + 2 * q * BOX, &tm_s, bar, m0, q * rows + r);
              tma_2d(p + (2 * q + 1) * BOX, &tm_s, bar, m0 + 64,
                     q * rows + r);
            }
            for (int q = 0; q < 4; ++q)
              tma_2d(p + (4 + q) * BOX, &tm_dy, bar, n0 + 64 * q, r);
          }
        }
    }
  } else {
    setmaxnreg_inc<240>();
    float acc0[kWN / 2], acc1[kWN / 2];
#pragma unroll
    for (int v = 0; v < kWN / 2; ++v) acc0[v] = acc1[v] = 0.f;
    fence_acc(acc0);
    fence_acc(acc1);
    // Slots of A (hi, lo products) and of B (acc0 hi, lo; acc1 hi, lo).
    const int a_hi = wg, a_lo = fused ? wg : 2 + wg;
    const int b0h = fused ? 2 : 4, b0l = 4, b1h = 6, b1l = fused ? 8 : 6;
    int i = 0;
    for (int s = 0; s < n_seg; ++s)
      for (int r = seg_lo[s]; r < seg_hi[s]; r += STEP, ++i) {
        unsigned char* p = tiles + ring.wait_full(i) * STAGE;
        const int valid = min(STEP, seg_hi[s] - r);
        if (valid < STEP) {        // uniform: the segment's last step
          const int chunks = (STEP - valid) * (kLine / 16);
          for (int k = threadIdx.x; k < boxes * chunks; k += kConsumers) {
            const int b = k / chunks, c = k - b * chunks;
            *reinterpret_cast<uint4*>(p + b * BOX + valid * kLine + c * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          consumers_sync();
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < STEP / 16; ++ks) {
          const int k = ks * 16 * kLine;
          const uint64_t ah = mnmajor(p + a_hi * BOX + k, BOX);
          const uint64_t al = mnmajor(p + a_lo * BOX + k, BOX);
          wgmma_n128<1, 1>(acc0, ah, mnmajor(p + b0h * BOX + k, BOX));
          wgmma_n128<1, 1>(acc0, al, mnmajor(p + b0l * BOX + k, BOX));
          wgmma_n128<1, 1>(acc1, ah, mnmajor(p + b1h * BOX + k, BOX));
          wgmma_n128<1, 1>(acc1, al, mnmajor(p + b1l * BOX + k, BOX));
        }
        wgmma_commit();
        wgmma_wait<1>();
        if (i > 0) ring.release(i - 1);
      }
    wgmma_wait<0>();
    fence_acc(acc0);
    fence_acc(acc1);
    const long long per = (long long)d * f;
    const int M = fused ? d : f, N = fused ? f : d;
    bf16* out0 = fused ? dwg + e * per : dwd + e * per;
    bf16* out1 = fused ? dwu + e * per : out0;
    const int r0 = m0 + wg * 64;
    constexpr int TE = staged_bytes<kWN>() / (int)sizeof(bf16);
    bf16* stage = staging(tiles, wg, 2 * staged_bytes<kWN>());
    stage_acc<kWN>(acc0, stage);
    stage_acc<kWN>(acc1, stage + TE);
    consumers_sync();
    store_staged<kWN>(stage, out0, N, r0, 0, M, n0, N);
    store_staged<kWN>(stage + TE, out1, N, r0, 0, M, fused ? n0 : n0 + kWN,
                      N);
  }
}

int weight_tiles(int d, int f, int tm, int tn) {
  return 2 * cdiv(d, tm) * cdiv(f, tn) + cdiv(f, tm) * cdiv(d, tn);
}

// The driver's tensor-map encoder, fetched through the runtime (the
// library does not link libcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn tensor_map_encoder() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A map of a bf16 tensor of `rank` (2 or 3) dimensions, innermost first,
// each dimension after the first `stride` elements apart, read in boxes of
// `box` elements with 128-byte swizzle; a box's parts outside the tensor
// arrive as zeros.
bool bf16_map(CUtensorMap* map, const void* ptr, int rank,
              const long long* dims, const long long* strides,
              const int* box) {
  const EncodeTiledFn encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  cuuint64_t gd[3], gs[2];
  cuuint32_t bd[3], es[3] = {1, 1, 1};
  for (int i = 0; i < rank; ++i) {
    gd[i] = (cuuint64_t)dims[i];
    bd[i] = (cuuint32_t)box[i];
    if (i + 1 < rank) gs[i] = (cuuint64_t)strides[i] * sizeof(bf16);
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
                const_cast<void*>(ptr), gd, gs, bd, es,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 backward with S1, S2, S3 stages in the rows, dx and weights
// launches and STEP rows a weights step.  The tensor maps are built for
// each call (the pointers change): x and dy as (d, rows), the scratch as
// (f, 6 rows) (plane p's row r is row p rows + r), Wg and Wu as (f, d, E),
// Wd as (d, f, E).
template <int S1, int S2, int S3, int STEP>
cudaError_t launch_bwd_wgmma(const void* x, const void* wg, const void* wu,
                             const void* wd, const int* sizes,
                             const int* experts, const void* dy,
                             void* scratch, void* dx, void* dwg, void* dwu,
                             void* dwd, int rows, int d, int f, int E, int G,
                             cudaStream_t s) {
  // The tensor maps are encoded in the calling thread's context, and a
  // thread that has not yet touched the runtime (autograd's worker, whose
  // first work is this backward) has none: bind it to the tensors' device.
  cudaPointerAttributes at;
  cudaError_t err = cudaPointerGetAttributes(&at, x);
  if (err != cudaSuccess) return err;
  err = cudaSetDevice(at.device);
  if (err != cudaSuccess) return err;
  const long long by_d[2] = {d, rows}, by_f[2] = {f, 6LL * rows};
  const long long d_s[1] = {d}, f_s[1] = {f};
  const long long gu[3] = {f, d, E}, dn[3] = {d, f, E};
  const long long gu_s[2] = {f, (long long)d * f};
  const long long dn_s[2] = {d, (long long)f * d};
  const int row_box[2] = {64, kBwdM}, w_box[3] = {64, kBK, 1};
  const int dx_box[3] = {64, kDxN, 1}, step_box[2] = {64, STEP};
  CUtensorMap x_r, dy_r, wg_r, wu_r, wd_r, s_x, wg_x, wu_x, x_w, dy_w, s_w;
  if (!bf16_map(&x_r, x, 2, by_d, d_s, row_box) ||
      !bf16_map(&dy_r, dy, 2, by_d, d_s, row_box) ||
      !bf16_map(&wg_r, wg, 3, gu, gu_s, w_box) ||
      !bf16_map(&wu_r, wu, 3, gu, gu_s, w_box) ||
      !bf16_map(&wd_r, wd, 3, dn, dn_s, w_box) ||
      !bf16_map(&s_x, scratch, 2, by_f, f_s, row_box) ||
      !bf16_map(&wg_x, wg, 3, gu, gu_s, dx_box) ||
      !bf16_map(&wu_x, wu, 3, gu, gu_s, dx_box) ||
      !bf16_map(&x_w, x, 2, by_d, d_s, step_box) ||
      !bf16_map(&dy_w, dy, 2, by_d, d_s, step_box) ||
      !bf16_map(&s_w, scratch, 2, by_f, f_s, step_box))
    return cudaErrorInvalidValue;
  bf16* sc = static_cast<bf16*>(scratch);
  constexpr size_t r_bytes = bwd_rows_smem(S1);
  constexpr size_t x_bytes = bwd_dx_smem(S2);
  constexpr size_t w_bytes = bwd_weights_smem(S3, STEP);
  auto k1 = moe_bwd_rows_wgmma<S1>;
  auto k2 = moe_bwd_dx_wgmma<S2>;
  auto k3 = moe_bwd_weights_wgmma<S3, STEP>;
  err = allow_smem(k1, r_bytes);
  if (err != cudaSuccess) return err;
  k1<<<dim3(cdiv(f, kRowsN), tiles(rows, kBwdM) + G), kBwdThreads, r_bytes,
       s>>>(x_r, dy_r, wg_r, wu_r, wd_r, sizes, experts, sc, rows, d, f, E,
            G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(k2, x_bytes);
  if (err != cudaSuccess) return err;
  k2<<<dim3(cdiv(d, kDxN), tiles(rows, kBwdM) + G), kBwdThreads, x_bytes,
       s>>>(s_x, wg_x, wu_x, sizes, experts, static_cast<bf16*>(dx), rows, d,
            f, E, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(k3, w_bytes);
  if (err != cudaSuccess) return err;
  const int w_tiles = cdiv(d, kBwdM) * cdiv(f, kWN) +
                      cdiv(f, kBwdM) * cdiv(d, 2 * kWN);
  k3<<<dim3(w_tiles, E), kBwdThreads, w_bytes, s>>>(
      x_w, dy_w, s_w, sizes, experts, static_cast<bf16*>(dwg),
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

// The backward's shapes and plan (kernels/moe_gemm.py `_BwdArgs`): each
// launch's (k step, M tile, N tile, warps, stages, dynamic shared
// memory); the weights launch's k step is the rows of e it takes a step.
struct MoeBwdArgs {
  long long rows, d, f, E, G, dtype, rows_k, rows_m, rows_n, rows_warps,
      rows_stages, rows_smem, dx_k, dx_m, dx_n, dx_warps, dx_stages, dx_smem,
      w_k, w_m, w_n, w_warps, w_stages, w_smem;
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
    if (a->rows_k != kBwdChunk || a->dx_k != kBwdChunk ||
        a->w_k != kWRows || a->rows_m != kRows ||
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
  if (a->dtype != 1 || d % 8 || f % 8 || a->rows_k != kBK ||
      a->dx_k != kBK)
    return (int)cudaErrorInvalidValue;
#define MOE_BWD_CASE(S1, S2, S3, STEP)                                     \
  if (a->w_k == STEP && a->rows_m == kBwdM && a->rows_n == kRowsN &&        \
      a->dx_m == kBwdM && a->dx_n == kDxN && a->w_m == kBwdM &&             \
      a->w_n == kWN && a->rows_warps == kBwdThreads / 32 &&                 \
      a->dx_warps == kBwdThreads / 32 && a->w_warps == kBwdThreads / 32 &&  \
      a->rows_stages == S1 && a->dx_stages == S2 && a->w_stages == S3 &&    \
      (size_t)a->rows_smem == bwd_rows_smem(S1) &&                          \
      (size_t)a->dx_smem == bwd_dx_smem(S2) &&                              \
      (size_t)a->w_smem == bwd_weights_smem(S3, STEP))                      \
    return (int)launch_bwd_wgmma<S1, S2, S3, STEP>(                         \
        x, w_gate, w_up, w_down, sizes, experts, dy, scratch, dx, dw_gate,  \
        dw_up, dw_down, rows, d, f, E, G, s);
  MOE_BWD_CASE(4, 3, 5, 32)
#undef MOE_BWD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
