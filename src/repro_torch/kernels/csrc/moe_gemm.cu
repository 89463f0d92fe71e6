// Grouped-expert SwiGLU over sorted ragged segments — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py (moe_grouped_ffn_pallas:
// _grouped_ffn_fwd, body _kernel, schedule make_group_metadata).
//
// What it computes.  x (T, d) holds rows sorted by group: segment g is the
// group_sizes[g] consecutive rows after the segments before it (empty
// segments allowed).  Row r of segment g uses expert e = group_experts[g]
// (e = g when no map is given) and becomes
//   h_r = silu(x_r . Wg[e]) * (x_r . Wu[e])      in f32, never rounded
//   y_r = h_r . Wd[e]                             in f32, stored in x's type
// with Wg/Wu (E, d, f) and Wd (E, f, d).  Rows past sum(group_sizes) are
// written as zeros.  A non-empty group whose expert lies outside [0, E)
// has its rows written as NaN: the kernel cannot raise, and a NaN is loud.
//
// Row invariance, bitwise.  Every output element is one thread's serial
// fmaf loop over d (for h) or over f (for y), in index order, so a row's
// bits depend on the row and its expert alone: not on T, on the group
// sizes or on where the row sits in a tile.  There is no split-K across
// blocks and no atomic.  That is what keeps one-shot prefill == chunked
// prefill == decode for MoE models.
//
// Design.  The TPU kernel walks a sequential grid of "logical tiles", one
// per (group, row tile) pair a segment overlaps, and keeps the f32 sum of
// the ff tiles in VMEM scratch.  Here the logical tiles are blocks that
// run in parallel, in two launches from this one source:
//   1. grid (logical tile, f tile of 64): h for the tile's rows, into an
//      f32 scratch (T, f) that the wrapper allocates;
//   2. grid (logical tile, d tile of 64): y from h.
// Every block of a logical tile multiplies rows of ONE expert, so each
// weight element it needs is loaded from device memory once per block and
// used for all 16 rows.  A block finds its tile on the device: the group
// sizes are copied into shared memory and thread 0 walks them, so the host
// never reads them (no synchronisation per layer).  The grid is the static
// worst case, ceil(T/16) + G blocks along x; blocks past the tiles in use
// zero the rows past sum(group_sizes) and exit.  At decode (T = 32 rows of
// ~22 experts) the first launch has about 180 busy blocks, the second about
// 550, for 132 SMs.
//
// Bound.  Every byte is read once at best: x, the weights of the experts
// that have rows, and y; the products are 6 T d f operations.  At the
// serving shapes the weights dominate, so the kernel is memory-bound:
//   (x + used experts' Wg, Wu, Wd + y) / 3.35 TB/s   (H100 SXM HBM3).
// This first version is simple and right: scalar f32 fmaf on the CUDA
// cores, no wgmma, no TMA, h through device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 16;        // rows per logical tile
constexpr int kCols = 64;        // output columns per block = threads
constexpr int kChunk = 128;      // reduction elements staged per step
constexpr int kMaxGroups = 1024; // MAX_GROUPS in moe_gemm.py

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// What thread 0 finds for logical tile `tile`.
struct TileInfo {
  int found;   // 1: rows [lo, hi) of group `group`
  int group;
  int lo;
  int hi;
  int used;    // when not found: logical tiles in use
  int total;   // when not found: rows covered by the segments
};

// Walk the segments in order; segment g covers rows [start, end) clamped
// to T, and overlaps row tiles start/kRows .. (end-1)/kRows.  The logical
// tiles are those (group, row tile) pairs in order.
__device__ void find_tile(const int* sizes_s, int G, int T, int tile,
                          TileInfo* info) {
  int t = 0, start = 0;
  for (int g = 0; g < G; ++g) {
    const int n = sizes_s[g];
    if (n <= 0) continue;
    const int end = min(start + n, T);
    if (end <= start) break;                  // sizes past T: clamped
    const int first = start / kRows;
    const int span = (end - 1) / kRows - first + 1;
    if (tile < t + span) {
      const int m = first + (tile - t);
      info->found = 1;
      info->group = g;
      info->lo = max(start, m * kRows);
      info->hi = min(end, (m + 1) * kRows);
      return;
    }
    t += span;
    start = end;
  }
  info->found = 0;
  info->used = t;
  info->total = start;
}

// Shared prologue of both launches: stage the sizes, find the tile.
__device__ void locate(const int* __restrict__ sizes, int G, int T,
                       int* sizes_s, TileInfo* info) {
  for (int g = threadIdx.x; g < G; g += kCols) sizes_s[g] = sizes[g];
  __syncthreads();
  if (threadIdx.x == 0) find_tile(sizes_s, G, T, blockIdx.x, info);
  __syncthreads();
}

// Launch 1: h[r, j] = silu(x_r . Wg[e][:, j]) * (x_r . Wu[e][:, j]).
template <typename T>
__global__ void __launch_bounds__(kCols)
moe_up_kernel(const T* __restrict__ x, const T* __restrict__ wg,
              const T* __restrict__ wu, const int* __restrict__ sizes,
              const int* __restrict__ experts, float* __restrict__ h,
              int rows, int d, int f, int E, int G) {
  __shared__ int sizes_s[kMaxGroups];
  __shared__ TileInfo info;
  __shared__ float x_s[kChunk][kRows];        // a chunk of d, 16 rows
  locate(sizes, G, rows, sizes_s, &info);
  if (!info.found) return;                    // uniform across the block
  const int lo = info.lo, n = info.hi - info.lo;
  const int e = experts ? experts[info.group] : info.group;
  const int j = blockIdx.y * kCols + threadIdx.x;
  if (e < 0 || e >= E) {
    if (j < f)
      for (int r = 0; r < n; ++r)
        h[(long long)(lo + r) * f + j] = __int_as_float(0x7fc00000);
    return;
  }
  const T* wg_e = wg + (long long)e * d * f;
  const T* wu_e = wu + (long long)e * d * f;
  float g_acc[kRows], u_acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) g_acc[r] = u_acc[r] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kc = min(kChunk, d - k0);
    __syncthreads();                          // previous chunk consumed
    for (int i = threadIdx.x; i < kRows * kChunk; i += kCols) {
      const int r = i / kChunk, c = i - r * kChunk;
      x_s[c][r] = (r < n && c < kc)
                      ? to_f32(x[(long long)(lo + r) * d + k0 + c]) : 0.f;
    }
    __syncthreads();
    if (j < f) {
      for (int c = 0; c < kc; ++c) {
        const long long w = (long long)(k0 + c) * f + j;
        const float wgv = to_f32(wg_e[w]);
        const float wuv = to_f32(wu_e[w]);
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
    for (int r = 0; r < kRows; ++r) {
      if (r < n) {
        const float g = g_acc[r];
        h[(long long)(lo + r) * f + j] = g / (1.f + expf(-g)) * u_acc[r];
      }
    }
  }
}

// Launch 2: y[r, c] = h_r . Wd[e][:, c]; spare blocks zero the tail rows.
template <typename T>
__global__ void __launch_bounds__(kCols)
moe_down_kernel(const float* __restrict__ h, const T* __restrict__ wd,
                const int* __restrict__ sizes,
                const int* __restrict__ experts, T* __restrict__ out,
                int rows, int d, int f, int E, int G) {
  __shared__ int sizes_s[kMaxGroups];
  __shared__ TileInfo info;
  __shared__ float h_s[kChunk][kRows];        // a chunk of f, 16 rows
  locate(sizes, G, rows, sizes_s, &info);
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (!info.found) {
    // Rows [total, rows), strided over the spare blocks (there is always
    // at least one: the grid has one more than the most tiles in use).
    const int spare = blockIdx.x - info.used;
    const int stride = gridDim.x - info.used;
    if (c < d)
      for (int r = info.total + spare; r < rows; r += stride)
        out[(long long)r * d + c] = from_f32<T>(0.f);
    return;
  }
  const int lo = info.lo, n = info.hi - info.lo;
  const int e = experts ? experts[info.group] : info.group;
  if (e < 0 || e >= E) {
    if (c < d)
      for (int r = 0; r < n; ++r)
        out[(long long)(lo + r) * d + c] =
            from_f32<T>(__int_as_float(0x7fc00000));
    return;
  }
  const T* wd_e = wd + (long long)e * f * d;
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
        const float w = to_f32(wd_e[(long long)(k0 + k) * d + c]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(h_s[k][r], w, acc[r]);
      }
    }
  }
  if (c < d) {
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < n) out[(long long)(lo + r) * d + c] = from_f32<T>(acc[r]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* wg, const void* wu,
                   const void* wd, const int* sizes, const int* experts,
                   float* h, void* out, int rows, int d, int f, int E, int G,
                   cudaStream_t stream) {
  const int tiles = (rows + kRows - 1) / kRows + G;
  dim3 up(tiles, (f + kCols - 1) / kCols);
  moe_up_kernel<T><<<up, kCols, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), sizes, experts, h, rows, d, f, E, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 down(tiles, (d + kCols - 1) / kCols);
  moe_down_kernel<T><<<down, kCols, 0, stream>>>(
      h, static_cast<const T*>(wd), sizes, experts, static_cast<T*>(out),
      rows, d, f, E, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  experts may be null (group g uses
// expert g).  h is an f32 scratch of rows * f.  Returns cudaGetLastError()
// after the launches (0 = both launched).
int moe_grouped_ffn_launch(const void* x, const void* w_gate,
                           const void* w_up, const void* w_down,
                           const void* group_sizes, const void* group_experts,
                           void* h, void* out, int rows, int d, int f, int E,
                           int G, int dtype, void* stream) {
  if (rows == 0) return 0;
  if (rows < 0 || d <= 0 || f <= 0 || E <= 0 || G <= 0 || G > kMaxGroups)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sizes = static_cast<const int*>(group_sizes);
  const int* experts = static_cast<const int*>(group_experts);
  float* hs = static_cast<float*>(h);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(x, w_gate, w_up, w_down, sizes, experts, hs, out,
                        rows, d, f, E, G, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(x, w_gate, w_up, w_down, sizes, experts, hs,
                                out, rows, d, f, E, G, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
