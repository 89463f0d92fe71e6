// Paged attention over a two-tier KV page pool — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py
// (paged_attention_pallas, body _kernel; paged_prefill_pallas reuses it
// with the page table broadcast over S query rows).
//
// What it computes, per query row r and KV head kh: the G = H/K query
// heads of that group attend over the pages the row's page table lists,
// in page order p = 0..MP-1, with an online softmax in f32:
//   a page counts when   slot >= 0  and  p*P < length
//   a position counts when   pos < length  and, with a window,
//                            (length-1-pos) < window
//   a row with length 0 (padded prefill row) is written as zeros.
// Decode passes a (B, MP) table (row stride MP); prefill passes one (MP,)
// table with row stride 0 and per-row causal lengths.  Both run this one
// kernel, so prefill row t is bitwise equal to decode on the same table
// and length: each row's reduction order depends on nothing but the row.
// For the same reason there is no split-K over pages.
//
// Design.  One block per (row, kv-head): the G query heads of a group
// share each K/V page load.  The TPU walked pages along a sequential grid
// axis with the softmax state in VMEM scratch; here a loop inside the
// block walks them, with the state (m, l, acc) in shared memory.  Pages
// wholly outside the window or past the length are not read at all.  A
// position that is masked contributes exp(-inf) = 0 (not exp(0) later
// wiped by alpha = 0, as on the TPU), so a page the window masks entirely
// leaves the state as it was.  Every dot product and every sum runs in a
// fixed serial order.
//
// Bound.  Each valid K/V page is read once and nothing is recomputed, so
// the kernel is memory-bound: the least time is
//   (q bytes + valid K/V bytes + out bytes) / 3.35 TB/s   (H100 SXM HBM3).
// This first version is simple and right: scalar loads into shared memory,
// one page at a time, no wgmma, no TMA, no split-K.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;   // initial running max, as on the TPU

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int H, int K, int dh, int P, int MP,
                       long long table_row_stride, int window, float scale) {
  const int row = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;

  extern __shared__ float smem[];
  float* q_s = smem;                 // (G, dh)
  float* acc_s = q_s + G * dh;       // (G, dh)
  float* k_s = acc_s + G * dh;       // (P, dh)
  float* v_s = k_s + P * dh;         // (P, dh)
  float* p_s = v_s + P * dh;         // (G, P) scores, then probabilities
  float* m_s = p_s + G * P;          // (G,)
  float* l_s = m_s + G;              // (G,)
  float* a_s = l_s + G;              // (G,) rescale factor of this page

  const int length = lengths[row];
  const int* trow = table + row * table_row_stride;
  const long long q_base = ((long long)row * H + (long long)kh * G) * dh;

  for (int i = tid; i < G * dh; i += kThreads) {
    q_s[i] = to_f32(q[q_base + i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  // First page that holds a position inside the window.
  int first = 0;
  if (window > 0 && length - window > 0) first = (length - window) / P;
  const int n_pages = min(MP, (length + P - 1) / P);   // p*P < length

  for (int p = first; p < n_pages; ++p) {
    const int slot = trow[p];
    if (slot < 0) continue;                 // uniform across the block
    __syncthreads();                        // previous page fully consumed
    const long long page_base = (long long)slot * P * K * dh;
    for (int i = tid; i < P * dh; i += kThreads) {
      const int t = i / dh, d = i - t * dh;
      const long long off = page_base + ((long long)t * K + kh) * dh + d;
      k_s[i] = to_f32(k_pool[off]);
      v_s[i] = to_f32(v_pool[off]);
    }
    __syncthreads();
    // Scores s[g, t] = q[g] . k[t] * scale, or -inf where masked.
    for (int i = tid; i < G * P; i += kThreads) {
      const int g = i / P, t = i - g * P;
      const int pos = p * P + t;
      bool ok = pos < length;
      if (window > 0) ok = ok && (length - 1 - pos) < window;
      float s = minus_inf();
      if (ok) {
        const float* qg = q_s + g * dh;
        const float* kt = k_s + t * dh;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qg[d], kt[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    // Running max per query head.
    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = m_s[g];
      float m_cur = minus_inf();
      for (int t = 0; t < P; ++t) m_cur = fmaxf(m_cur, p_s[g * P + t]);
      const float m_new = fmaxf(m_prev, m_cur);
      a_s[g] = expf(m_prev - m_new);
      m_s[g] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < G * P; i += kThreads) {
      const int g = i / P;
      p_s[i] = expf(p_s[i] - m_s[g]);       // masked: exp(-inf) = 0
    }
    __syncthreads();
    for (int g = tid; g < G; g += kThreads) {
      float sum = 0.f;
      for (int t = 0; t < P; ++t) sum += p_s[g * P + t];
      l_s[g] = l_s[g] * a_s[g] + sum;
    }
    for (int i = tid; i < G * dh; i += kThreads) {
      const int g = i / dh, d = i - g * dh;
      const float* pg = p_s + g * P;
      float pv = 0.f;
      for (int t = 0; t < P; ++t) pv = fmaf(pg[t], v_s[t * dh + d], pv);
      acc_s[i] = acc_s[i] * a_s[g] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * dh; i += kThreads) {
    const int g = i / dh;
    const float l = l_s[g];
    const float o = l > 0.f ? acc_s[i] / l : 0.f;
    out[q_base + i] = from_f32<T>(o);
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const int* table, const int* lengths, void* out, int rows,
                   int H, int K, int dh, int P, int MP,
                   long long table_row_stride, int window, float scale,
                   size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid(rows, K);
  paged_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), table, lengths, static_cast<T*>(out),
      H, K, dh, P, MP, table_row_stride, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory the kernel asks for, in bytes.
long long paged_attention_smem_bytes(int H, int K, int dh, int P) {
  const int G = H / K;
  return (long long)sizeof(float) *
         (2LL * G * dh + 2LL * P * dh + (long long)G * P + 3LL * G);
}

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no window.
// Returns cudaGetLastError() after the launch (0 = launched).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lengths, void* out, int rows, int H,
                           int K, int dh, int P, int MP,
                           long long table_row_stride, int window,
                           float scale, int dtype, void* stream) {
  if (rows == 0) return 0;
  const size_t smem = (size_t)paged_attention_smem_bytes(H, K, dh, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* l = static_cast<const int*>(lengths);
  cudaError_t err;
  if (dtype == 0) {
    err = launch<float>(q, k_pool, v_pool, t, l, out, rows, H, K, dh, P, MP,
                        table_row_stride, window, scale, smem, s);
  } else if (dtype == 1) {
    err = launch<__nv_bfloat16>(q, k_pool, v_pool, t, l, out, rows, H, K, dh,
                                P, MP, table_row_stride, window, scale, smem,
                                s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
