// Flash attention, forward and backward — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// (flash_attention_pallas: forward flash_attention_fwd with body _kernel;
// its backward _fa_bwd recomputes through the jnp oracle, and here it is a
// kernel too).
//
// What it computes.  q (B, Sq, H, dh), k/v (B, Sk, K, dh) in the model's
// layout, H = G*K (GQA: query head h reads KV head h / G), scale
// 1/sqrt(dh), scores and softmax in f32.  Query row i sits at position
// qp = i + Sk - Sq.  Under causal, key kp is visible when kp <= qp and,
// with a window, qp - kp < window; a masked score is -1e30, as in
// mha_reference, so a row that sees any key gives its masked keys exactly
// 0, and a row that sees none (only when causal and Sq > Sk) gets the
// mean of V over all Sk keys, as mha_reference does.  Keys past Sk (the
// ragged last tile) are not keys at all: their score is -inf.
//
// Forward: one block per (q tile of 64 rows, head, batch).  K/V tiles of
// 64 keys are staged through shared memory as f32; the online softmax
// keeps (m, l) per row in registers and the output accumulator in
// registers; the output is written in q's dtype, and the per-row
// log-sum-exp m + log(l) in f32 (B, H, Sq) for the backward.  A K tile
// that no row of the q tile can see is skipped, unless the q tile holds a
// row that sees no key (that row needs every key).
//
// Backward: two launches, no atomics, so the gradients are bitwise the
// same from run to run.
//   (a) one block per (k tile, KV head, batch) walks the G query heads of
//       the group and the q tiles in a fixed order, recomputes
//       P = exp(s - lse) (1/Sk on a row that sees no key), and accumulates
//       dV += P^T dO and dK += dS^T Q in f32 registers, with
//       dS = P * (dP - D), dP = dO V^T, D = rowsum(dO * O).
//   (b) one block per (q tile, head, batch) accumulates dQ += dS K over
//       the k tiles.
//   D is computed inside each block from dO and O, each warp a row.
//
// Bound.  At the training shape (B=2, S=2048, 32/8 heads, dh=64, causal)
// the forward does 2*B*H*S*S*dh = 34 GFLOP on 25 MB: compute-bound
// (0.035 ms at 989 TFLOP/s bf16 against 0.008 ms of bytes).  This first
// version runs the products as scalar f32 FMAs on the CUDA cores from
// shared memory (each thread a 4 x 4 micro-tile, rows ty + 16a, columns
// tx + 16c, conflict-free with a row stride of width + 1): it is right
// and simple, far from the tensor-core bound.  wgmma, TMA and bf16
// operands are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;      // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kPad = 1;            // row padding of every shared tile
constexpr int kLP = kTile + kPad;  // row stride of a (64, 64) score tile
constexpr float kMasked = -1e30f;  // mha_reference's NEG_INF

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

// Key kp visible from the query at position qp?
__device__ __forceinline__ bool visible(int qp, int kp, int causal,
                                        int window) {
  if (!causal) return true;
  return kp <= qp && (window <= 0 || qp - kp < window);
}

// Does any query row r0..r1 see any key k0..k1?  The differences qp - kp
// cover [r0 + off - k1, r1 + off - k0]; a pair is visible when one lies
// in [0, window).
__device__ __forceinline__ bool tile_visible(int r0, int r1, int k0, int k1,
                                             int off, int causal,
                                             int window) {
  if (!causal) return true;
  if (r1 + off - k0 < 0) return false;
  if (window > 0 && r0 + off - k1 >= window) return false;
  return true;
}

// Rows row0 .. row0+63 of head h of a (B, S, NH, DH) tensor into a shared
// (64, DH + 1) f32 tile; rows past S are zeros.
template <typename T, int DH>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int b,
                                          int row0, int S, int NH, int h) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, d = idx - r * DH;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S) x = to_f32(src[(((long long)b * S + row) * NH + h) * DH + d]);
    dst[r * (DH + kPad) + d] = x;
  }
}

// s[a][c] = A[ty + 16a] . Bm[tx + 16c] over DH, both (64, DH + 1) tiles.
template <int DH>
__device__ __forceinline__ void tile_dots(float (&s)[4][4], const float* A,
                                          const float* Bm, int ty, int tx) {
  constexpr int LD = DH + kPad;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < DH; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * LD + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) bv[c] = Bm[(tx + 16 * c) * LD + d];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = fmaf(av[a], bv[c], s[a][c]);
  }
}

// acc[a][c] += sum_x A(ty + 16a, x) * Bm[x][tx + 16c] over the 64 rows x
// of Bm (a (64, DH + 1) tile); A(r, x) = A[r * AR + x * AX] reads a score
// tile as it is (AR = kLP, AX = 1) or transposed (AR = 1, AX = kLP).
template <int DH, int AR, int AX>
__device__ __forceinline__ void tile_accumulate(float (&acc)[4][DH / 16],
                                                const float* A,
                                                const float* Bm, int ty,
                                                int tx) {
  constexpr int LD = DH + kPad;
#pragma unroll 4
  for (int x = 0; x < kTile; ++x) {
    float av[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) av[a] = A[(ty + 16 * a) * AR + x * AX];
#pragma unroll
    for (int c = 0; c < DH / 16; ++c) {
      const float bv = Bm[x * LD + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(av[a], bv, acc[a][c]);
    }
  }
}

// d_s[r] = rowsum(dO * O) for the rows of a q tile: dO from its shared
// tile, O (the forward's output, in T) from device memory; one warp a row,
// a fixed order of sums.
template <typename T, int DH>
__device__ __forceinline__ void row_dot_do_o(float* d_s, const float* do_s,
                                             const T* out, int b, int q0,
                                             int Sq, int H, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float part = 0.f;
    if (row < Sq) {
      const T* o = out + (((long long)b * Sq + row) * H + h) * DH;
      for (int d = lane; d < DH; d += 32)
        part = fmaf(do_s[r * (DH + kPad) + d], to_f32(o[d]), part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) d_s[r] = part;
  }
}

// ------------------------------------------------------------------ forward
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int Sq, int Sk, int H, int K,
                 int causal, int window, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int NC = DH / 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = Sk - Sq;

  extern __shared__ float smem[];
  float* q_s = smem;                 // (64, LD)
  float* k_s = q_s + kTile * LD;     // (64, LD)
  float* v_s = k_s + kTile * LD;     // (64, LD)
  float* p_s = v_s + kTile * LD;     // (64, kLP) probabilities

  load_tile<T, DH>(q_s, q, b, q0, Sq, H, h);
  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = minus_inf();
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
  }
  const int r1 = min(q0 + kTile, Sq) - 1;
  const bool has_empty = causal && q0 + off < 0;
  const int n_kt = (Sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int k1 = min(k0 + kTile, Sk) - 1;
    if (!has_empty && !tile_visible(q0, r1, k0, k1, off, causal, window))
      continue;                                  // uniform across the block
    __syncthreads();                             // previous tile consumed
    load_tile<T, DH>(k_s, k, b, k0, Sk, K, kh);
    load_tile<T, DH>(v_s, v, b, k0, Sk, K, kh);
    __syncthreads();
    float s[4][4];
    tile_dots<DH>(s, q_s, k_s, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q0 + ty + 16 * a + off;
      float mt = minus_inf();
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        float x;
        if (kp >= Sk) x = minus_inf();           // not a key
        else if (!visible(qp, kp, causal, window)) x = kMasked;
        else x = s[a][c] * scale;
        s[a][c] = x;
        mt = fmaxf(mt, x);
      }
      // The 16 lanes tx of a row are 16 consecutive lanes of one warp.
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[a], mt);       // >= -1e30: a real key
      const float alpha = expf(m[a] - m_new);    // 0 on the first tile
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[a][c] - m_new);
        s[a][c] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[a] = l[a] * alpha + sum;
      m[a] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[a][c] *= alpha;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        p_s[(ty + 16 * a) * kLP + tx + 16 * c] = s[a][c];
    }
    __syncthreads();
    tile_accumulate<DH, kLP, 1>(acc, p_s, v_s, ty, tx);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
    T* o = out + (((long long)b * Sq + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_f32<T>(acc[a][c] / l[a]);
    if (tx == 0) lse[((long long)b * H + h) * Sq + row] = m[a] + logf(l[a]);
  }
}

// ------------------------------------------------------- backward: dK, dV
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ out,
                      const T* __restrict__ dout,
                      const float* __restrict__ lse, T* __restrict__ dk,
                      T* __restrict__ dv, int Sq, int Sk, int H, int K,
                      int causal, int window, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int NC = DH / 16;
  const int k0 = blockIdx.x * kTile, kh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = Sk - Sq;
  const int k1 = min(k0 + kTile, Sk) - 1;
  const float inv_sk = 1.f / (float)Sk;

  extern __shared__ float smem[];
  float* k_s = smem;                  // (64, LD) keys k0..
  float* v_s = k_s + kTile * LD;      // (64, LD)
  float* q_s = v_s + kTile * LD;      // (64, LD) the current q tile
  float* do_s = q_s + kTile * LD;     // (64, LD)
  float* p_s = do_s + kTile * LD;     // (64, kLP) P[i][j]
  float* ds_s = p_s + kTile * kLP;    // (64, kLP) dS[i][j]
  float* lse_s = ds_s + kTile * kLP;  // (64,)
  float* d_s = lse_s + kTile;         // (64,)

  load_tile<T, DH>(k_s, k, b, k0, Sk, K, kh);
  load_tile<T, DH>(v_s, v, b, k0, Sk, K, kh);
  // Rows j = ty + 16a of this k tile, columns d = tx + 16c.
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[a][c] = dv_acc[a][c] = 0.f;

  const int n_qt = (Sq + kTile - 1) / kTile;
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      const int r1 = min(q0 + kTile, Sq) - 1;
      const bool has_empty = causal && q0 + off < 0;
      if (!has_empty && !tile_visible(q0, r1, k0, k1, off, causal, window))
        continue;                                // uniform across the block
      __syncthreads();                           // previous q tile consumed
      load_tile<T, DH>(q_s, q, b, q0, Sq, H, h);
      load_tile<T, DH>(do_s, dout, b, q0, Sq, H, h);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] =
            row < Sq ? lse[((long long)b * H + h) * Sq + row] : 0.f;
      }
      __syncthreads();
      row_dot_do_o<T, DH>(d_s, do_s, out, b, q0, Sq, H, h);
      __syncthreads();
      // Rows i = ty + 16a of the q tile, columns j = tx + 16c of the k tile.
      float s[4][4], dp[4][4];
      tile_dots<DH>(s, q_s, k_s, ty, tx);
      tile_dots<DH>(dp, do_s, v_s, ty, tx);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = ty + 16 * a;
        const int row = q0 + i, qp = row + off;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = tx + 16 * c, kp = k0 + j;
          float p = 0.f, ds = 0.f;
          if (row < Sq && kp < Sk) {
            if (visible(qp, kp, causal, window)) {
              p = expf(s[a][c] * scale - lse_s[i]);
              ds = p * (dp[a][c] - d_s[i]);
            } else if (qp < 0) {
              p = inv_sk;                        // a row that sees no key
            }
          }
          p_s[i * kLP + j] = p;
          ds_s[i * kLP + j] = ds;
        }
      }
      __syncthreads();
      // dV[j][d] += sum_i P[i][j] dO[i][d];  dK[j][d] += sum_i dS[i][j] Q[i][d]
      tile_accumulate<DH, 1, kLP>(dv_acc, p_s, do_s, ty, tx);
      tile_accumulate<DH, 1, kLP>(dk_acc, ds_s, q_s, ty, tx);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int key = k0 + ty + 16 * a;
    if (key >= Sk) continue;
    const long long base = (((long long)b * Sk + key) * K + kh) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      dk[base + tx + 16 * c] = from_f32<T>(dk_acc[a][c] * scale);
      dv[base + tx + 16 * c] = from_f32<T>(dv_acc[a][c]);
    }
  }
}

// ------------------------------------------------------------ backward: dQ
template <typename T, int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    T* __restrict__ dq, int Sq, int Sk, int H, int K,
                    int causal, int window, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int NC = DH / 16;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = Sk - Sq;
  const int r1 = min(q0 + kTile, Sq) - 1;

  extern __shared__ float smem[];
  float* q_s = smem;                  // (64, LD)
  float* do_s = q_s + kTile * LD;     // (64, LD)
  float* k_s = do_s + kTile * LD;     // (64, LD)
  float* v_s = k_s + kTile * LD;      // (64, LD)
  float* ds_s = v_s + kTile * LD;     // (64, kLP)
  float* lse_s = ds_s + kTile * kLP;  // (64,)
  float* d_s = lse_s + kTile;         // (64,)

  load_tile<T, DH>(q_s, q, b, q0, Sq, H, h);
  load_tile<T, DH>(do_s, dout, b, q0, Sq, H, h);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] =
        row < Sq ? lse[((long long)b * H + h) * Sq + row] : 0.f;
  }
  __syncthreads();
  row_dot_do_o<T, DH>(d_s, do_s, out, b, q0, Sq, H, h);
  // Rows i = ty + 16a of the q tile, columns d = tx + 16c.
  float dq_acc[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq_acc[a][c] = 0.f;

  const int n_kt = (Sk + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    const int k1 = min(k0 + kTile, Sk) - 1;
    // A row that sees no key has dQ = 0: only visible tiles matter.
    if (!tile_visible(q0, r1, k0, k1, off, causal, window)) continue;
    __syncthreads();                 // previous tile consumed; d_s written
    load_tile<T, DH>(k_s, k, b, k0, Sk, K, kh);
    load_tile<T, DH>(v_s, v, b, k0, Sk, K, kh);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dots<DH>(s, q_s, k_s, ty, tx);
    tile_dots<DH>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = ty + 16 * a;
      const int row = q0 + i, qp = row + off;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = tx + 16 * c, kp = k0 + j;
        float ds = 0.f;
        if (row < Sq && kp < Sk && visible(qp, kp, causal, window)) {
          const float p = expf(s[a][c] * scale - lse_s[i]);
          ds = p * (dp[a][c] - d_s[i]);
        }
        ds_s[i * kLP + j] = ds;
      }
    }
    __syncthreads();
    // dQ[i][d] += sum_j dS[i][j] K[j][d]
    tile_accumulate<DH, kLP, 1>(dq_acc, ds_s, k_s, ty, tx);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= Sq) continue;
    T* o = dq + (((long long)b * Sq + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[tx + 16 * c] = from_f32<T>(dq_acc[a][c] * scale);
  }
}

// ----------------------------------------------------------------- launch
constexpr size_t fwd_smem(int dh) {
  return sizeof(float) * (3 * kTile * (dh + kPad) + kTile * kLP);
}
constexpr size_t dkdv_smem(int dh) {
  return sizeof(float) *
         (4 * kTile * (dh + kPad) + 2 * kTile * kLP + 2 * kTile);
}
constexpr size_t dq_smem(int dh) {
  return sizeof(float) * (4 * kTile * (dh + kPad) + kTile * kLP + 2 * kTile);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int DH>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, int B, int Sq, int Sk, int H, int K, int causal,
                int window, float scale, cudaStream_t stream) {
  const size_t smem = fwd_smem(DH);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kTile - 1) / kTile, H, B);
  flash_fwd_kernel<T, DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, Sq, Sk, H, K,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T, int DH>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, void* dq, void* dk,
                void* dv, int B, int Sq, int Sk, int H, int K, int causal,
                int window, float scale, cudaStream_t stream) {
  size_t smem = dkdv_smem(DH);
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid_kv((Sk + kTile - 1) / kTile, K, B);
  flash_bwd_dkdv_kernel<T, DH><<<grid_kv, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), lse, static_cast<T*>(dk),
      static_cast<T*>(dv), Sq, Sk, H, K, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  smem = dq_smem(DH);
  err = allow_smem(flash_bwd_dq_kernel<T, DH>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid_q((Sq + kTile - 1) / kTile, H, B);
  flash_bwd_dq_kernel<T, DH><<<grid_q, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(out),
      static_cast<const T*>(dout), lse, static_cast<T*>(dq), Sq, Sk, H, K,
      causal, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_dh(int dh, const void* q, const void* k, const void* v,
                   void* out, float* lse, int B, int Sq, int Sk, int H, int K,
                   int causal, int window, float scale, cudaStream_t s) {
  switch (dh) {
    case 16: return fwd<T, 16>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, window, scale, s);
    case 32: return fwd<T, 32>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, window, scale, s);
    case 64: return fwd<T, 64>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, window, scale, s);
    case 128: return fwd<T, 128>(q, k, v, out, lse, B, Sq, Sk, H, K, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_dh(int dh, const void* q, const void* k, const void* v,
                   const void* out, const void* dout, const float* lse,
                   void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                   int K, int causal, int window, float scale,
                   cudaStream_t s) {
  switch (dh) {
    case 16: return bwd<T, 16>(q, k, v, out, dout, lse, dq, dk, dv, B, Sq, Sk, H, K, causal, window, scale, s);
    case 32: return bwd<T, 32>(q, k, v, out, dout, lse, dq, dk, dv, B, Sq, Sk, H, K, causal, window, scale, s);
    case 64: return bwd<T, 64>(q, k, v, out, dout, lse, dq, dk, dv, B, Sq, Sk, H, K, causal, window, scale, s);
    case 128: return bwd<T, 128>(q, k, v, out, dout, lse, dq, dk, dv, B, Sq, Sk, H, K, causal, window, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; dh in {16, 32, 64, 128}; window <= 0
// means no window (a window applies only under causal).  q (B,Sq,H,dh),
// k/v (B,Sk,K,dh), out like q, lse (B,H,Sq) f32, all contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, int B, int Sq, int Sk,
                               int H, int K, int dh, int causal, int window,
                               float scale, int dtype, void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Sk <= 0 || K <= 0 || H % K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = fwd_dh<float>(dh, q, k, v, out, l, B, Sq, Sk, H, K, causal, window,
                        scale, s);
  } else if (dtype == 1) {
    err = fwd_dh<__nv_bfloat16>(dh, q, k, v, out, l, B, Sq, Sk, H, K, causal,
                                window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// The backward: dout like q; dq like q, dk/dv like k.  Two launches on
// `stream`, (a) dK and dV, then (b) dQ.
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const void* lse, void* dq, void* dk, void* dv,
                               int B, int Sq, int Sk, int H, int K, int dh,
                               int causal, int window, float scale, int dtype,
                               void* stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Sk <= 0 || K <= 0 || H % K) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  cudaError_t err;
  if (dtype == 0) {
    err = bwd_dh<float>(dh, q, k, v, out, dout, l, dq, dk, dv, B, Sq, Sk, H,
                        K, causal, window, scale, s);
  } else if (dtype == 1) {
    err = bwd_dh<__nv_bfloat16>(dh, q, k, v, out, dout, l, dq, dk, dv, B, Sq,
                                Sk, H, K, causal, window, scale, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
