// SSD (Mamba2 state-space duality) intra-chunk block — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py (ssd_scan_pallas, body
// _kernel).
//
// What it computes.  For each chunk row b (a batch row's chunk of Q
// positions), head h and position i < Q, with no initial state:
//
//   y[b,i,h,p] = sum_{j<=i} (C_i . B_j) * exp(acum[i,h] - acum[j,h])
//                           * dt[j,h] * x[j,h,p]
//
// where a = dt * A (the per-step log decay, negative) and acum is its
// inclusive cumsum over the chunk.  x (Bc, Q, H, P) and B/C (Bc, Q, N) in
// float32 or bfloat16 (one dtype), dt (Bc, Q, H) f32, A (H,) f32; y
// (Bc, Q, H, P) f32.  Everything after the loads is f32.  The cross-chunk
// recurrence stays in the model code (models/ssm.py).
//
// Design.  One block per (row tile of 64 positions i, group of HB heads,
// chunk row b); 256 threads as 16 x 16.
//   - dt of the group's heads is staged in shared memory, and one thread a
//     head forms a = dt * A and its inclusive cumsum serially, in position
//     order: a fixed order.
//   - C rows of the tile are staged once as f32.  The j range 0 .. last i
//     of the tile is walked in steps of 64: each step stages B rows j, and
//     each thread computes a 4 x 4 micro-tile of scores C_i . B_j over N
//     (rows ty + 16a, columns tx + 16c) in registers.  The scores do not
//     depend on the head, so they are computed once for the HB heads.
//   - Per head, the weights w[i][j] = s * exp(acum_i - acum_j) go to
//     shared memory for j <= i only: exp is never evaluated above the
//     diagonal, where the exponent is positive and overflows (the JAX code
//     masks the exponent with -1e30 for the same reason).  Then dt_j * x_j
//     rows are staged, and each thread accumulates its 4 x P/16 outputs
//     over the 64 rows j in order.
//   Each output element is one thread's serial sum over j in a fixed
//   order, so two launches agree bit for bit, and a chunk's result does
//   not depend on Bc or on the head grouping.
//
// Bound.  At the hybrid prefill shape (Bc = 32 chunks of Q = 128, H = 112,
// P = N = 64, x/B/C in bf16) the function moves about 179 MB (x 59 MB in,
// y 117 MB out, dt 1.8 MB, B/C 1 MB): 0.054 ms at 3.35 TB/s, against 3.8
// GFLOP of causal work (0.004 ms at the bf16 tensor-core peak).  It is
// memory-bound.  This first version runs the products as scalar f32 FMAs
// from shared memory and reads x again for every row tile past the first
// (1.5 times at Q = 128): right and simple.  Keeping the score tile in
// registers across more heads, bf16 wgmma for the (i, j) x (j, p) product
// and TMA loads are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 64;         // positions i per tile, and j per step
constexpr int kThreads = 256;     // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kLW = kRows + 1;    // row stride of the (64, 64) weight tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Rows row0 .. row0+63 of a (Bc, Q, N) tensor into a (64, N + 1) f32
// tile; rows past Q are zeros.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int b,
                                          int row0, int Q, int N) {
  for (int idx = threadIdx.x; idx < kRows * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    const int row = row0 + r;
    dst[r * (N + 1) + n] =
        row < Q ? to_f32(src[((long long)b * Q + row) * N + n]) : 0.f;
  }
}

template <typename T, int P, int HB>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const T* __restrict__ Bm,
                 const T* __restrict__ Cm, float* __restrict__ y, int Q,
                 int H, int N) {
  constexpr int NC = P / 16;
  constexpr int LP = P + 1;
  const int LN = N + 1;
  const int i0 = blockIdx.x * kRows, h0 = blockIdx.y * HB, b = blockIdx.z;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i_end = min(i0 + kRows, Q);      // rows i0 .. i_end - 1

  extern __shared__ float smem[];
  float* c_s = smem;                  // (64, N + 1) C rows of the tile
  float* b_s = c_s + kRows * LN;      // (64, N + 1) B rows of the step
  float* x_s = b_s + kRows * LN;      // (64, P + 1) dt_j * x_j, one head
  float* w_s = x_s + kRows * LP;      // (64, kLW) weights, one head
  float* dt_s = w_s + kRows * kLW;    // (HB, Q)
  float* acum_s = dt_s + HB * Q;      // (HB, Q) inclusive cumsum of dt * A

  for (int idx = threadIdx.x; idx < HB * Q; idx += kThreads) {
    const int g = idx / Q, j = idx - g * Q;
    dt_s[idx] = dt[((long long)b * Q + j) * H + h0 + g];
  }
  load_rows<T>(c_s, Cm, b, i0, Q, N);
  __syncthreads();
  if (threadIdx.x < HB) {
    const int g = threadIdx.x;
    const float a_h = A[h0 + g];
    float run = 0.f;
    for (int j = 0; j < i_end; ++j) {
      // a = dt * A rounded, then added: no fused multiply-add.
      run = __fadd_rn(run, __fmul_rn(dt_s[g * Q + j], a_h));
      acum_s[g * Q + j] = run;
    }
  }

  float acc[HB][4][NC];
#pragma unroll
  for (int g = 0; g < HB; ++g)
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[g][a][c] = 0.f;

  for (int j0 = 0; j0 < i_end; j0 += kRows) {
    __syncthreads();                  // previous step consumed; acum ready
    load_rows<T>(b_s, Bm, b, j0, Q, N);
    __syncthreads();
    // s[a][c] = C_{i0 + ty + 16a} . B_{j0 + tx + 16c} over N.
    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float av[4], bv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) av[a] = c_s[(ty + 16 * a) * LN + n];
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = b_s[(tx + 16 * c) * LN + n];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = fmaf(av[a], bv[c], s[a][c]);
    }
#pragma unroll
    for (int g = 0; g < HB; ++g) {
      const int h = h0 + g;
      const float* acum = acum_s + g * Q;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + tx + 16 * c;
          float w = 0.f;
          if (j <= i && i < i_end) w = s[a][c] * expf(acum[i] - acum[j]);
          w_s[(ty + 16 * a) * kLW + tx + 16 * c] = w;
        }
      }
      for (int idx = threadIdx.x; idx < kRows * P; idx += kThreads) {
        const int r = idx / P, p = idx - r * P;
        const int j = j0 + r;
        float v = 0.f;
        if (j < Q)
          v = to_f32(x[(((long long)b * Q + j) * H + h) * P + p]) *
              dt_s[g * Q + j];
        x_s[r * LP + p] = v;
      }
      __syncthreads();
      // acc[g][a][c] += sum_r w[ty + 16a][r] * x_s[r][tx + 16c], r in order.
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        float av[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = w_s[(ty + 16 * a) * kLW + r];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float bv = x_s[r * LP + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a)
            acc[g][a][c] = fmaf(av[a], bv, acc[g][a][c]);
        }
      }
      __syncthreads();                // w_s and x_s free for the next head
    }
  }

#pragma unroll
  for (int g = 0; g < HB; ++g)
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      if (i >= Q) continue;
      float* o = y + (((long long)b * Q + i) * H + h0 + g) * P;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[tx + 16 * c] = acc[g][a][c];
    }
}

size_t smem_bytes(int P, int N, int HB, int Q) {
  return sizeof(float) * ((size_t)2 * kRows * (N + 1) + kRows * (P + 1) +
                          kRows * kLW + 2 * (size_t)HB * Q);
}

template <typename T, int P, int HB>
cudaError_t launch(const void* x, const float* dt, const float* A,
                   const void* Bm, const void* Cm, float* y, int Bc, int Q,
                   int H, int N, cudaStream_t stream) {
  const size_t smem = smem_bytes(P, N, HB, Q);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, P, HB>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((Q + kRows - 1) / kRows, H / HB, Bc);
  ssd_chunk_kernel<T, P, HB><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, A, static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), y, Q, H, N);
  return cudaGetLastError();
}

template <typename T, int P>
cudaError_t launch_hb(const void* x, const float* dt, const float* A,
                      const void* Bm, const void* Cm, float* y, int Bc,
                      int Q, int H, int N, cudaStream_t s) {
  if (H % 4 == 0) return launch<T, P, 4>(x, dt, A, Bm, Cm, y, Bc, Q, H, N, s);
  if (H % 2 == 0) return launch<T, P, 2>(x, dt, A, Bm, Cm, y, Bc, Q, H, N, s);
  return launch<T, P, 1>(x, dt, A, Bm, Cm, y, Bc, Q, H, N, s);
}

template <typename T>
cudaError_t launch_p(const void* x, const float* dt, const float* A,
                     const void* Bm, const void* Cm, float* y, int Bc, int Q,
                     int H, int P, int N, cudaStream_t s) {
  switch (P) {
    case 32: return launch_hb<T, 32>(x, dt, A, Bm, Cm, y, Bc, Q, H, N, s);
    case 64: return launch_hb<T, 64>(x, dt, A, Bm, Cm, y, Bc, Q, H, N, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype of x, Bm and Cm: 0 = float32, 1 = bfloat16; dt (Bc,Q,H) and A (H,)
// float32; y (Bc,Q,H,P) float32; all contiguous.  P in {32, 64}; 1 <= N <=
// 128; 1 <= Q <= 256.  Returns cudaGetLastError() after the launch (0 =
// launched).
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y, int Bc, int Q,
                    int H, int P, int N, int dtype, void* stream) {
  if (Bc == 0) return 0;
  if (Q <= 0 || Q > 256 || H <= 0 || N <= 0 || N > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  float* out = static_cast<float*>(y);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_p<float>(x, d, a, Bm, Cm, out, Bc, Q, H, P, N, s);
  } else if (dtype == 1) {
    err = launch_p<__nv_bfloat16>(x, d, a, Bm, Cm, out, Bc, Q, H, P, N, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

}  // extern "C"
