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
// ragged last tile) are not keys at all: their score is -inf.  The
// forward writes the output in q's dtype and the per-row log-sum-exp lse
// (B, H, Sq) in f32, natural log, for the backward.  The backward
// recomputes P = exp(s - lse) (1/Sk with dS = 0 on a row that sees no
// key), dP = dO V^T, D = rowsum(dO * O), dS = P * (dP - D), and returns
// dV = P^T dO, dK = scale dS^T Q, dQ = scale dS K.
//
// Bound.  At the training shape (B=2, S=2048, 32/8 heads, dh=64, causal)
// the forward does 2*B*H*S*S*dh = 34 GFLOP on 25 MB: compute-bound, 0.035
// ms at 989 TFLOP/s (bf16) against 0.008 ms of bytes.  The backward is
// counted as 2.5 times the forward's products: 0.087 ms.
//
// bf16 runs on tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulate)
// fed by ldmatrix from bf16 shared tiles whose rows are padded to dh + 8
// elements (the eight 16-byte rows an ldmatrix reads fall on distinct
// banks), filled by 16-byte cp.async into a 2-stage ring: the next tile is
// in flight while the current one is multiplied, one barrier a tile.  What
// the first (SIMT) version had, and what this one does about it:
//   - No tensor cores (scalar f32 FMAs, each thread a 4 x 4 micro-tile).
//     All seven products (S and P.V forward; S, dP, dV, dK in the dK/dV
//     kernel; S, dP, dQ in the dQ kernel) are mma.sync.  P and dS are
//     rounded to bf16 as A operands; m, l, row sums, lse, D and every
//     accumulator stay f32.  exp is ex2.approx on the special-function
//     unit, in the log2 domain.
//   - bf16 staged as f32 with 2-byte loads and a divide per element:
//     shared tiles are bf16 and copied 16 bytes a thread.
//   - Forward: one CTA holds 128 query rows (8 warps, dh <= 64) or 64 (4
//     warps) of one (b, h), each warp 16 rows.  (32 rows a warp, sharing
//     its K and V fragments, needed 213 registers and ran slower at 8
//     warps an SM; so did a 3-stage ring and 64-row CTAs at dh 64.)  The
//     online softmax keeps (m, l) per row in registers (log2 domain), its
//     row max and sum as quad shuffles.  It walks only the key tiles some
//     row can see (all of them when a row sees none).  q tiles are issued
//     heaviest first (blockIdx.z counts down from the last tile) against
//     causal imbalance.
//   - Backward occupancy and redundancy: D = rowsum(dO * O) is computed
//     once per row by a small pre-pass into an f32 (B, H, Sq) scratch that
//     the wrapper allocates; no block re-reads O.  dK/dV: one CTA of 4
//     warps per (64-key tile, KV head, b), each warp owning 16 keys with
//     its dK and dV rows in registers; it computes S^T = K Q^T and
//     dP^T = V dO^T with the keys as the M side, so P^T and dS^T are
//     already A fragments for dV += P^T dO and dK += dS^T Q (no shared
//     round trip), over q steps of 64 rows (32 at dh 112 and 128, to hold
//     the registers), the G query heads and the q steps in a fixed order.
//     At dh <= 64 its registers are capped for 3 CTAs an SM (a few bytes
//     spill, still faster than 2 CTAs; steps of 32 rows were slower).
//     dQ: one CTA of 4 warps per (64 q rows, h, b) over the visible key
//     tiles in order.  No atomics: the gradients are bitwise the same from
//     run to run.
//   - Masks cost nothing on a tile that every row of a warp sees whole.
//
// float32 runs on the card only in the checks (the f32 training check and
// the hybrid f32 checks, held to 2e-5 / 1e-4, which bf16 or TF32 operands
// cannot meet): it keeps the SIMT kernels, scalar f32 FMAs from f32 shared
// tiles (each thread a 4 x 4 micro-tile, rows ty + 16a, columns tx + 16c,
// conflict-free with a row stride of width + 1); its backward computes D
// inside each block.
//
// kernels/flash_attention.py `plan` picks the route, the tiles, the warps
// and the shared memory from (Sq, Sk, H, K, dh, dtype); the launchers
// refuse a plan whose shared memory is not what this file reckons.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kThreads = 256;      // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kPad = 1;            // row padding of every shared tile
constexpr int kLP = kTile + kPad;  // row stride of a (64, 64) score tile
constexpr float kMasked = -1e30f;  // mha_reference's NEG_INF

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
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
template <int DH>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int b,
                                          int row0, int S, int NH, int h) {
  for (int idx = threadIdx.x; idx < kTile * DH; idx += kThreads) {
    const int r = idx / DH, d = idx - r * DH;
    const int row = row0 + r;
    float x = 0.f;
    if (row < S) x = src[(((long long)b * S + row) * NH + h) * DH + d];
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
// tile, O (the forward's output) from device memory; one warp a row,
// a fixed order of sums.
template <int DH>
__device__ __forceinline__ void row_dot_do_o(float* d_s, const float* do_s,
                                             const float* out, int b, int q0,
                                             int Sq, int H, int h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int row = q0 + r;
    float part = 0.f;
    if (row < Sq) {
      const float* o = out + (((long long)b * Sq + row) * H + h) * DH;
      for (int d = lane; d < DH; d += 32)
        part = fmaf(do_s[r * (DH + kPad) + d], o[d], part);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (lane == 0) d_s[r] = part;
  }
}

// ------------------------------------------------------------ f32 forward
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_fwd_simt(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ out,
               float* __restrict__ lse, int Sq, int Sk, int H, int K,
               int causal, int window, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int NC = DH / 16;
  const int q0 = blockIdx.z * kTile, h = blockIdx.x, b = blockIdx.y;
  const int kh = h / (H / K);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int off = Sk - Sq;

  extern __shared__ float smem[];
  float* q_s = smem;                 // (64, LD)
  float* k_s = q_s + kTile * LD;     // (64, LD)
  float* v_s = k_s + kTile * LD;     // (64, LD)
  float* p_s = v_s + kTile * LD;     // (64, kLP) probabilities

  load_tile<DH>(q_s, q, b, q0, Sq, H, h);
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
    load_tile<DH>(k_s, k, b, k0, Sk, K, kh);
    load_tile<DH>(v_s, v, b, k0, Sk, K, kh);
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
    float* o = out + (((long long)b * Sq + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = acc[a][c] / l[a];
    if (tx == 0) lse[((long long)b * H + h) * Sq + row] = m[a] + logf(l[a]);
  }
}

// --------------------------------------------------- f32 backward: dK, dV
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_simt(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ out,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse, float* __restrict__ dk,
                    float* __restrict__ dv, int Sq, int Sk, int H, int K,
                    int causal, int window, float scale) {
  constexpr int LD = DH + kPad;
  constexpr int NC = DH / 16;
  const int k0 = blockIdx.z * kTile, kh = blockIdx.x, b = blockIdx.y;
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

  load_tile<DH>(k_s, k, b, k0, Sk, K, kh);
  load_tile<DH>(v_s, v, b, k0, Sk, K, kh);
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
      load_tile<DH>(q_s, q, b, q0, Sq, H, h);
      load_tile<DH>(do_s, dout, b, q0, Sq, H, h);
      if (threadIdx.x < kTile) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] =
            row < Sq ? lse[((long long)b * H + h) * Sq + row] : 0.f;
      }
      __syncthreads();
      row_dot_do_o<DH>(d_s, do_s, out, b, q0, Sq, H, h);
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
      dk[base + tx + 16 * c] = dk_acc[a][c] * scale;
      dv[base + tx + 16 * c] = dv_acc[a][c];
    }
  }
}

// -------------------------------------------------------- f32 backward: dQ
template <int DH>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_simt(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ out,
                  const float* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ dq,
                  int Sq, int Sk, int H, int K, int causal, int window,
                  float scale) {
  constexpr int LD = DH + kPad;
  constexpr int NC = DH / 16;
  const int q0 = blockIdx.z * kTile, h = blockIdx.x, b = blockIdx.y;
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

  load_tile<DH>(q_s, q, b, q0, Sq, H, h);
  load_tile<DH>(do_s, dout, b, q0, Sq, H, h);
  if (threadIdx.x < kTile) {
    const int row = q0 + threadIdx.x;
    lse_s[threadIdx.x] =
        row < Sq ? lse[((long long)b * H + h) * Sq + row] : 0.f;
  }
  __syncthreads();
  row_dot_do_o<DH>(d_s, do_s, out, b, q0, Sq, H, h);
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
    load_tile<DH>(k_s, k, b, k0, Sk, K, kh);
    load_tile<DH>(v_s, v, b, k0, Sk, K, kh);
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
    float* o = dq + (((long long)b * Sq + row) * H + h) * DH;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      o[tx + 16 * c] = dq_acc[a][c] * scale;
  }
}

// ------------------------------------------------- bf16, tensor cores
using bf16 = __nv_bfloat16;

constexpr int kBK = 64;          // keys per K/V tile; keys per dK/dV CTA
constexpr int kStages = 2;       // depth of every cp.async ring
constexpr int kBwdWarps = 4;     // warps of a dK/dV or dQ CTA
constexpr int kBwdRows = kBwdWarps * 16;   // query rows of a dQ CTA
constexpr int kMaxWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Query rows per step of the dK/dV kernel: 32 at dh 112 and 128 keep its
// S^T and dP^T tiles beside the dK and dV rows in registers.
constexpr int bwd_rows(int dh) { return dh <= 64 ? 64 : 32; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; src_bytes 0 zero-fills, reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (-inf -> 0); the bf16 kernels' exp.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows row0 .. row0+n-1 of head h of a (B, S, NH, DH) tensor into a shared
// (n, DH + 8) tile by 16-byte cp.async; rows past S are zero-filled.
template <int DH>
__device__ __forceinline__ void issue_rows(bf16* dst, const bf16* src, int b,
                                           int row0, int n, int S, int NH,
                                           int h) {
  constexpr int CH = DH / 8, LDS = DH + 8;
  for (int i = threadIdx.x; i < n * CH; i += blockDim.x) {
    const int r = i / CH, c = i - r * CH;
    const int row = row0 + r;
    const bf16* p = src;
    int bytes = 0;
    if (row < S) {
      p = src + (((long long)b * S + row) * NH + h) * DH + c * 8;
      bytes = 16;
    }
    cp_async16(dst + r * LDS + c * 8, p, bytes);
  }
}

// Entries row0 .. row0+n-1 of one (b, h) row of a (B, H, S) f32 array.
__device__ __forceinline__ void issue_vec(float* dst, const float* src,
                                          int row0, int n, int S) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int row = row0 + i;
    cp_async4(dst + i, row < S ? src + row : src, row < S ? 4 : 0);
  }
}

// The key tiles [lo, hi] that query rows r0..r1, all at positions >= 0,
// see under a causal mask (a window cuts the low end).
__device__ __forceinline__ void causal_key_tiles(int r0, int r1, int off,
                                                 int window, int n_kt,
                                                 int& lo, int& hi) {
  hi = min(n_kt - 1, (r1 + off) / kBK);
  lo = window > 0 ? max(0, r0 + off - window + 1) / kBK : 0;
}

// S (16 rows x 64 keys) += A (this warp's 16 rows of a shared (., DH + 8)
// tile) . Bm^T (64 rows of a shared tile), over DH.
template <int DH>
__device__ __forceinline__ void rows_by_keys(float (&s)[kBK / 8][4],
                                             const bf16* A, const bf16* Bm,
                                             int lane) {
  constexpr int LDS = DH + 8;
#pragma unroll
  for (int ks = 0; ks < DH / 16; ++ks) {
    uint32_t a[4];
    ldmatrix_x4(a, A + (lane & 15) * LDS + ks * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kBK / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, Bm + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                         ks * 16 + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// C fragments of a (16 x 16*NK) f32 tile as bf16 A fragments.
template <int NK>
__device__ __forceinline__ void to_a_frags(uint32_t (&pa)[NK][4],
                                           const float (&c)[2 * NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    pa[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    pa[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    pa[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    pa[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// acc (16 x DH) += A (16 x 16*NK, as A fragments) . Bm (16*NK rows of a
// shared (., DH + 8) tile).
template <int DH, int NK>
__device__ __forceinline__ void frags_by_rows(float (&acc)[DH / 8][4],
                                              const uint32_t (&a)[NK][4],
                                              const bf16* Bm, int lane) {
  constexpr int LDS = DH + 8;
#pragma unroll
  for (int dp = 0; dp < DH / 16; ++dp) {
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, Bm + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * LDS +
                               dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], a[kk], b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], a[kk], b[2], b[3]);
    }
  }
}

// A warp's 16 x DH f32 C-fragment tile, times `mul`, into its 16 rows of a
// shared (., DH + 8) bf16 tile, then rows base + r < S stored to head h of
// a (B, S, NH, DH) tensor with 16-byte stores.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* tile,
                                           const float (&acc)[DH / 8][4],
                                           float mul_lo, float mul_hi,
                                           bf16* dst, int b, int base, int S,
                                           int NH, int h, int lane) {
  constexpr int LDS = DH + 8, CH = DH / 8;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int col = n * 8 + (lane & 3) * 2;
    *reinterpret_cast<__nv_bfloat162*>(tile + (lane >> 2) * LDS + col) =
        __floats2bfloat162_rn(acc[n][0] * mul_lo, acc[n][1] * mul_lo);
    *reinterpret_cast<__nv_bfloat162*>(tile + ((lane >> 2) + 8) * LDS +
                                       col) =
        __floats2bfloat162_rn(acc[n][2] * mul_hi, acc[n][3] * mul_hi);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int r = i / CH, c = i - r * CH;
    if (base + r < S)
      *reinterpret_cast<uint4*>(
          dst + (((long long)b * S + base + r) * NH + h) * DH + c * 8) =
          *reinterpret_cast<const uint4*>(tile + r * LDS + c * 8);
  }
}

// ----------------------------------------------------------- bf16 forward
// One CTA: blockDim.x / 2 query rows (16 a warp) of head h = blockIdx.x,
// batch b = blockIdx.y; q tile gridDim.z - 1 - blockIdx.z (heaviest first).
template <int DH>
__global__ void __launch_bounds__(kMaxWarps * 32)
flash_fwd_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, bf16* __restrict__ out,
              float* __restrict__ lse, int Sq, int Sk, int H, int K,
              int causal, int window, float scale_log2) {
  constexpr int LDS = DH + 8;
  constexpr int NT = kBK / 8;        // key columns of S, 8 at a time
  constexpr int DT = DH / 8;         // dh columns of O, 8 at a time
  const int rows = blockDim.x / 2;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * rows;
  const int kh = h / (H / K);
  const int off = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_b);   // (rows, LDS)
  bf16* sK = sQ + rows * LDS;                   // kStages x (64, LDS)
  bf16* sV = sK + kStages * kBK * LDS;          // kStages x (64, LDS)

  const int r1 = min(q0 + rows, Sq) - 1;
  const int n_kt = (Sk + kBK - 1) / kBK;
  int lo = 0, hi = n_kt - 1;         // a row that sees no key needs them all
  if (causal && q0 + off >= 0) causal_key_tiles(q0, r1, off, window, n_kt,
                                                lo, hi);
  // Tile j goes to stage (j - lo) % kStages, one cp.async group a tile;
  // the query rows come with the first.
  auto issue = [&](int j) {
    const int st = (j - lo) % kStages;
    issue_rows<DH>(sK + st * kBK * LDS, k, b, j * kBK, kBK, Sk, K, kh);
    issue_rows<DH>(sV + st * kBK * LDS, v, b, j * kBK, kBK, Sk, K, kh);
  };
  issue_rows<DH>(sQ, q, b, q0, rows, Sq, H, h);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lo + i <= hi) issue(lo + i);
    cp_async_commit();
  }

  // This lane's two rows: (lane >> 2) of the warp's (c0, c1) and 8 below
  // (c2, c3).
  const int wq = q0 + warp * 16 + off;          // position of the warp's row 0
  const int qp_lo = wq + (lane >> 2), qp_hi = qp_lo + 8;
  float m_lo = minus_inf(), m_hi = minus_inf(), l_lo = 0.f, l_hi = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = lo; j <= hi; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile j landed; tile j-1 consumed
    if (j + kStages - 1 <= hi) issue(j + kStages - 1);
    cp_async_commit();
    const bf16* cK = sK + ((j - lo) % kStages) * kBK * LDS;
    const bf16* cV = sV + ((j - lo) % kStages) * kBK * LDS;

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    rows_by_keys<DH>(s, sQ + warp * 16 * LDS, cK, lane);

    // Scale into the log2 domain and mask: -1e30 for a masked key, -inf
    // for a key past Sk.  A tile every row of the warp sees whole skips
    // the per-element test.
    const int k0 = j * kBK;
    const bool whole =
        k0 + kBK <= Sk &&
        (!causal || (k0 + kBK - 1 <= wq &&
                     (window <= 0 || wq + 15 - k0 < window)));
    float mc_lo = minus_inf(), mc_hi = minus_inf();
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        float x = s[n][e] * scale_log2;
        if (!whole) {
          if (kp >= Sk) x = minus_inf();
          else if (!visible(e < 2 ? qp_lo : qp_hi, kp, causal, window))
            x = kMasked;
        }
        s[n][e] = x;
        if (e < 2) mc_lo = fmaxf(mc_lo, x);
        else mc_hi = fmaxf(mc_hi, x);
      }
    }
    // Every row holds key k0 < Sk of this tile, so the max is >= -1e30.
    const float mn_lo = fmaxf(m_lo, quad_max(mc_lo));
    const float mn_hi = fmaxf(m_hi, quad_max(mc_hi));
    const float al_lo = fast_exp2(m_lo - mn_lo);
    const float al_hi = fast_exp2(m_hi - mn_hi);
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = fast_exp2(s[n][0] - mn_lo);
      s[n][1] = fast_exp2(s[n][1] - mn_lo);
      s[n][2] = fast_exp2(s[n][2] - mn_hi);
      s[n][3] = fast_exp2(s[n][3] - mn_hi);
      rs_lo += s[n][0] + s[n][1];
      rs_hi += s[n][2] + s[n][3];
    }
    l_lo = fmaf(l_lo, al_lo, quad_sum(rs_lo));
    l_hi = fmaf(l_hi, al_hi, quad_sum(rs_hi));
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int n = 0; n < DT; ++n) {
      acc[n][0] *= al_lo;
      acc[n][1] *= al_lo;
      acc[n][2] *= al_hi;
      acc[n][3] *= al_hi;
    }
    uint32_t pa[kBK / 16][4];
    to_a_frags<kBK / 16>(pa, s);
    frags_by_rows<DH, kBK / 16>(acc, pa, cV, lane);      // O += P V
  }
  cp_async_wait<0>();
  __syncthreads();                   // every copy has landed

  // The warp's own rows of sQ stage its output.
  const int r0 = q0 + warp * 16;
  store_rows<DH>(sQ + warp * 16 * LDS, acc, 1.f / l_lo, 1.f / l_hi, out, b,
                 r0, Sq, H, h, lane);
  if ((lane & 3) == 0) {
    float* lrow = lse + ((long long)b * H + h) * Sq;
    const int r = r0 + (lane >> 2);
    if (r < Sq) lrow[r] = m_lo * kLn2 + logf(l_lo);
    if (r + 8 < Sq) lrow[r + 8] = m_hi * kLn2 + logf(l_hi);
  }
}

// ---------------------------------------------------- bf16 backward: D
// D[b, h, i] = rowsum(dO * O) in f32, once per row: 8 lanes a row, each
// 16 bytes at a time, summed in a fixed order.
template <int DH>
__global__ void __launch_bounds__(256)
flash_bwd_rowdot(const bf16* __restrict__ out, const bf16* __restrict__ dout,
                 float* __restrict__ dsum, int B, int Sq, int H) {
  constexpr int CH = DH / 8;
  const long long n_rows = (long long)B * Sq * H;
  const long long r = (long long)blockIdx.x * (blockDim.x / 8) +
                      (threadIdx.x >> 3);
  const int sub = threadIdx.x & 7;
  float part = 0.f;
  if (r < n_rows) {
    for (int c = sub; c < CH; c += 8) {
      const uint4 o4 = *reinterpret_cast<const uint4*>(out + r * DH + c * 8);
      const uint4 d4 = *reinterpret_cast<const uint4*>(dout + r * DH + c * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&o4);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&d4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]);
        const float2 df = __bfloat1622float2(d2[e]);
        part = fmaf(df.x, of.x, part);
        part = fmaf(df.y, of.y, part);
      }
    }
  }
  part += __shfl_xor_sync(0xffffffffu, part, 4);
  part += __shfl_xor_sync(0xffffffffu, part, 2);
  part += __shfl_xor_sync(0xffffffffu, part, 1);
  if (sub == 0 && r < n_rows) {
    const int h = (int)(r % H);
    const long long bi = r / H;                  // b * Sq + i
    const int i = (int)(bi % Sq);
    const long long b = bi / Sq;
    dsum[(b * H + h) * Sq + i] = part;
  }
}

// ------------------------------------------------ bf16 backward: dK, dV
// One CTA of 4 warps: keys k0 = 64 * blockIdx.z .. of KV head kh =
// blockIdx.x, batch blockIdx.y; warp w owns keys k0 + 16w .. k0 + 16w + 15
// with their dK and dV rows in registers.  It walks the G query heads and,
// in each, the q steps of MQ rows that its keys matter to, in that order.
template <int DH, int MQ>
__global__ void __launch_bounds__(kBwdWarps * 32, (DH <= 64 ? 3 : 2))
flash_bwd_dkdv_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int Sq, int Sk, int H, int K,
                   int causal, int window, float scale, float scale_log2) {
  constexpr int LDS = DH + 8;
  constexpr int NQ = MQ / 8;         // q columns of S^T, 8 at a time
  constexpr int DT = DH / 8;
  const int kh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBK;
  const int k1 = min(k0 + kBK, Sk) - 1;
  const int G = H / K;
  const int off = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float inv_sk = 1.f / (float)Sk;

  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* sK = reinterpret_cast<bf16*>(smem_b);     // (64, LDS)
  bf16* sV = sK + kBK * LDS;                    // (64, LDS)
  bf16* sQ = sV + kBK * LDS;                    // kStages x (MQ, LDS)
  bf16* sDO = sQ + kStages * MQ * LDS;          // kStages x (MQ, LDS)
  float* sL = reinterpret_cast<float*>(sDO + kStages * MQ * LDS);
  float* sD = sL + kStages * MQ;                // kStages x (MQ,) each

  // Step t = g * n_qt + qt.  A q step matters when a row of it sees a key
  // of this tile, or holds a row that sees no key (P = 1/Sk there).
  const int n_qt = (Sq + MQ - 1) / MQ;
  const int total = G * n_qt;
  auto matters = [&](int t) {
    const int r0 = (t % n_qt) * MQ;
    const int r1 = min(r0 + MQ, Sq) - 1;
    return !causal || r0 + off < 0 ||
           tile_visible(r0, r1, k0, k1, off, causal, window);
  };
  auto next = [&](int t) {
    while (t < total && !matters(t)) ++t;
    return t;
  };
  auto issue = [&](int t, int st) {
    const int g = t / n_qt, r0 = (t - g * n_qt) * MQ;
    const int h = kh * G + g;
    issue_rows<DH>(sQ + st * MQ * LDS, q, b, r0, MQ, Sq, H, h);
    issue_rows<DH>(sDO + st * MQ * LDS, dout, b, r0, MQ, Sq, H, h);
    const long long bh = ((long long)b * H + h) * Sq;
    issue_vec(sL + st * MQ, lse + bh, r0, MQ, Sq);
    issue_vec(sD + st * MQ, dsum + bh, r0, MQ, Sq);
  };

  // Step i (the i-th that matters) goes to stage i % kStages, one cp.async
  // group a step; the CTA's keys come with the first.
  issue_rows<DH>(sK, k, b, k0, kBK, Sk, K, kh);
  issue_rows<DH>(sV, v, b, k0, kBK, Sk, K, kh);
  int t = next(0);                   // the step computed next
  int t_in = t;                      // the step issued next
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (t_in < total) {
      issue(t_in, i);
      t_in = next(t_in + 1);
    }
    cp_async_commit();
  }

  const int wk = k0 + warp * 16;     // the warp's first key
  const int key_lo = wk + (lane >> 2), key_hi = key_lo + 8;
  float dk_acc[DT][4], dv_acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int i = 0; t < total; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // step i landed; step i-1 consumed
    if (t_in < total) {
      issue(t_in, (i + kStages - 1) % kStages);
      t_in = next(t_in + 1);
    }
    cp_async_commit();
    const int st = i % kStages;
    const bf16* cQ = sQ + st * MQ * LDS;
    const bf16* cDO = sDO + st * MQ * LDS;
    const float* cL = sL + st * MQ;
    const float* cD = sD + st * MQ;
    const int r0 = (t % n_qt) * MQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x MQ q rows.
    float sT[NQ][4], dpT[NQ][4];
#pragma unroll
    for (int n = 0; n < NQ; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      uint32_t ka[4], va[4];
      const int a_off = (warp * 16 + (lane & 15)) * LDS + ks * 16 +
                        (lane >> 4) * 8;
      ldmatrix_x4(ka, sK + a_off);
      ldmatrix_x4(va, sV + a_off);
#pragma unroll
      for (int np = 0; np < MQ / 16; ++np) {
        const int b_off = (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                          ks * 16 + ((lane >> 3) & 1) * 8;
        uint32_t bq[4], bd[4];
        ldmatrix_x4(bq, cQ + b_off);
        ldmatrix_x4(bd, cDO + b_off);
        mma_bf16(sT[2 * np], ka, bq[0], bq[1]);
        mma_bf16(sT[2 * np + 1], ka, bq[2], bq[3]);
        mma_bf16(dpT[2 * np], va, bd[0], bd[1]);
        mma_bf16(dpT[2 * np + 1], va, bd[2], bd[3]);
      }
    }
    // P^T and dS^T in place.  A step whose rows all see all the warp's keys
    // skips the per-element test.
    const bool whole =
        r0 + MQ <= Sq && wk + 15 < Sk &&
        (!causal || (wk + 15 <= r0 + off &&
                     (window <= 0 || r0 + MQ - 1 + off - wk < window)));
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int col0 = n * 8 + (lane & 3) * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(cL + col0);
      const float2 d2 = *reinterpret_cast<const float2*>(cD + col0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = col0 + (e & 1);
        const int row = r0 + col, qp = row + off;
        const int kp = e < 2 ? key_lo : key_hi;
        float p = 0.f, ds = 0.f;
        if (whole || (row < Sq && kp < Sk && visible(qp, kp, causal, window))) {
          p = fast_exp2(fmaf(sT[n][e], scale_log2,
                         -(e & 1 ? l2.y : l2.x) * kLog2e));
          ds = p * (dpT[n][e] - (e & 1 ? d2.y : d2.x));
        } else if (qp < 0 && row < Sq && kp < Sk) {
          p = inv_sk;                  // a row that sees no key
        }
        sT[n][e] = p;
        dpT[n][e] = ds;
      }
    }
    uint32_t fa[MQ / 16][4];
    to_a_frags<MQ / 16>(fa, sT);
    frags_by_rows<DH, MQ / 16>(dv_acc, fa, cDO, lane);    // dV += P^T dO
    to_a_frags<MQ / 16>(fa, dpT);
    frags_by_rows<DH, MQ / 16>(dk_acc, fa, cQ, lane);     // dK += dS^T Q
    t = next(t + 1);
  }
  cp_async_wait<0>();
  __syncthreads();                   // every copy has landed

  // The warp's own rows of sK and sV stage dK and dV.
  store_rows<DH>(sK + warp * 16 * LDS, dk_acc, scale, scale, dk, b, wk, Sk,
                 K, kh, lane);
  store_rows<DH>(sV + warp * 16 * LDS, dv_acc, 1.f, 1.f, dv, b, wk, Sk, K,
                 kh, lane);
}

// ----------------------------------------------------- bf16 backward: dQ
// One CTA of 4 warps: 64 query rows of head h = blockIdx.x, batch
// blockIdx.y, q tile gridDim.z - 1 - blockIdx.z; the key tiles its rows
// see, in order.  A row that sees no key has dQ = 0.
template <int DH>
__global__ void __launch_bounds__(kBwdWarps * 32, (DH <= 64 ? 4 : 1))
flash_bwd_dq_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ dsum, bf16* __restrict__ dq,
                 int Sq, int Sk, int H, int K, int causal, int window,
                 float scale, float scale_log2) {
  constexpr int LDS = DH + 8;
  constexpr int NT = kBK / 8;
  constexpr int DT = DH / 8;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBwdRows;
  const int kh = h / (H / K);
  const int off = Sk - Sq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_b);     // (64, LDS)
  bf16* sDO = sQ + kBwdRows * LDS;              // (64, LDS)
  bf16* sK = sDO + kBwdRows * LDS;              // kStages x (64, LDS)
  bf16* sV = sK + kStages * kBK * LDS;          // kStages x (64, LDS)

  const int r1 = min(q0 + kBwdRows, Sq) - 1;
  const int n_kt = (Sk + kBK - 1) / kBK;
  int lo = 0, hi = n_kt - 1;
  if (causal) {
    const int rv = max(q0, -off);    // the first row that sees a key
    if (rv > r1) hi = -1;
    else causal_key_tiles(rv, r1, off, window, n_kt, lo, hi);
  }
  auto issue = [&](int j) {
    const int st = (j - lo) % kStages;
    issue_rows<DH>(sK + st * kBK * LDS, k, b, j * kBK, kBK, Sk, K, kh);
    issue_rows<DH>(sV + st * kBK * LDS, v, b, j * kBK, kBK, Sk, K, kh);
  };
  issue_rows<DH>(sQ, q, b, q0, kBwdRows, Sq, H, h);
  issue_rows<DH>(sDO, dout, b, q0, kBwdRows, Sq, H, h);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (lo + i <= hi) issue(lo + i);
    cp_async_commit();
  }

  const int wq = q0 + warp * 16 + off;
  const int row_lo = q0 + warp * 16 + (lane >> 2), row_hi = row_lo + 8;
  const int qp_lo = row_lo + off, qp_hi = row_hi + off;
  const long long bh = ((long long)b * H + h) * Sq;
  const float l2_lo = row_lo < Sq ? lse[bh + row_lo] * kLog2e : 0.f;
  const float l2_hi = row_hi < Sq ? lse[bh + row_hi] * kLog2e : 0.f;
  const float d_lo = row_lo < Sq ? dsum[bh + row_lo] : 0.f;
  const float d_hi = row_hi < Sq ? dsum[bh + row_hi] : 0.f;
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = lo; j <= hi; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // tile j landed; tile j-1 consumed
    if (j + kStages - 1 <= hi) issue(j + kStages - 1);
    cp_async_commit();
    const bf16* cK = sK + ((j - lo) % kStages) * kBK * LDS;
    const bf16* cV = sV + ((j - lo) % kStages) * kBK * LDS;

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    rows_by_keys<DH>(s, sQ + warp * 16 * LDS, cK, lane);
    rows_by_keys<DH>(dp, sDO + warp * 16 * LDS, cV, lane);

    const int k0 = j * kBK;
    const bool whole =
        k0 + kBK <= Sk &&
        (!causal || (k0 + kBK - 1 <= wq &&
                     (window <= 0 || wq + 15 - k0 < window)));
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = k0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const bool lo_row = e < 2;
        const int row = lo_row ? row_lo : row_hi;
        const int qp = lo_row ? qp_lo : qp_hi;
        float ds = 0.f;
        if (whole || (row < Sq && kp < Sk && visible(qp, kp, causal, window))) {
          const float p =
              fast_exp2(fmaf(s[n][e], scale_log2, -(lo_row ? l2_lo : l2_hi)));
          ds = p * (dp[n][e] - (lo_row ? d_lo : d_hi));
        }
        s[n][e] = ds;
      }
    }
    uint32_t fa[kBK / 16][4];
    to_a_frags<kBK / 16>(fa, s);
    frags_by_rows<DH, kBK / 16>(acc, fa, cK, lane);      // dQ += dS K
  }
  cp_async_wait<0>();
  __syncthreads();                   // every copy has landed
  store_rows<DH>(sQ + warp * 16 * LDS, acc, scale, scale, dq, b,
                 q0 + warp * 16, Sq, H, h, lane);
}

// ----------------------------------------------------------------- launch
// Shared memory of each kernel; kernels/flash_attention.py `plan` computes
// the same numbers, and a launch whose plan differs is refused.
constexpr size_t simt_fwd_smem(int dh) {
  return sizeof(float) * (3 * kTile * (dh + kPad) + kTile * kLP);
}
constexpr size_t simt_dkdv_smem(int dh) {
  return sizeof(float) *
         (4 * kTile * (dh + kPad) + 2 * kTile * kLP + 2 * kTile);
}
constexpr size_t simt_dq_smem(int dh) {
  return sizeof(float) * (4 * kTile * (dh + kPad) + kTile * kLP + 2 * kTile);
}
constexpr size_t mma_fwd_smem(int dh, int rows) {
  return 2 * (size_t)(dh + 8) * (rows + 2 * kStages * kBK);
}
constexpr size_t mma_dkdv_smem(int dh) {
  return 2 * (size_t)(dh + 8) *
             (2 * kBK + 2 * kStages * bwd_rows(dh)) +
         sizeof(float) * 2 * kStages * bwd_rows(dh);
}
constexpr size_t mma_dq_smem(int dh) {
  return 2 * (size_t)(dh + 8) * (2 * kBwdRows + 2 * kStages * kBK);
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

}  // namespace

// The shapes and the plan of one call, every field 8 bytes wide
// (kernels/flash_attention.py `_Args` mirrors it).  q (B,Sq,H,dh), k/v
// (B,Sk,K,dh), out/dout/dq like q, dk/dv like k, lse and the backward's
// row-dot scratch (B,H,Sq) f32, all contiguous, bf16 ones 16-byte aligned.
// dtype 0 = float32 (SIMT), 1 = bfloat16 (tensor cores); dh in {16, 32,
// 64, 112, 128}; window <= 0 means none (a window applies only under
// causal).  rows_per_cta and warps are the forward's; the smem fields are
// the plan's, checked against this file's.  Every grid is (heads, B,
// tiles).
struct FlashArgs {
  long long B, Sq, Sk, H, K, dh, causal, window, dtype, rows_per_cta, warps,
      fwd_smem, dkdv_smem, dq_smem;
  double scale;
};

namespace {

bool plan_ok(const FlashArgs* a) {
  const int dh = (int)a->dh;
  if (a->B <= 0 || a->Sq <= 0 || a->Sk <= 0 || a->K <= 0 || a->H % a->K)
    return false;
  if (dh != 16 && dh != 32 && dh != 64 && dh != 112 && dh != 128)
    return false;
  if (a->dtype == 0)
    return a->rows_per_cta == kTile && a->warps == kThreads / 32 &&
           (size_t)a->fwd_smem == simt_fwd_smem(dh) &&
           (size_t)a->dkdv_smem == simt_dkdv_smem(dh) &&
           (size_t)a->dq_smem == simt_dq_smem(dh);
  return a->dtype == 1 && a->warps >= 1 && a->warps <= kMaxWarps &&
         a->rows_per_cta == a->warps * 16 &&
         (size_t)a->fwd_smem == mma_fwd_smem(dh, (int)a->rows_per_cta) &&
         (size_t)a->dkdv_smem == mma_dkdv_smem(dh) &&
         (size_t)a->dq_smem == mma_dq_smem(dh);
}

template <int DH>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, const FlashArgs* a, cudaStream_t s) {
  const int B = (int)a->B, Sq = (int)a->Sq, Sk = (int)a->Sk, H = (int)a->H,
            K = (int)a->K, causal = (int)a->causal, window = (int)a->window;
  const float scale = (float)a->scale;
  const size_t smem = (size_t)a->fwd_smem;
  if (a->dtype == 0) {
    cudaError_t err = allow_smem(flash_fwd_simt<DH>, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_simt<DH><<<dim3(H, B, tiles(Sq, kTile)), kThreads, smem,
                                s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, Sq, Sk,
        H, K, causal, window, scale);
    return cudaGetLastError();
  }
  cudaError_t err = allow_smem(flash_fwd_mma<DH>, smem);
  if (err != cudaSuccess) return err;
  const int rows = (int)a->rows_per_cta;
  flash_fwd_mma<DH><<<dim3(H, B, tiles(Sq, rows)), (int)a->warps * 32, smem,
                      s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, Sq, Sk, H,
      K, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

template <int DH>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, float* dsum, void* dq,
                void* dk, void* dv, const FlashArgs* a, cudaStream_t s) {
  const int B = (int)a->B, Sq = (int)a->Sq, Sk = (int)a->Sk, H = (int)a->H,
            K = (int)a->K, causal = (int)a->causal, window = (int)a->window;
  const float scale = (float)a->scale;
  const size_t smem_kv = (size_t)a->dkdv_smem, smem_q = (size_t)a->dq_smem;
  cudaError_t err;
  if (a->dtype == 0) {
    err = allow_smem(flash_bwd_dkdv_simt<DH>, smem_kv);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_simt<DH><<<dim3(K, B, tiles(Sk, kTile)), kThreads,
                                 smem_kv, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out),
        static_cast<const float*>(dout), lse, static_cast<float*>(dk),
        static_cast<float*>(dv), Sq, Sk, H, K, causal, window, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = allow_smem(flash_bwd_dq_simt<DH>, smem_q);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_simt<DH><<<dim3(H, B, tiles(Sq, kTile)), kThreads,
                               smem_q, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(out),
        static_cast<const float*>(dout), lse, static_cast<float*>(dq), Sq,
        Sk, H, K, causal, window, scale);
    return cudaGetLastError();
  }
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  const long long n_rows = (long long)B * Sq * H;
  flash_bwd_rowdot<DH><<<(unsigned)((n_rows + 31) / 32), 256, 0, s>>>(
      static_cast<const bf16*>(out), dob, dsum, B, Sq, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int MQ = bwd_rows(DH);
  err = allow_smem(flash_bwd_dkdv_mma<DH, MQ>, smem_kv);
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_mma<DH, MQ><<<dim3(K, B, tiles(Sk, kBK)), kBwdWarps * 32,
                               smem_kv, s>>>(
      qb, kb, vb, dob, lse, dsum, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), Sq, Sk, H, K, causal, window, scale,
      scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = allow_smem(flash_bwd_dq_mma<DH>, smem_q);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_mma<DH><<<dim3(H, B, tiles(Sq, kBwdRows)), kBwdWarps * 32,
                         smem_q, s>>>(
      qb, kb, vb, dob, lse, dsum, static_cast<bf16*>(dq), Sq, Sk, H, K,
      causal, window, scale, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = launched).
int flash_attention_fwd_launch(const void* q, const void* k, const void* v,
                               void* out, void* lse, const FlashArgs* a,
                               void* stream) {
  if (!plan_ok(a)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (a->dh) {
    case 16: return (int)fwd<16>(q, k, v, out, l, a, s);
    case 32: return (int)fwd<32>(q, k, v, out, l, a, s);
    case 64: return (int)fwd<64>(q, k, v, out, l, a, s);
    case 112: return (int)fwd<112>(q, k, v, out, l, a, s);
    case 128: return (int)fwd<128>(q, k, v, out, l, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward on `stream`: f32 two launches ((a) dK and dV, (b) dQ);
// bf16 three (D = rowsum(dO * O) into `dsum`, then dK/dV, then dQ).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* out, const void* dout,
                               const void* lse, void* dsum, void* dq,
                               void* dk, void* dv, const FlashArgs* a,
                               void* stream) {
  if (!plan_ok(a) || (a->dtype == 1 && dsum == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(dsum);
  switch (a->dh) {
    case 16: return (int)bwd<16>(q, k, v, out, dout, l, d, dq, dk, dv, a, s);
    case 32: return (int)bwd<32>(q, k, v, out, dout, l, d, dq, dk, dv, a, s);
    case 64: return (int)bwd<64>(q, k, v, out, dout, l, d, dq, dk, dv, a, s);
    case 112: return (int)bwd<112>(q, k, v, out, dout, l, d, dq, dk, dv, a, s);
    case 128: return (int)bwd<128>(q, k, v, out, dout, l, d, dq, dk, dv, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
