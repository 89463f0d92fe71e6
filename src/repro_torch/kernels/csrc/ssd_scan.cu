// SSD (Mamba2 state-space duality) intra-chunk block — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py (ssd_scan_pallas, body
// _kernel).  That kernel recomputes its (Q, Q) score matrix per head block
// and shares it across the heads of the block; this file keeps what it
// computes, not its blocking.
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
// (Bc, Q, H, P) f32.  P in {32, 64}, 1 <= Q <= 256, 1 <= N <= 128.  The
// cross-chunk recurrence stays in the model code (models/ssm.py).
//
// Bound.  At the hybrid prefill shape (Bc = 32 chunks of Q = 128, H = 112,
// P = N = 64, bf16) the function moves about 179 MB (x 59 MB in, y 117 MB
// of f32 out, dt 1.8 MB, B/C 1 MB): 0.0535 ms at 3.35 TB/s, against 3.8
// GFLOP of causal work (0.004 ms at the bf16 tensor-core peak).  It is
// memory-bound: the kernel has to read x once and write y once, at full
// width, with enough bytes in flight.
//
// bfloat16 runs on tensor cores.  What the first (SIMT) version had, and
// what this one does about it:
//   - Scalar f32 FMAs from shared memory for both products: the scores
//     S = C . B^T and the per-head (i, j) x (j, p) product are mma.sync
//     m16n8k16 (bf16 in, f32 accumulate), fed by ldmatrix from shared
//     tiles padded by 8 elements a row (conflict-free); N is padded to a
//     multiple of 16 with zeros.
//   - x read 1.5 times (one block per 64-row tile of i): one CTA per
//     (chunk, head group) over all Q rows, so x of those heads is read
//     once; the grid is one dimension with the head groups of a chunk
//     adjacent, so the chunk's B/C rows stay in L2 while its CTAs run.
//     Each warp owns one 16-row strip of i (Q = 256: 16 warps).
//   - Work above the diagonal: key blocks of 64, each warp stopping at
//     its diagonal: blocks wholly above it are skipped, and so are the
//     16-key steps above it inside the diagonal block.  Per (head, key
//     block) a warp computes its strip's 16 x 64 scores into registers,
//     forms W' = S * exp(acum_i - acum_j) * dt_j in f32 registers, splits
//     it into hi = bf16(W') and lo = bf16(W' - hi), and feeds both as A
//     fragments straight from the accumulator layout; the head's x tile
//     is the B operand, the bf16 it already is (ldmatrix.trans).  Each
//     16-key step adds hi . x, then lo . x, into one f32 accumulator.
//   - The heads of a group run one after another, key blocks inside, and
//     the scores are recomputed per head (a third of the mma work).
//     Keeping them in registers across two heads (key blocks outside,
//     heads inside) needs 64 accumulator and 32 score registers a thread:
//     at the 128-register cap of a 512-thread block that spilled and
//     serialised the exp chains, and measured slower on the card.
//   - Blocks in waves: the group is the divisor of H that fills whole
//     waves of the card's block slots (2 a SM at Q <= 128), so no wave
//     runs mostly empty, and each block loads its chunk's B/C once for
//     all its heads: at the hybrid shape 14 heads, 256 blocks, one wave.
//   - Masks are selects: W' = 0 where j > i or i >= Q, before exp, on the
//     16-key step that holds the diagonal (elsewhere every j < every i, so
//     the exponent is <= 0 and rows past Q hold zero scores), so exp is
//     never evaluated into a product above the diagonal, and rows past Q
//     (zero-filled) cannot turn into inf * 0.
//   - The exp: acum is kept times log2(e), so a weight's exp is one
//     ex2.approx.ftz (subnormal weights, below 1e-38, flush to zero);
//     __expf, which also handles subnormal results, was slower.
//   - Narrow global traffic and nothing in flight: B/C rows, dt and every
//     (head, key block) x tile come by cp.async (16 bytes; 4 for dt; N not
//     a multiple of 8 loads B/C by element) through a 3-stage ring that
//     streams on from one head to the next, so the next tile is in flight
//     while this one is multiplied.  Rows past Q are zero-filled by the
//     copy's source size.  y is written once, in 16-byte streaming stores
//     (a lane pair swaps halves of its two accumulator tiles by one
//     shuffle), each warp right after its last key block of a head, while
//     the others still compute.
//   - A serial cumsum by one thread: one warp per head scans 32 positions
//     at a time by shuffles, in a fixed order, carrying the running sum.
//
// Why the split.  The tolerance is 1e-4 of max|y|.  Fed to the product as
// one bf16 rounding, the weights give 2.6e-3 of max|y| (26x over); with dt
// folded into x and x * dt rounded to bf16, 3.2e-3; with dt folded into
// the weight, the weight as a bf16 hi + lo pair and x as its own exact
// bf16, 4.4e-6 (float64 truth at Bc = 2, Q = 128, H = 112, P = N = 64:
// tests/test_torch_ssd_scan.py emulates the three).
//
// Order of sums.  Every output's sum order depends on (Q, N, P, dtype)
// only: the scores over N in 16-steps, the cumsum by position, the product
// over key blocks, then 16-key steps, hi before lo; never on Bc, H or the
// head group, and no atomics.  Two launches agree bit for bit, and a
// chunk's rows do not depend on what else shares the call.
//
// float32 keeps the SIMT kernel: its checks (1e-4 of max|y| against f32
// plain products, 2e-3 through seven model layers) need f32 operands, which
// bf16 or TF32 tensor-core inputs do not give.  One block per (64-row tile
// of i, group of HB heads, chunk row); 256 threads as 16 x 16; one thread a
// head forms the cumsum serially; the scores and weights are f32 FMAs from
// shared memory, each output one thread's serial sum over j in order.
//
// kernels/ssd_scan.py `plan` picks the route, head group, warps, grid and
// shared memory from (Bc, Q, H, P, N, dtype); the launcher refuses a plan
// that is not this file's.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// ------------------------------------------------------------ f32 (SIMT)
constexpr int kRows = 64;         // positions i per tile, and j per step
constexpr int kThreads = 256;     // 16 x 16: ty = tid / 16, tx = tid % 16
constexpr int kLW = kRows + 1;    // row stride of the (64, 64) weight tile

// Rows row0 .. row0+63 of a (Bc, Q, N) tensor into a (64, N + 1) f32
// tile; rows past Q are zeros.
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int b, int row0, int Q, int N) {
  for (int idx = threadIdx.x; idx < kRows * N; idx += kThreads) {
    const int r = idx / N, n = idx - r * N;
    const int row = row0 + r;
    dst[r * (N + 1) + n] = row < Q ? src[((long long)b * Q + row) * N + n]
                                   : 0.f;
  }
}

template <int P, int HB>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ A, const float* __restrict__ Bm,
                 const float* __restrict__ Cm, float* __restrict__ y, int Q,
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
  load_rows(c_s, Cm, b, i0, Q, N);
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
    load_rows(b_s, Bm, b, j0, Q, N);
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
          v = x[(((long long)b * Q + j) * H + h) * P + p] * dt_s[g * Q + j];
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

size_t simt_smem(int P, int N, int HB, int Q) {
  return sizeof(float) * ((size_t)2 * kRows * (N + 1) + kRows * (P + 1) +
                          kRows * kLW + 2 * (size_t)HB * Q);
}

// ------------------------------------------------- bf16 (tensor cores)
constexpr int kStrip = 16;        // rows i a warp owns
constexpr int kKeys = 64;         // keys j a block step
constexpr int kPad = 8;           // row padding of the bf16 tiles
constexpr int kStages = 3;        // the x ring
constexpr int kMaxWarps = 16;     // Q = 256
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

// dt and acum (f32, G x QB each), B and C (QB x LDN bf16 each), then the
// x ring (kStages x kKeys x (P + kPad) bf16); QB = Q rounded up to kKeys.
size_t mma_smem(int Q, int N, int P, int G) {
  const size_t QB = round_up(Q, kKeys), LDN = round_up(N, 16) + kPad;
  return 2 * G * QB * sizeof(float) + 2 * QB * LDN * sizeof(bf16) +
         (size_t)kStages * kKeys * (P + kPad) * sizeof(bf16);
}

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

// (w0, w1) as the packed bf16 pair hi = bf16(w) and lo = bf16(w - hi); .x
// (the lower k index) in the low half.  w - hi is exact in f32.
__device__ __forceinline__ void split(float w0, float w1, uint32_t& hi,
                                      uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(w0, w1);
  __nv_bfloat162 l = __floats2bfloat162_rn(w0 - __low2float(h),
                                           w1 - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// 2^x on the special-function unit; subnormal results flush to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s (16 rows x kKeys keys, C fragments) = the warp's 16 C rows . kKeys B
// rows, over NP (N padded to 16) in 16-steps; 16-key steps at or past
// kk_end (above the diagonal) are left at zero.
__device__ __forceinline__ void scores(float (&s)[kKeys / 8][4],
                                       const bf16* cs, const bf16* bs,
                                       int LDN, int NP, int kk_end,
                                       int lane) {
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) s[n][v] = 0.f;
  for (int ks = 0; ks < NP; ks += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, cs + (lane & 15) * LDN + ks + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < kKeys / 16; ++np) {
      if (np >= kk_end) continue;
      uint32_t b[4];
      ldmatrix_x4(b, bs + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDN +
                         ks + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * np], a, b[0], b[1]);
      mma_bf16(s[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// acc (16 rows x P) += W' . x_tile for one head, W' = s * 2^(acum_i -
// acum_j) * dt_j with acum in log2 units (zero where j > i or i >= Q), as
// hi then lo per 16-key step.  acum/dtv: the head's (QB,) rows; xt: the
// head's (kKeys, P + kPad) x tile; rows i0.., keys j0...
template <int P>
__device__ __forceinline__ void weighted_product(
    float (&acc)[P / 8][4], const float (&s)[kKeys / 8][4],
    const float* acum, const float* dtv, const bf16* xt, int i0, int j0,
    int Q, int kk_end, int lane) {
  constexpr int LDX = P + kPad;
  const int ia = i0 + (lane >> 2), ib = ia + 8;
  const float acum_a = acum[ia], acum_b = acum[ib];
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk) {
    if (kk >= kk_end) continue;
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int t = 0; t < 2; ++t) {          // key tiles 2kk and 2kk + 1
      const int j = j0 + kk * 16 + t * 8 + 2 * (lane & 3);
      const float2 aj = *reinterpret_cast<const float2*>(acum + j);
      const float2 dj = *reinterpret_cast<const float2*>(dtv + j);
      const float* c = s[2 * kk + t];
      // C fragment: (c0, c1) row ia, keys j, j + 1; (c2, c3) row ib.
      float w0, w1, w2, w3;
      if (kk == kk_end - 1) {         // the step that holds the diagonal
        w0 = (j <= ia && ia < Q) ? c[0] * exp2_ftz(acum_a - aj.x) * dj.x
                                 : 0.f;
        w1 = (j + 1 <= ia && ia < Q)
                 ? c[1] * exp2_ftz(acum_a - aj.y) * dj.y : 0.f;
        w2 = (j <= ib && ib < Q) ? c[2] * exp2_ftz(acum_b - aj.x) * dj.x
                                 : 0.f;
        w3 = (j + 1 <= ib && ib < Q)
                 ? c[3] * exp2_ftz(acum_b - aj.y) * dj.y : 0.f;
      } else {                        // every j < every i: no mask
        w0 = c[0] * exp2_ftz(acum_a - aj.x) * dj.x;
        w1 = c[1] * exp2_ftz(acum_a - aj.y) * dj.y;
        w2 = c[2] * exp2_ftz(acum_b - aj.x) * dj.x;
        w3 = c[3] * exp2_ftz(acum_b - aj.y) * dj.y;
      }
      // A fragment: a0 row ia / a1 row ib of the first 8 keys, a2 / a3 of
      // the next 8.
      split(w0, w1, hi[2 * t], lo[2 * t]);
      split(w2, w3, hi[2 * t + 1], lo[2 * t + 1]);
    }
#pragma unroll
    for (int dp = 0; dp < P / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, xt + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                 (lane & 7)) * LDX +
                               dp * 16 + (lane >> 4) * 8);
      mma_bf16(acc[2 * dp], hi, b[0], b[1]);
      mma_bf16(acc[2 * dp], lo, b[0], b[1]);
      mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
      mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
    }
  }
}

// One CTA per (chunk b, group of G heads): blockIdx.x = b * (H / G) +
// group.  One warp per 16-row strip of i (blockDim.x = 32 * ceil(Q / 16)).
// The heads of the group run one after another, the x ring streaming on
// from one head to the next.
template <int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
ssd_chunk_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, float* __restrict__ y, int Q,
              int H, int N, int G) {
  constexpr int LDX = P + kPad, XS = kKeys * LDX;
  const int groups = H / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x - b * groups) * G;
  const int QB = round_up(Q, kKeys), NP = round_up(N, 16), LDN = NP + kPad;
  const int nt = blockDim.x, warps = nt >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_jb = QB / kKeys, steps = n_jb * G;
  const long long row0 = (long long)b * Q;   // this chunk's first row

  extern __shared__ __align__(16) unsigned char smem_b[];
  float* dt_s = reinterpret_cast<float*>(smem_b);           // (G, QB)
  float* acum_s = dt_s + G * QB;                             // (G, QB)
  bf16* b_s = reinterpret_cast<bf16*>(acum_s + G * QB);      // (QB, LDN)
  bf16* c_s = b_s + QB * LDN;                                // (QB, LDN)
  bf16* x_s = c_s + QB * LDN;                   // kStages x (kKeys, LDX)

  // dt of the group's heads, B and C rows: zeros past Q and past N.
  for (int idx = threadIdx.x; idx < G * QB; idx += nt) {
    const int g = idx / QB, j = idx - g * QB;
    const bool ok = j < Q;
    cp_async4(dt_s + idx, ok ? dt + (row0 + j) * H + h0 + g : dt,
              ok ? 4 : 0);
  }
  if ((N & 7) == 0) {                 // rows of 16-byte chunks
    const int CH = NP / 8;
    for (int idx = threadIdx.x; idx < QB * CH; idx += nt) {
      const int r = idx / CH, c = (idx - r * CH) * 8;
      const bool ok = r < Q && c < N;
      const long long at = (row0 + r) * N + c;
      cp_async16(b_s + r * LDN + c, ok ? Bm + at : Bm, ok ? 16 : 0);
      cp_async16(c_s + r * LDN + c, ok ? Cm + at : Cm, ok ? 16 : 0);
    }
  } else {                            // rows not 16-byte aligned
    for (int idx = threadIdx.x; idx < QB * NP; idx += nt) {
      const int r = idx / NP, c = idx - r * NP;
      const bool ok = r < Q && c < N;
      const long long at = (row0 + r) * N + c;
      b_s[r * LDN + c] = ok ? Bm[at] : __float2bfloat16(0.f);
      c_s[r * LDN + c] = ok ? Cm[at] : __float2bfloat16(0.f);
    }
  }

  // Step t = (head t / n_jb, key block t % n_jb) goes to stage t % kStages.
  auto fetch = [&](int t) {
    if (t >= steps) return;
    const int g = t / n_jb, jb = t - g * n_jb;
    bf16* dst = x_s + (t % kStages) * XS;
    constexpr int CH = P / 8;
    for (int idx = threadIdx.x; idx < kKeys * CH; idx += nt) {
      const int r = idx / CH, c = (idx - r * CH) * 8;
      const int j = jb * kKeys + r;
      const bool ok = j < Q;
      cp_async16(dst + r * LDX + c,
                 ok ? x + ((row0 + j) * H + h0 + g) * P + c : x, ok ? 16 : 0);
    }
  };
  fetch(0);
  cp_async_commit();                  // group 0: dt, B, C and step 0
#pragma unroll
  for (int t = 1; t < kStages - 1; ++t) {
    fetch(t);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  __syncthreads();

  // acum = inclusive cumsum of a = dt * A (rounded, then added), one warp
  // a head, 32 positions at a time, kept times log2(e) so that a weight's
  // exp is one ex2; dt is zero past Q.
  for (int g = warp; g < G; g += warps) {
    const float a_h = A[h0 + g];
    float carry = 0.f;
    for (int c0 = 0; c0 < QB; c0 += 32) {
      float v = __fmul_rn(dt_s[g * QB + c0 + lane], a_h);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, v, o);
        if (lane >= o) v = __fadd_rn(up, v);
      }
      v = __fadd_rn(carry, v);
      acum_s[g * QB + c0 + lane] = __fmul_rn(v, kLog2e);
      carry = __shfl_sync(0xffffffffu, v, 31);
    }
  }

  const int i0 = warp * kStrip;               // this warp's strip
  const int last_jb = i0 / kKeys;             // the block of its diagonal
  const bool odd = lane & 1;
  float acc[P / 8][4];
  float s[kKeys / 8][4];
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int n = 0; n < P / 8; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[n][v] = 0.f;
    for (int jb = 0; jb < n_jb; ++jb) {
      const int t = g * n_jb + jb;
      cp_async_wait<kStages - 2>();
      __syncthreads();                // step t landed; step t - 1 consumed
      fetch(t + kStages - 1);
      cp_async_commit();
      if (jb > last_jb) continue;     // above this strip's diagonal
      const int j0 = jb * kKeys;
      const int kk_end = min(kKeys / 16, (i0 - j0) / 16 + 1);
      scores(s, c_s + i0 * LDN, b_s + j0 * LDN, LDN, NP, kk_end, lane);
      weighted_product<P>(acc, s, acum_s + g * QB, dt_s + g * QB,
                          x_s + (t % kStages) * XS, i0, j0, Q, kk_end, lane);
      if (jb != last_jb) continue;
      // The strip is done for this head: rows i < Q, 16 bytes a lane.  A
      // lane pair swaps its halves of column tiles 2tp and 2tp + 1, so the
      // even lane holds 4 adjacent columns of the first, the odd lane of
      // the second.
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = i0 + (lane >> 2) + half * 8;
        float* row = y + ((row0 + i) * H + h0 + g) * P;
#pragma unroll
        for (int tp = 0; tp < P / 16; ++tp) {
          const float e0 = acc[2 * tp][2 * half];
          const float e1 = acc[2 * tp][2 * half + 1];
          const float o0 = acc[2 * tp + 1][2 * half];
          const float o1 = acc[2 * tp + 1][2 * half + 1];
          const float r0 = __shfl_xor_sync(0xffffffffu, odd ? e0 : o0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, odd ? e1 : o1, 1);
          const float4 v = odd ? make_float4(r0, r1, o0, o1)
                               : make_float4(e0, e1, r0, r1);
          const int col = (2 * tp + odd) * 8 + 2 * (lane & 2);
          if (i < Q) __stcs(reinterpret_cast<float4*>(row + col), v);
        }
      }
    }
  }
  cp_async_wait<0>();
}

// Lets `kernel` take `smem` bytes of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int P, int HB>
cudaError_t launch_simt(const void* x, const float* dt, const float* A,
                        const void* Bm, const void* Cm, float* y, int Bc,
                        int Q, int H, int N, size_t smem, cudaStream_t s) {
  cudaError_t err = allow_smem(ssd_chunk_kernel<P, HB>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Q + kRows - 1) / kRows, H / HB, Bc);
  ssd_chunk_kernel<P, HB><<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), y, Q, H, N);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_mma(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, float* y, int Bc,
                       int Q, int H, int N, int G, int warps, size_t smem,
                       cudaStream_t s) {
  cudaError_t err = allow_smem(ssd_chunk_mma<P>, smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_mma<P><<<Bc * (H / G), warps * 32, smem, s>>>(
      static_cast<const bf16*>(x), dt, A, static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), y, Q, H, N, G);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shapes and the plan of one call, every field 8 bytes wide
// (kernels/ssd_scan.py `_Args` mirrors it).  dtype 0 = float32, 1 =
// bfloat16; route 0 = SIMT, 1 = tensor cores; head_group heads a block;
// warps a block; key_block keys a step; stages of the x ring; smem the
// dynamic shared memory; blocks the number of blocks in the grid.
struct SsdArgs {
  long long Bc, Q, H, P, N, dtype, route, head_group, warps, key_block,
      stages, smem, blocks;
};

// x (Bc,Q,H,P) and Bm/Cm (Bc,Q,N) in the dtype, 16-byte aligned in bf16;
// dt (Bc,Q,H) and A (H,) float32; y (Bc,Q,H,P) float32; all contiguous.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a plan that is not this file's.
int ssd_scan_launch(const void* x, const void* dt, const void* A,
                    const void* Bm, const void* Cm, void* y,
                    const SsdArgs* a, void* stream) {
  const int Bc = (int)a->Bc, Q = (int)a->Q, H = (int)a->H, P = (int)a->P,
            N = (int)a->N, HG = (int)a->head_group;
  if (Bc <= 0 || Q <= 0 || Q > 256 || H <= 0 || N <= 0 || N > 128 ||
      HG <= 0 || H % HG || (P != 32 && P != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* av = static_cast<const float*>(A);
  float* out = static_cast<float*>(y);
  if (a->dtype == 0) {
    const size_t smem = simt_smem(P, N, HG, Q);
    if (a->route != 0 || a->warps != kThreads / 32 ||
        a->key_block != kRows || a->stages != 1 || (size_t)a->smem != smem ||
        a->blocks != (long long)((Q + kRows - 1) / kRows) * (H / HG) * Bc)
      return (int)cudaErrorInvalidValue;
#define SIMT_CASE(PP, HH)                                                   \
  if (P == PP && HG == HH)                                                  \
    return (int)launch_simt<PP, HH>(x, d, av, Bm, Cm, out, Bc, Q, H, N,     \
                                    smem, s);
    SIMT_CASE(32, 1) SIMT_CASE(32, 2) SIMT_CASE(32, 4)
    SIMT_CASE(64, 1) SIMT_CASE(64, 2) SIMT_CASE(64, 4)
#undef SIMT_CASE
    return (int)cudaErrorInvalidValue;
  }
  const int warps = (Q + kStrip - 1) / kStrip;
  const size_t smem = mma_smem(Q, N, P, HG);
  if (a->dtype != 1 || a->route != 1 || a->warps != warps ||
      a->key_block != kKeys || a->stages != kStages ||
      (size_t)a->smem != smem || a->blocks != (long long)Bc * (H / HG))
    return (int)cudaErrorInvalidValue;
  if (P == 32)
    return (int)launch_mma<32>(x, d, av, Bm, Cm, out, Bc, Q, H, N, HG, warps,
                               smem, s);
  return (int)launch_mma<64>(x, d, av, Bm, Cm, out, Bc, Q, H, N, HG, warps,
                             smem, s);
}

}  // extern "C"
