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
//
// Backward (ssd_scan_bwd_launch).  The JAX package has no kernel here: it
// takes this gradient by autograd through its jnp ssd_chunked
// (repro/models/ssm.py:84); ssd_scan_pallas has no VJP.  For each chunk
// row and head h, with c = cumsum(dt A_h), S = C B^T (shared by the
// heads), L[i,j] = exp(c_i - c_j) for j <= i, W = S * L, xdt = dt x:
//
//   dxdt = W^T dY, dx = dt dxdt, dW = dY xdt^T (j <= i), G = dW * W,
//   dc = rowsum(G) - colsum(G), da = reverse cumsum(dc),
//   ddt = x . dxdt + A_h da, dA_h = sum over rows and j of da dt,
//   dS = sum_h dW * L, dC = dS B, dB = dS^T C.
//
// Bound.  At hybrid training's call (Bc = 32, Q = 128, H = 112, P = N =
// 64, bf16) it reads x (59 MB), the f32 dY (117 MB), dt, B, C and writes
// dx (59 MB), ddt, dB, dC: about 241 MB, 0.072 ms at 3.35 TB/s, against
// about 7.9 GFLOP of causal work (0.008 ms at the bf16 tensor-core peak;
// with the hi/lo feeds below about 2.5 times that).  It is memory-bound,
// like the forward.
//
// Backward, bfloat16: tensor cores (mma.sync m16n8k16, bf16 in, f32
// accumulate) for every product, two launches, no atomics.  What the first
// (SIMT) version had, and what this one does about it:
//   - Scalar f32 FMAs from shared memory for every product: S^T = B C^T,
//     dW'^T = x dY^T, dxdt = W^T dY, and launch 2's dC and dB are mma.sync
//     fed by ldmatrix.  x, B and C go in as the exact bf16 they are; the
//     f32 operands as a pair hi = bf16(v), lo = bf16(v - hi): dY (split
//     once per head as it lands), W (from the accumulators, as the forward
//     feeds its weights) and dS in launch 2.  dt factors out of dW:
//     dW[i,j] = dt_j (dY_i . x_j), so x needs no rounding with dt folded
//     in.  The products: x.hi + x.lo for dW', hi.hi + hi.lo + lo.hi for
//     W^T dY, hi + lo against B and C.  ddt and dA (held to 1e-4 of their
//     max) come out within about 5e-6 of it; one rounding of dY and W
//     misses 1e-4 (tests/test_torch_ssd_scan.py emulates both).
//   - Warps on 16-row strips of keys j: strip s meets the 16-row subtiles
//     u >= s of rows i, cut in runs of at most `chunk` subtiles, one warp
//     a run (Q = 128: 36 pairs, runs of 3, 15 warps).  A warp keeps its
//     strip's dxdt and colsum(G) in registers over its run and its x rows
//     as A fragments; the runs of a strip add their dxdt in run order
//     through shared-memory slots (a per-strip named barrier), and the
//     first run's warp writes dx, x . dxdt and dc.  rowsum(G) per i is
//     summed over the strip's 16 rows by shuffles in a fixed tree, then
//     over the strips in order.
//   - S^T and the group's dS^T live in shared memory as lower triangles of
//     16-row strips (rows padded by 8 floats: conflict-free 8-byte
//     accesses) up to Q = 128, else in a device scratch; S^T is formed once
//     a block, dS^T is added to head by head in head order.
//   - One block per (chunk row, group of G heads): 228 KB of shared memory
//     at the training call, so one block an SM (two need half of it, and
//     the triangles alone take 82 KB); G is the largest divisor of H up to
//     14 that fits, from (Q, H, P, N) alone: 256 blocks, 1.94 waves (16
//     heads would make 224, 1.7 waves).
//   - Bytes in flight: the next head's x and dY come by cp.async (16-byte
//     pieces, zero-filled past Q) while this head is multiplied, issued by
//     the warps whose runs are short; dt of the group's heads and their
//     cumsums (a warp a head, by shuffles) once at the start.
//   - dx is staged through shared memory and stored in 16-byte row pieces;
//     ddt's A da and the reverse cumsum of dc (32-row suffix scans by
//     shuffles, from the end) at the block's end.
//   - Launch 2, grid (Bc + 1, 2 ceil(QS / 64)), 8 warps: block (b, t) forms
//     dC of 64 rows i or dB of 64 keys j, each 64 x 64 dS tile the groups'
//     partials summed in ascending order (8 loads in flight a thread);
//     block (Bc, 0) sums dA over the chunk rows in order.
//   - Order of sums: every chunk row's dx, ddt, dB and dC depend on (Q, H,
//     P, N) only (G and chunk are chosen from them), never on Bc; only dA
//     sums across rows.  Two launches agree bit for bit.
//
// Backward, float32: the SIMT kernels, every sum in f32 (its 1e-4 checks
// need f32 operands, as the forward's f32 route does).  Launch 1, one
// block per (chunk row, group of up to 16 heads), 256 threads as 16 x 16
// over 64 x 64 tiles: key tiles outside, the scores of the key tile's
// column strip once for the group's heads, row tiles innermost; G's row
// sums by half-warp shuffles, column sums through shared memory, the
// group's dS strip in shared memory over the heads, then to a scratch of
// per-group partials.  Launch 2, grid (Bc + 1, 2 ceil(Q / 64)): dC of row
// tile t or dB of key tile t from the partials summed in group order; dA.
//
// kernels/ssd_scan.py `plan_bwd` picks the route, head group, runs, warps,
// shared memory and grids; the launcher refuses any other plan, and a plan
// whose route is not its dtype's.

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

// Waits at named barrier `id` (1 .. 15) for `count` threads, a multiple of
// 32, every warp of which calls it.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
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


// ------------------------------------------------------------ backward
// The gradient of the block, float32 (see "Backward, float32" in the note
// at the top): SIMT kernels, every sum in f32.

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }

// Rows row0 .. row0+63 of a (Bc, Q, N) tensor into a (64, ld) f32 tile:
// columns 0 .. NP-1, zeros past Q and past N.
template <typename T>
__device__ __forceinline__ void load_rows_f(float* dst, const T* src,
                                            long long base, int row0, int Q,
                                            int N, int NP, int ld) {
  for (int idx = threadIdx.x; idx < kRows * NP; idx += kThreads) {
    const int r = idx / NP, n = idx - r * NP;
    const int row = row0 + r;
    dst[r * ld + n] =
        (row < Q && n < N) ? load_f(src + (base + row) * N + n) : 0.f;
  }
}

// The sum of v over the 16 lanes of a half-warp (one ty), in a fixed
// order; every lane of the half gets it.
__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared memory of launch 1, in floats: the key tile's scores and dS
// strips (QT, 65) each, c, dt, row and column sums of G (G, QT) each, then
// the x, dt*x and dY tiles (64, P + 1), the W tile (64, 65) and the column
// partials (16, 64); the B/C staging (2 x (64, NP + 1)) aliases the tiles.
size_t bwd_smem_floats(int Q, int N, int P, int G) {
  const size_t QT = round_up(Q, kRows), NP = round_up(N, 16);
  const size_t tiles = 3 * kRows * (P + 1) + kRows * kLW + 16 * kRows;
  const size_t stage = 2 * kRows * (NP + 1);
  return 2 * QT * kLW + 4 * (size_t)G * QT + (tiles > stage ? tiles : stage);
}

// Launch 2: the (64, 65) dS tile and a (64, NP + 1) B or C row tile.
size_t bwd_reduce_smem_floats(int N) {
  return (size_t)kRows * kLW + (size_t)kRows * (round_up(N, 16) + 1);
}

// Launch 1: one block per (chunk row b, group of G heads), blockIdx.x =
// b * (H / G) + group.  Key tiles J outside, the group's heads inside, row
// tiles I >= J innermost: per head the key tile's dxdt sums in registers
// over the row tiles, and the group's dS strip of the key tile in shared
// memory over the heads; the strip goes to ds_part (b, group, QT, QT).  At
// the end each head's da (reverse cumsum of dc), ddt += A da, and its
// sum_j da_j dt_j into da_part (b, h).
template <int P, typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_chunk(const T* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const T* __restrict__ Bm,
              const T* __restrict__ Cm, const float* __restrict__ dy,
              T* __restrict__ dx, float* __restrict__ ddt,
              float* __restrict__ ds_part, float* __restrict__ da_part,
              int Q, int H, int N, int G) {
  constexpr int NC = P / 16, LP = P + 1;
  const int groups = H / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x - b * groups) * G;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nT = (Q + kRows - 1) / kRows, QT = nT * kRows;
  const int LN = N + 1;
  const long long row0 = (long long)b * Q;

  extern __shared__ float smem[];
  float* s_strip = smem;                  // (QT, kLW) C_i . B_j, key tile
  float* ds_strip = s_strip + QT * kLW;   // (QT, kLW) the group's dS
  float* c_s = ds_strip + QT * kLW;       // (G, QT) cumsum of dt * A
  float* dt_s = c_s + G * QT;             // (G, QT)
  float* r_s = dt_s + G * QT;             // (G, QT) row sums of G, then da
  float* k_s = r_s + G * QT;              // (G, QT) column sums of G
  float* x_s = k_s + G * QT;              // (64, LP) x of the key tile
  float* xdt_s = x_s + kRows * LP;        // (64, LP) dt_j x_j
  float* dy_s = xdt_s + kRows * LP;       // (64, LP) dY of the row tile
  float* w_s = dy_s + kRows * LP;         // (64, kLW) W of the tile
  float* colp_s = w_s + kRows * kLW;      // (16, 64) column partials
  float* crow_s = x_s;                    // staging: C rows (64, N + 1)
  float* brow_s = crow_s + kRows * LN;    //          B rows (64, N + 1)

  for (int idx = threadIdx.x; idx < G * QT; idx += kThreads) {
    const int g = idx / QT, j = idx - g * QT;
    dt_s[idx] = j < Q ? dt[(row0 + j) * H + h0 + g] : 0.f;
    r_s[idx] = 0.f;
    k_s[idx] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x < G) {        // the forward's cumsum: rounded, then added
    const int g = threadIdx.x;
    const float a_h = A[h0 + g];
    float run = 0.f;
    for (int j = 0; j < QT; ++j) {
      run = __fadd_rn(run, __fmul_rn(dt_s[g * QT + j], a_h));
      c_s[g * QT + j] = run;
    }
  }

  for (int J = 0; J < nT; ++J) {
    const int j0 = J * kRows;
    for (int I = J; I < nT; ++I) {      // scores of rows i >= j0
      const int i0 = I * kRows;
      __syncthreads();
      load_rows_f(crow_s, Cm, row0, i0, Q, N, N, LN);
      load_rows_f(brow_s, Bm, row0, j0, Q, N, N, LN);
      __syncthreads();
      float s[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[a][c] = 0.f;
#pragma unroll 4
      for (int n = 0; n < N; ++n) {
        float av[4], bv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) av[a] = crow_s[(ty + 16 * a) * LN + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = brow_s[(tx + 16 * c) * LN + n];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[a][c] = fmaf(av[a], bv[c], s[a][c]);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s_strip[(i0 + ty + 16 * a) * kLW + tx + 16 * c] = s[a][c];
    }
    for (int idx = threadIdx.x; idx < (QT - j0) * kLW; idx += kThreads)
      ds_strip[j0 * kLW + idx] = 0.f;

    for (int g = 0; g < G; ++g) {
      const int h = h0 + g;
      const float* cg = c_s + g * QT;
      const float* dtg = dt_s + g * QT;
      __syncthreads();      // staging and the last head's tiles consumed
      for (int idx = threadIdx.x; idx < kRows * P; idx += kThreads) {
        const int r = idx / P, p = idx - r * P;
        const int j = j0 + r;
        const float v =
            j < Q ? load_f(x + ((row0 + j) * H + h) * P + p) : 0.f;
        x_s[r * LP + p] = v;
        xdt_s[r * LP + p] = v * dtg[j];
      }
      // acc[a][c] = dxdt[j0 + ty + 16a][tx + 16c], over the row tiles.
      float acc[4][NC];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;
      for (int I = J; I < nT; ++I) {
        const int i0 = I * kRows;
        for (int idx = threadIdx.x; idx < kRows * P; idx += kThreads) {
          const int r = idx / P, p = idx - r * P;
          const int i = i0 + r;
          dy_s[r * LP + p] = i < Q ? dy[((row0 + i) * H + h) * P + p] : 0.f;
        }
        __syncthreads();
        // dW[i][j] = dY_i . xdt_j for i = i0 + ty + 16a, j = j0 + tx + 16c.
        float dw[4][4];
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) dw[a][c] = 0.f;
#pragma unroll 4
        for (int p = 0; p < P; ++p) {
          float av[4], bv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) av[a] = dy_s[(ty + 16 * a) * LP + p];
#pragma unroll
          for (int c = 0; c < 4; ++c) bv[c] = xdt_s[(tx + 16 * c) * LP + p];
#pragma unroll
          for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              dw[a][c] = fmaf(av[a], bv[c], dw[a][c]);
        }
        // W = S * L, G = dW * W; L is evaluated only where j <= i < Q.
        float rowp[4] = {0.f, 0.f, 0.f, 0.f}, colp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + ty + 16 * a;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int jl = tx + 16 * c, j = j0 + jl;
            const bool ok = j <= i && i < Q;
            const float L = ok ? expf(cg[i] - cg[j]) : 0.f;
            const float w = s_strip[i * kLW + jl] * L;
            w_s[(ty + 16 * a) * kLW + jl] = w;
            const float gw = dw[a][c] * w;
            rowp[a] += gw;
            colp[c] += gw;
            ds_strip[i * kLW + jl] += dw[a][c] * L;
          }
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float v = half_warp_sum(rowp[a]);
          if (tx == 0) r_s[g * QT + i0 + ty + 16 * a] += v;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) colp_s[ty * kRows + tx + 16 * c] = colp[c];
        __syncthreads();
        // dxdt[j][p] += sum_i W[i][j] dY[i][p], i in order.
#pragma unroll 4
        for (int r = 0; r < kRows; ++r) {
          float wv[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) wv[a] = w_s[r * kLW + ty + 16 * a];
#pragma unroll
          for (int c = 0; c < NC; ++c) {
            const float d = dy_s[r * LP + tx + 16 * c];
#pragma unroll
            for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(wv[a], d, acc[a][c]);
          }
        }
        if (threadIdx.x < kRows) {
          float v = 0.f;
          for (int t = 0; t < 16; ++t) v += colp_s[t * kRows + threadIdx.x];
          k_s[g * QT + j0 + threadIdx.x] += v;
        }
        __syncthreads();          // dy_s, w_s, colp_s free
      }
      // dx = dt dxdt; ddt's first term x . dxdt (A da is added at the end).
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int jl = ty + 16 * a, j = j0 + jl;
        float xd = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int p = tx + 16 * c;
          xd = fmaf(x_s[jl * LP + p], acc[a][c], xd);
          if (j < Q)
            store_f(dx + ((row0 + j) * H + h) * P + p, dtg[j] * acc[a][c]);
        }
        xd = half_warp_sum(xd);
        if (tx == 0 && j < Q) ddt[(row0 + j) * H + h] = xd;
      }
    }
    __syncthreads();
    float* part = ds_part + (long long)blockIdx.x * QT * QT;
    for (int idx = threadIdx.x; idx < (QT - j0) * kRows; idx += kThreads) {
      const int r = idx / kRows, s = idx - r * kRows;
      part[(long long)(j0 + r) * QT + j0 + s] = ds_strip[(j0 + r) * kLW + s];
    }
  }
  __syncthreads();
  if (threadIdx.x < G) {            // da = reverse cumsum of dc = r - k
    const int g = threadIdx.x;
    float run = 0.f;
    for (int j = Q - 1; j >= 0; --j) {
      run += r_s[g * QT + j] - k_s[g * QT + j];
      r_s[g * QT + j] = run;
    }
    float sum = 0.f;
    for (int j = 0; j < Q; ++j) sum = fmaf(r_s[g * QT + j], dt_s[g * QT + j],
                                           sum);
    da_part[(long long)b * H + h0 + g] = sum;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Q * G; idx += kThreads) {
    const int j = idx / G, g = idx - j * G;
    float* o = ddt + (row0 + j) * H + h0 + g;
    *o = fmaf(A[h0 + g], r_s[g * QT + j], *o);
  }
}

// Launch 2: grid (Bc + 1, 2 nT).  Block (b, t < nT) forms dC of row tile
// t, block (b, nT + t) dB of key tile t, each dS tile the sum of the
// groups' partials in ascending order (the two sum each tile alike); block
// (Bc, 0) sums dA over the chunk rows in ascending order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce(const T* __restrict__ Bm, const T* __restrict__ Cm,
               const float* __restrict__ ds_part,
               const float* __restrict__ da_part, T* __restrict__ dB,
               T* __restrict__ dC, float* __restrict__ dA, int Bc, int Q,
               int H, int N, int groups) {
  const int nT = (Q + kRows - 1) / kRows, QT = nT * kRows;
  if (blockIdx.x == Bc) {
    if (blockIdx.y != 0) return;
    for (int h = threadIdx.x; h < H; h += kThreads) {
      float s = 0.f;
      for (int b = 0; b < Bc; ++b) s += da_part[(long long)b * H + h];
      dA[h] = s;
    }
    return;
  }
  const int b = blockIdx.x;
  const bool rows = (int)blockIdx.y < nT;
  const int t = rows ? blockIdx.y : blockIdx.y - nT;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int NP = round_up(N, 16), LN = NP + 1, NCN = NP / 16;
  const long long row0 = (long long)b * Q, gstride = (long long)QT * QT;
  const float* part = ds_part + (long long)b * groups * gstride;

  extern __shared__ float smem[];
  float* ds_s = smem;                   // (64, kLW) dS tile
  float* v_s = ds_s + kRows * kLW;      // (64, LN) B or C rows

  float acc[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
  const int u0 = rows ? 0 : t, u1 = rows ? t : nT - 1;
  for (int u = u0; u <= u1; ++u) {
    const int I = rows ? t : u, J = rows ? u : t;
    __syncthreads();
    for (int idx = threadIdx.x; idx < kRows * kRows; idx += kThreads) {
      const int r = idx / kRows, s = idx - r * kRows;
      const float* src = part + (long long)(I * kRows + r) * QT + J * kRows + s;
      float v = 0.f;
      for (int gi = 0; gi < groups; ++gi) v += src[gi * gstride];
      ds_s[r * kLW + s] = v;
    }
    load_rows_f(v_s, rows ? Bm : Cm, row0, (rows ? J : I) * kRows, Q, N, NP,
                LN);
    __syncthreads();
    if (rows) {             // dC[i][n] += sum_j dS[i][j] B[j][n]
#pragma unroll 4
      for (int s = 0; s < kRows; ++s) {
        float dv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = ds_s[(ty + 16 * a) * kLW + s];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c >= NCN) break;
          const float v = v_s[s * LN + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(dv[a], v, acc[a][c]);
        }
      }
    } else {                // dB[j][n] += sum_i dS[i][j] C[i][n]
#pragma unroll 4
      for (int r = 0; r < kRows; ++r) {
        float dv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) dv[a] = ds_s[r * kLW + ty + 16 * a];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c >= NCN) break;
          const float v = v_s[r * LN + tx + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(dv[a], v, acc[a][c]);
        }
      }
    }
  }
  T* out = rows ? dC : dB;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int row = t * kRows + ty + 16 * a;
    if (row >= Q) continue;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = tx + 16 * c;
      if (c < NCN && n < N) store_f(out + (row0 + row) * N + n, acc[a][c]);
    }
  }
}

template <int P, typename T>
cudaError_t launch_bwd(const void* x, const float* dt, const float* A,
                       const void* Bm, const void* Cm, const float* dy,
                       void* dx, float* ddt, float* dA, void* dB, void* dC,
                       float* ds_part, float* da_part, int Bc, int Q, int H,
                       int N, int G, size_t smem, size_t reduce_smem,
                       cudaStream_t s) {
  cudaError_t err = allow_smem(ssd_bwd_chunk<P, T>, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_bwd_reduce<T>, reduce_smem);
  if (err != cudaSuccess) return err;
  const T* bm = static_cast<const T*>(Bm);
  const T* cm = static_cast<const T*>(Cm);
  ssd_bwd_chunk<P, T><<<Bc * (H / G), kThreads, smem, s>>>(
      static_cast<const T*>(x), dt, A, bm, cm, dy, static_cast<T*>(dx), ddt,
      ds_part, da_part, Q, H, N, G);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nT = (Q + kRows - 1) / kRows;
  ssd_bwd_reduce<T><<<dim3(Bc + 1, 2 * nT), kThreads, reduce_smem, s>>>(
      bm, cm, ds_part, da_part, static_cast<T*>(dB), static_cast<T*>(dC), dA,
      Bc, Q, H, N, H / G);
  return cudaGetLastError();
}

// ------------------------------------- backward, bf16 (tensor cores)
// See "Backward, bfloat16" in the note at the top.  Positions are cut in
// 16-row strips: a strip s of keys j (rows 16s .. 16s+15) meets the
// subtiles u >= s of rows i; every (strip, subtile) pair is one warp's.
constexpr int kBwdMaxWarps = 16;
constexpr int kBwdMaxGroup = 14;
constexpr int kTriSmemRows = 128;    // triangles in shared memory up to here
constexpr int kRedRows = 64;         // launch 2: rows a block, keys a step

// Warps of launch 1: strip s has nS - s subtiles, cut in runs of `chunk`,
// one warp a run.
__host__ __device__ inline int bwd_warps(int nS, int chunk) {
  int w = 0;
  for (int s = 0; s < nS; ++s) w += (nS - s + chunk - 1) / chunk;
  return w;
}

// The least run length, from ceil(subtiles / 16) up, whose warps fit 16.
inline int bwd_chunk(int nS) {
  int c = (nS * (nS + 1) / 2 + kBwdMaxWarps - 1) / kBwdMaxWarps;
  if (c < 1) c = 1;
  while (bwd_warps(nS, c) > kBwdMaxWarps) ++c;
  return c;
}

// A (QS, QS) lower triangle in strips: strip s holds rows j = 16s .. 16s +
// 15 and columns i = 16s .. QS - 1, row stride QS - 16s + 8 floats (8 more
// than the row: conflict-free 8-byte accesses by a warp).
__host__ __device__ inline int tri_ld(int QS, int s) { return QS - 16 * s + 8; }
__host__ __device__ inline int tri_base(int QS, int s) {
  return 16 * (s * (QS + 8) - 8 * s * (s - 1));
}
__host__ __device__ inline int tri_at(int QS, int j, int i) {
  const int s = j >> 4;
  return tri_base(QS, s) + (j & 15) * tri_ld(QS, s) + i - 16 * s;
}
__host__ __device__ inline int tri_floats(int QS) {
  return tri_base(QS, QS / 16);
}

// Launch 1's shared memory, byte offsets (kernels/ssd_scan.py `_bwd_mma_smem`
// mirrors the total): the S^T and dS^T triangles (f32, when they live
// there), the head's x tile (bf16, (QS, P + 8)), then one region that holds
// first the B and C rows (bf16, (QS, NP + 8) each) and then the head's dY
// (f32 (QS, P) as it lands, and its bf16 hi and lo (QS, P + 8) each), the
// dxdt partials' slots, the row sums of G by strip (nS, QS), and dt, dc
// and the cumsum of the group's heads (G, QS) each.
struct BwdLayout {
  int st, ds, x, ybuf, yhi, ylo, xch, rp, dt, dc, c2, total;
};

__host__ __device__ inline BwdLayout bwd_layout(int Q, int N, int P, int G,
                                                int slots, int tri_smem) {
  const int QS = round_up(Q, 16), NP = round_up(N, 16), LDX = P + kPad;
  const int tri = tri_smem ? 4 * tri_floats(QS) : 0;
  const int yst = QS * P * 4, yhl = 2 * QS * LDX * 2;
  const int bc = 2 * QS * (NP + kPad) * 2;
  BwdLayout L;
  int o = 0;
  L.st = o; o += tri;
  L.ds = o; o += tri;
  L.x = o; o += QS * LDX * 2;
  L.ybuf = o; L.yhi = o + yst; L.ylo = L.yhi + QS * LDX * 2;
  o += yst + yhl > bc ? yst + yhl : bc;
  L.xch = o; o += slots * (16 * LDX + 16) * 4;
  L.rp = o; o += (QS / 16) * QS * 4;
  L.dt = o; o += G * QS * 4;
  L.dc = o; o += G * QS * 4;
  L.c2 = o; o += G * QS * 4;
  L.total = o;
  return L;
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}
__device__ __forceinline__ uint32_t pack_bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Launch 1: one block per (chunk row b, group of G heads), blockIdx.x = b *
// (H / G) + group; bwd_warps(nS, chunk) warps, warp (s, q) owning the
// subtiles u0 .. u1 - 1 of strip s.  S^T for the block's pairs first, then
// the heads one after another: per head dW^T, W^T, G, dS^T and dxdt for the
// warp's pairs; at the head's end the runs of a strip add their dxdt in run
// order and the first run's warp writes dx, x . dxdt and dc.  At the end
// each head's da, ddt and sum_j da dt.  st_part/ds_part: the triangles of
// this block (ds_part is launch 2's input in both cases).
template <int P, bool kTri>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, 1)
ssd_bwd_mma(const bf16* __restrict__ x, const float* __restrict__ dt,
            const float* __restrict__ A, const bf16* __restrict__ Bm,
            const bf16* __restrict__ Cm, const float* __restrict__ dy,
            bf16* __restrict__ dx, float* __restrict__ ddt,
            float* __restrict__ ds_part, float* __restrict__ st_part,
            float* __restrict__ da_part, int Q, int H, int N, int G,
            int chunk) {
  constexpr int LDX = P + kPad, NT = P / 8, KP = P / 16;
  constexpr int SLOT = 16 * LDX + 16;            // floats of one dxdt slot
  const int groups = H / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x - b * groups) * G;
  const int QS = round_up(Q, 16), nS = QS / 16;
  const int NP = round_up(N, 16), LDN = NP + kPad;
  const int nt = blockDim.x, nwarps = nt >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const long long row0 = (long long)b * Q;
  const int TRI = tri_floats(QS);

  // This warp's strip s and run q of nparts, and the first slot of the
  // strip's runs after the first.  The warps of runs shorter than `chunk`
  // (the last run of a strip whose subtiles chunk does not divide) have
  // time to spare: they issue the heads' copies, fi-th of nf (every warp
  // when no run is short).
  int s = 0, q = 0, nparts = 1, first_slot = 0, nf = 0, fi = -1;
  for (int k = warp, slot = 0, w = 0, s2 = 0; s2 < nS; ++s2) {
    const int n = (nS - s2 + chunk - 1) / chunk;
    if (k >= 0 && k < n) {
      s = s2;
      q = k;
      nparts = n;
      first_slot = slot;
    }
    if ((nS - s2) % chunk) {            // its last run is short
      if (warp == w + n - 1) fi = nf;
      ++nf;
    }
    k -= n;
    slot += n - 1;
    w += n;
  }
  if (nf == 0) {
    nf = nwarps;
    fi = warp;
  }
  const int j0 = 16 * s, u0 = s + q * chunk;
  const int u1 = min(nS, u0 + chunk);
  const int ja = j0 + gq, jb = ja + 8;           // this lane's two rows j

  const BwdLayout L = bwd_layout(Q, N, P, G, nwarps - nS, kTri);
  extern __shared__ __align__(16) unsigned char smem_b[];
  float* st = kTri ? reinterpret_cast<float*>(smem_b + L.st)
                   : st_part + (long long)blockIdx.x * TRI;
  float* dst = kTri ? reinterpret_cast<float*>(smem_b + L.ds)
                    : ds_part + (long long)blockIdx.x * TRI;
  bf16* xs = reinterpret_cast<bf16*>(smem_b + L.x);
  float* yst = reinterpret_cast<float*>(smem_b + L.ybuf);
  bf16* yhi = reinterpret_cast<bf16*>(smem_b + L.yhi);
  bf16* ylo = reinterpret_cast<bf16*>(smem_b + L.ylo);
  float* xch = reinterpret_cast<float*>(smem_b + L.xch);
  float* rp = reinterpret_cast<float*>(smem_b + L.rp);
  float* dt_s = reinterpret_cast<float*>(smem_b + L.dt);
  float* dc_s = reinterpret_cast<float*>(smem_b + L.dc);
  float* c2_s = reinterpret_cast<float*>(smem_b + L.c2);

  // B and C rows into the dY region and dt of the group's heads: zeros
  // past Q and past N.
  {
    bf16* bs = reinterpret_cast<bf16*>(smem_b + L.ybuf);
    bf16* cs = bs + QS * LDN;
    if ((N & 7) == 0) {
      const int CH = NP / 8;
      for (int idx = threadIdx.x; idx < QS * CH; idx += nt) {
        const int r = idx / CH, c = (idx - r * CH) * 8;
        const bool ok = r < Q && c < N;
        const long long at = (row0 + r) * N + c;
        cp_async16(bs + r * LDN + c, ok ? Bm + at : Bm, ok ? 16 : 0);
        cp_async16(cs + r * LDN + c, ok ? Cm + at : Cm, ok ? 16 : 0);
      }
    } else {
      for (int idx = threadIdx.x; idx < QS * NP; idx += nt) {
        const int r = idx / NP, c = idx - r * NP;
        const bool ok = r < Q && c < N;
        const long long at = (row0 + r) * N + c;
        bs[r * LDN + c] = ok ? Bm[at] : __float2bfloat16(0.f);
        cs[r * LDN + c] = ok ? Cm[at] : __float2bfloat16(0.f);
      }
    }
    for (int idx = threadIdx.x; idx < G * QS; idx += nt) {
      const int g = idx / QS, r = idx - g * QS;
      const bool ok = r < Q;
      cp_async4(dt_s + idx, ok ? dt + (row0 + r) * H + h0 + g : dt,
                ok ? 4 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // c = cumsum of dt A (rounded, then added), times log2(e), one warp a
    // head, 32 positions at a time by shuffles.
    for (int g = warp; g < G; g += nwarps) {
      const float a_h = A[h0 + g];
      float carry = 0.f;
      for (int c0 = 0; c0 < QS; c0 += 32) {
        const int j = c0 + lane;
        float v = j < QS ? __fmul_rn(dt_s[g * QS + j], a_h) : 0.f;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const float up = __shfl_up_sync(0xffffffffu, v, o);
          if (lane >= o) v = __fadd_rn(up, v);
        }
        v = __fadd_rn(carry, v);
        if (j < QS) c2_s[g * QS + j] = __fmul_rn(v, kLog2e);
        carry = __shfl_sync(0xffffffffu, v, 31);
      }
    }
    // S^T[j, i] = B_j . C_i over N in 16-steps, for the warp's pairs.
    for (int u = u0; u < u1; ++u) {
      const int i0 = 16 * u;
      float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int ks = 0; ks < NP; ks += 16) {
        uint32_t a[4], bb[4];
        ldmatrix_x4(a, bs + (j0 + (lane & 15)) * LDN + ks + (lane >> 4) * 8);
        ldmatrix_x4(bb, cs + (i0 + (lane >> 4) * 8 + (lane & 7)) * LDN + ks +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(acc[0], a, bb[0], bb[1]);
        mma_bf16(acc[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = i0 + 8 * t + 2 * tq;
        *reinterpret_cast<float2*>(st + tri_at(QS, ja, i)) =
            make_float2(acc[t][0], acc[t][1]);
        *reinterpret_cast<float2*>(st + tri_at(QS, jb, i)) =
            make_float2(acc[t][2], acc[t][3]);
      }
    }
    __syncthreads();                    // B and C consumed
  }

  // Head g's x tile and dY (f32, as it lands): zeros past Q.
  auto fetch = [&](int g) {
    if (fi < 0) return;
    const long long hp = (long long)(h0 + g) * P;
    constexpr int CX = P / 8, CY = P / 4;
    const int t0 = 32 * fi + lane, nft = 32 * nf;
    for (int idx = t0; idx < QS * CX; idx += nft) {
      const int r = idx / CX, c = (idx - r * CX) * 8;
      const bool ok = r < Q;
      cp_async16(xs + r * LDX + c, ok ? x + (row0 + r) * H * P + hp + c : x,
                 ok ? 16 : 0);
    }
    for (int idx = t0; idx < QS * CY; idx += nft) {
      const int r = idx / CY, c = (idx - r * CY) * 4;
      const bool ok = r < Q;
      cp_async16(yst + r * P + c, ok ? dy + (row0 + r) * H * P + hp + c : dy,
                 ok ? 16 : 0);
    }
  };
  fetch(0);
  cp_async_commit();

  for (int g = 0; g < G; ++g) {
    const float* dtg = dt_s + g * QS;
    const float* c2g = c2_s + g * QS;
    cp_async_wait<0>();
    __syncthreads();    // head g landed; head g - 1's slots and dx read
    // dY as hi = bf16(dY) and lo = bf16(dY - hi), once per head.
    for (int idx = threadIdx.x; idx < QS * P / 4; idx += nt) {
      const int r = idx / (P / 4), c = (idx - r * (P / 4)) * 4;
      const float4 v = *reinterpret_cast<const float4*>(yst + r * P + c);
      uint32_t h01, l01, h23, l23;
      split(v.x, v.y, h01, l01);
      split(v.z, v.w, h23, l23);
      *reinterpret_cast<uint2*>(yhi + r * LDX + c) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(ylo + r * LDX + c) = make_uint2(l01, l23);
    }
    uint32_t xa[KP][4];                 // x of the strip: A fragments
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
      ldmatrix_x4(xa[kk], xs + (j0 + (lane & 15)) * LDX + kk * 16 +
                              (lane >> 4) * 8);
    __syncthreads();    // hi and lo ready; x and the dY landing free
    if (g + 1 < G) fetch(g + 1);
    cp_async_commit();

    const float dta = dtg[ja], dtb = dtg[jb];
    const float cja = c2g[ja], cjb = c2g[jb];
    float acc[NT][4];                   // dxdt of the strip, this run's i
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[n][v] = 0.f;
    float colp0 = 0.f, colp1 = 0.f;     // column sums of G, rows ja / jb
    for (int u = u0; u < u1; ++u) {
      const int i0 = 16 * u;
      const bool diag = u == s;
      // dW'^T[j, i] = x_j . dY_i: x exact, dY as hi and lo.
      float dwh[2][4], dwl[2][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int v = 0; v < 4; ++v) dwh[t][v] = dwl[t][v] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KP; ++kk) {
        uint32_t bh[4], bl[4];
        const int off = (i0 + (lane >> 4) * 8 + (lane & 7)) * LDX + kk * 16 +
                        ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bh, yhi + off);
        ldmatrix_x4(bl, ylo + off);
        mma_bf16(dwh[0], xa[kk], bh[0], bh[1]);
        mma_bf16(dwh[1], xa[kk], bh[2], bh[3]);
        mma_bf16(dwl[0], xa[kk], bl[0], bl[1]);
        mma_bf16(dwl[1], xa[kk], bl[2], bl[3]);
      }
      // Per 8-column tile t: L, dW = dW' dt_j (zero where j > i), W = S L,
      // G = dW W, dS^T += dW L, and W^T as hi/lo A fragments.
      uint32_t wh[4], wl[4];
      float rs[4];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = i0 + 8 * t + 2 * tq;
        const float2 ci = *reinterpret_cast<const float2*>(c2g + i);
        const float2 sa = *reinterpret_cast<const float2*>(st + tri_at(QS, ja, i));
        const float2 sb = *reinterpret_cast<const float2*>(st + tri_at(QS, jb, i));
        const bool v00 = !diag || ja <= i, v01 = !diag || ja <= i + 1;
        const bool v10 = !diag || jb <= i, v11 = !diag || jb <= i + 1;
        const float L00 = v00 ? exp2_ftz(ci.x - cja) : 0.f;
        const float L01 = v01 ? exp2_ftz(ci.y - cja) : 0.f;
        const float L10 = v10 ? exp2_ftz(ci.x - cjb) : 0.f;
        const float L11 = v11 ? exp2_ftz(ci.y - cjb) : 0.f;
        const float d00 = v00 ? (dwh[t][0] + dwl[t][0]) * dta : 0.f;
        const float d01 = v01 ? (dwh[t][1] + dwl[t][1]) * dta : 0.f;
        const float d10 = v10 ? (dwh[t][2] + dwl[t][2]) * dtb : 0.f;
        const float d11 = v11 ? (dwh[t][3] + dwl[t][3]) * dtb : 0.f;
        const float w00 = sa.x * L00, w01 = sa.y * L01;
        const float w10 = sb.x * L10, w11 = sb.y * L11;
        const float g00 = d00 * w00, g01 = d01 * w01;
        const float g10 = d10 * w10, g11 = d11 * w11;
        colp0 = colp0 + g00 + g01;
        colp1 = colp1 + g10 + g11;
        rs[2 * t] = g00 + g10;          // this lane's rows of columns i
        rs[2 * t + 1] = g01 + g11;      // and i + 1
        float2* pa = reinterpret_cast<float2*>(dst + tri_at(QS, ja, i));
        float2* pb = reinterpret_cast<float2*>(dst + tri_at(QS, jb, i));
        float2 e0 = make_float2(d00 * L00, d01 * L01);
        float2 e1 = make_float2(d10 * L10, d11 * L11);
        if (g > 0) {                    // heads in order: old + this head
          const float2 o0 = *pa, o1 = *pb;
          e0 = make_float2(o0.x + e0.x, o0.y + e0.y);
          e1 = make_float2(o1.x + e1.x, o1.y + e1.y);
        }
        *pa = e0;
        *pb = e1;
        split(w00, w01, wh[2 * t], wl[2 * t]);
        split(w10, w11, wh[2 * t + 1], wl[2 * t + 1]);
      }
      // Row sums of G over the strip's 16 rows j, in a fixed order: the
      // lanes that share tq halve their four columns by lane bits 4 and 3,
      // then add across bit 2; lane (bits 4, 3) ends with column 2 bit4 +
      // bit3 of rs, i.e. tile bit4's column i + bit3.
      {
        const bool b4 = lane & 16, b3 = lane & 8;
        const float s0 = __shfl_xor_sync(0xffffffffu, b4 ? rs[0] : rs[2], 16);
        const float s1 = __shfl_xor_sync(0xffffffffu, b4 ? rs[1] : rs[3], 16);
        const float k0 = (b4 ? rs[2] : rs[0]) + s0;
        const float k1 = (b4 ? rs[3] : rs[1]) + s1;
        const float s2 = __shfl_xor_sync(0xffffffffu, b3 ? k0 : k1, 8);
        float r = (b3 ? k1 : k0) + s2;
        r += __shfl_xor_sync(0xffffffffu, r, 4);
        if ((lane & 4) == 0)
          rp[s * QS + i0 + (b4 ? 8 : 0) + 2 * tq + (b3 ? 1 : 0)] = r;
      }
      // dxdt[j, p] += sum_i W^T[j, i] dY[i, p]: hi.hi + hi.lo + lo.hi.
#pragma unroll
      for (int dp = 0; dp < KP; ++dp) {
        uint32_t bh[4], bl[4];
        const int off = (i0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDX +
                        dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bh, yhi + off);
        ldmatrix_x4_trans(bl, ylo + off);
        mma_bf16(acc[2 * dp], wh, bh[0], bh[1]);
        mma_bf16(acc[2 * dp], wh, bl[0], bl[1]);
        mma_bf16(acc[2 * dp], wl, bh[0], bh[1]);
        mma_bf16(acc[2 * dp + 1], wh, bh[2], bh[3]);
        mma_bf16(acc[2 * dp + 1], wh, bl[2], bl[3]);
        mma_bf16(acc[2 * dp + 1], wl, bh[2], bh[3]);
      }
    }
    __syncthreads();    // every pair done: hi/lo free, row sums complete
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      colp0 += __shfl_xor_sync(0xffffffffu, colp0, o);
      colp1 += __shfl_xor_sync(0xffffffffu, colp1, o);
    }
    if (q > 0) {                        // a later run: into its slot
      float* slot = xch + (first_slot + q - 1) * SLOT;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int p = n * 8 + 2 * tq;
        *reinterpret_cast<float2*>(slot + gq * LDX + p) =
            make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(slot + (gq + 8) * LDX + p) =
            make_float2(acc[n][2], acc[n][3]);
      }
      if (tq == 0) {
        slot[16 * LDX + gq] = colp0;
        slot[16 * LDX + gq + 8] = colp1;
      }
    }
    if (nparts > 1) named_sync(1 + s, 32 * nparts);   // the strip's runs
    if (q == 0) {                       // the strip's first run finishes it
      for (int k = 1; k < nparts; ++k) {
        const float* slot = xch + (first_slot + k - 1) * SLOT;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int p = n * 8 + 2 * tq;
          const float2 a = *reinterpret_cast<const float2*>(slot + gq * LDX + p);
          const float2 c =
              *reinterpret_cast<const float2*>(slot + (gq + 8) * LDX + p);
          acc[n][0] += a.x;
          acc[n][1] += a.y;
          acc[n][2] += c.x;
          acc[n][3] += c.y;
        }
        colp0 += slot[16 * LDX + gq];
        colp1 += slot[16 * LDX + gq + 8];
      }
      // dx = dt dxdt, staged in the strip's rows of the hi tile, then
      // stored in 16-byte row pieces.
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int p = n * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(yhi + ja * LDX + p) =
            pack_bf16x2(dta * acc[n][0], dta * acc[n][1]);
        *reinterpret_cast<uint32_t*>(yhi + jb * LDX + p) =
            pack_bf16x2(dtb * acc[n][2], dtb * acc[n][3]);
      }
      __syncwarp();
      constexpr int CX = P / 8;
      for (int pc = lane; pc < 16 * CX; pc += 32) {
        const int r = pc / CX, c = (pc - r * CX) * 8, j = j0 + r;
        if (j < Q)
          *reinterpret_cast<int4*>(dx + ((row0 + j) * H + h0 + g) * P + c) =
              *reinterpret_cast<const int4*>(yhi + j * LDX + c);
      }
      // x . dxdt from the x fragments (the same lanes hold the same
      // (row, column) pairs as the accumulators).
      float xd[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // [row][column parity]
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 xa0 = unpack_bf16x2(xa[n / 2][(n & 1) * 2]);
        const float2 xb0 = unpack_bf16x2(xa[n / 2][(n & 1) * 2 + 1]);
        xd[0][0] = fmaf(xa0.x, acc[n][0], xd[0][0]);
        xd[0][1] = fmaf(xa0.y, acc[n][1], xd[0][1]);
        xd[1][0] = fmaf(xb0.x, acc[n][2], xd[1][0]);
        xd[1][1] = fmaf(xb0.y, acc[n][3], xd[1][1]);
      }
      float xda = xd[0][0] + xd[0][1], xdb = xd[1][0] + xd[1][1];
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        xda += __shfl_xor_sync(0xffffffffu, xda, o);
        xdb += __shfl_xor_sync(0xffffffffu, xdb, o);
      }
      if (tq == 0) {                    // dc = rowsum(G) - colsum(G)
        float ra = 0.f, rb = 0.f;
#pragma unroll
        for (int s2 = 0; s2 < kBwdMaxWarps; ++s2) {
          if (s2 > s) break;
          ra += rp[s2 * QS + ja];
          rb += rp[s2 * QS + jb];
        }
        dc_s[g * QS + ja] = ra - colp0;
        dc_s[g * QS + jb] = rb - colp1;
        if (ja < Q) ddt[(row0 + ja) * H + h0 + g] = xda;   // A da: at the end
        if (jb < Q) ddt[(row0 + jb) * H + h0 + g] = xdb;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // Per head, one warp: da = reverse cumsum of dc by 32-row suffix scans
  // from the end (into dc_s), and sum_j da_j dt_j.
  for (int g = warp; g < G; g += nwarps) {
    float carry = 0.f, dsum = 0.f;
    for (int top = QS; top > 0; top -= 32) {
      const int j = top - 32 + lane;
      float v = (j >= 0 && j < Q) ? dc_s[g * QS + j] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float dn = __shfl_down_sync(0xffffffffu, v, o);
        if (lane + o < 32) v += dn;
      }
      v += carry;
      carry = __shfl_sync(0xffffffffu, v, 0);
      if (j >= 0 && j < Q) {
        dc_s[g * QS + j] = v;
        dsum = fmaf(v, dt_s[g * QS + j], dsum);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dsum += __shfl_xor_sync(0xffffffffu, dsum, o);
    if (lane == 0) da_part[(long long)b * H + h0 + g] = dsum;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < Q * G; idx += nt) {   // ddt += A da
    const int j = idx / G, g = idx - j * G;
    float* o = ddt + (row0 + j) * H + h0 + g;
    *o = fmaf(A[h0 + g], dc_s[g * QS + j], *o);
  }
  if (kTri) {                           // the group's dS^T for launch 2
    float4* out = reinterpret_cast<float4*>(ds_part +
                                            (long long)blockIdx.x * TRI);
    const float4* in = reinterpret_cast<const float4*>(dst);
    for (int idx = threadIdx.x; idx < TRI / 4; idx += nt) out[idx] = in[idx];
  }
}

// Launch 2's shared memory: the dS tile's hi and lo (64, 64 + 8) bf16 and
// a (64, NP + 8) bf16 tile of B or C rows, which also stages the output.
inline int bwd_reduce_mma_smem(int N) {
  return 2 * kRedRows * (kRedRows + kPad) * 2 +
         kRedRows * (round_up(N, 16) + kPad) * 2;
}

// Launch 2: grid (Bc + 1, 2 nT), nT = ceil(QS / 64), 8 warps.  Block (b, t
// < nT) forms dC of 64 rows i, block (b, nT + t) dB of 64 keys j; each dS
// tile is the groups' partials summed in ascending order, then fed as a
// bf16 hi/lo pair against the exact B or C rows; warp w owns 16 rows (w %
// 4) and every other 16 columns of N (w / 4).  Block (Bc, 0) sums dA over
// the chunk rows in ascending order.
__global__ void __launch_bounds__(256)
ssd_bwd_reduce_mma(const bf16* __restrict__ Bm, const bf16* __restrict__ Cm,
                   const float* __restrict__ ds_part,
                   const float* __restrict__ da_part, bf16* __restrict__ dB,
                   bf16* __restrict__ dC, float* __restrict__ dA, int Bc,
                   int Q, int H, int N, int groups) {
  constexpr int LDS = kRedRows + kPad;
  const int QS = round_up(Q, 16), nT = (QS + kRedRows - 1) / kRedRows;
  if (blockIdx.x == Bc) {
    if (blockIdx.y != 0) return;
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      float s = 0.f;
      for (int b = 0; b < Bc; ++b) s += da_part[(long long)b * H + h];
      dA[h] = s;
    }
    return;
  }
  const int b = blockIdx.x;
  const bool rows = (int)blockIdx.y < nT;       // dC; else dB
  const int t = rows ? blockIdx.y : blockIdx.y - nT;
  const int NP = round_up(N, 16), LDN = NP + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, tq = lane & 3, m0 = 16 * (warp & 3);
  const int nh = warp >> 2;
  const long long row0 = (long long)b * Q;
  const int TRI = tri_floats(QS);
  const float* part = ds_part + (long long)b * groups * TRI;

  extern __shared__ __align__(16) unsigned char smem_b[];
  bf16* sh = reinterpret_cast<bf16*>(smem_b);   // dS tile [j][i], hi
  bf16* sl = sh + kRedRows * LDS;               // and lo
  bf16* vs = sl + kRedRows * LDS;               // B or C rows [row][n]

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[n][v] = 0.f;
  const int w0 = rows ? 0 : t, w1 = rows ? t : nT - 1;
  for (int w = w0; w <= w1; ++w) {
    const int I = rows ? t : w, J = rows ? w : t;
    __syncthreads();                    // the last step's tiles consumed
    for (int idx = threadIdx.x; idx < kRedRows * 16; idx += blockDim.x) {
      const int r = idx >> 4, c = (idx & 15) * 4;
      const int j = kRedRows * J + r, i = kRedRows * I + c;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < QS && i < QS && i >= 16 * (j >> 4)) {
        const float* src = part + tri_at(QS, j, i);
        for (int g0 = 0; g0 < groups; g0 += 8) {   // 8 loads in flight
          float4 p[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            if (g0 + k < groups)
              p[k] = *reinterpret_cast<const float4*>(
                  src + (long long)(g0 + k) * TRI);
#pragma unroll
          for (int k = 0; k < 8; ++k)           // summed in group order
            if (g0 + k < groups)
              v = make_float4(v.x + p[k].x, v.y + p[k].y, v.z + p[k].z,
                              v.w + p[k].w);
        }
      }
      uint32_t h01, l01, h23, l23;
      split(v.x, v.y, h01, l01);
      split(v.z, v.w, h23, l23);
      *reinterpret_cast<uint2*>(sh + r * LDS + c) = make_uint2(h01, h23);
      *reinterpret_cast<uint2*>(sl + r * LDS + c) = make_uint2(l01, l23);
    }
    const bf16* src = rows ? Bm : Cm;
    const int v0 = kRedRows * (rows ? J : I);
    if ((N & 7) == 0) {                 // rows of 16-byte pieces
      const int CH = NP / 8;
      for (int idx = threadIdx.x; idx < kRedRows * CH; idx += blockDim.x) {
        const int r = idx / CH, c = (idx - r * CH) * 8, row = v0 + r;
        int4 v = make_int4(0, 0, 0, 0);
        if (row < Q && c < N)
          v = *reinterpret_cast<const int4*>(src + (row0 + row) * N + c);
        *reinterpret_cast<int4*>(vs + r * LDN + c) = v;
      }
    } else {
      for (int idx = threadIdx.x; idx < kRedRows * NP; idx += blockDim.x) {
        const int r = idx / NP, n = idx - r * NP, row = v0 + r;
        vs[r * LDN + n] = (row < Q && n < N) ? src[(row0 + row) * N + n]
                                             : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kRedRows / 16; ++kk) {
      uint32_t ah[4], al[4];
      if (rows) {       // A = dS[i][j], rows i, from the [j][i] tile
        const int off = (kk * 16 + ((lane >> 4) & 1) * 8 + (lane & 7)) * LDS +
                        m0 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4_trans(ah, sh + off);
        ldmatrix_x4_trans(al, sl + off);
      } else {          // A = dS^T[j][i], rows j
        const int off = (m0 + (lane & 15)) * LDS + kk * 16 + (lane >> 4) * 8;
        ldmatrix_x4(ah, sh + off);
        ldmatrix_x4(al, sl + off);
      }
#pragma unroll
      for (int np = 0; np < 8; ++np) {
        if (np * 16 >= NP) break;
        if ((np & 1) != nh) continue;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, vs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                    (lane & 7)) * LDN +
                                  np * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * np], ah, bv[0], bv[1]);
        mma_bf16(acc[2 * np], al, bv[0], bv[1]);
        mma_bf16(acc[2 * np + 1], ah, bv[2], bv[3]);
        mma_bf16(acc[2 * np + 1], al, bv[2], bv[3]);
      }
    }
  }
  __syncthreads();                      // vs free: stage the output rows
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    if (n * 8 >= NP) break;
    if (((n >> 1) & 1) != nh) continue;
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(vs + (m0 + gq) * LDN + col) =
        pack_bf16x2(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(vs + (m0 + gq + 8) * LDN + col) =
        pack_bf16x2(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  bf16* out = rows ? dC : dB;
  for (int idx = threadIdx.x; idx < kRedRows * N; idx += blockDim.x) {
    const int r = idx / N, n = idx - r * N, row = kRedRows * t + r;
    if (row < Q) out[(row0 + row) * N + n] = vs[r * LDN + n];
  }
}

template <int P>
cudaError_t launch_bwd_mma(const bf16* x, const float* dt, const float* A,
                           const bf16* Bm, const bf16* Cm, const float* dy,
                           bf16* dx, float* ddt, float* dA, bf16* dB,
                           bf16* dC, float* ds_part, float* st_part,
                           float* da_part, int Bc, int Q, int H, int N,
                           int G, int chunk, int tri_smem, int warps,
                           size_t smem, size_t reduce_smem, cudaStream_t s) {
  auto kernel = tri_smem ? ssd_bwd_mma<P, true> : ssd_bwd_mma<P, false>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = allow_smem(ssd_bwd_reduce_mma, reduce_smem);
  if (err != cudaSuccess) return err;
  kernel<<<Bc * (H / G), warps * 32, smem, s>>>(
      x, dt, A, Bm, Cm, dy, dx, ddt, ds_part, st_part, da_part, Q, H, N, G,
      chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nT = (round_up(Q, 16) + kRedRows - 1) / kRedRows;
  ssd_bwd_reduce_mma<<<dim3(Bc + 1, 2 * nT), 256, reduce_smem, s>>>(
      Bm, Cm, ds_part, da_part, dB, dC, dA, Bc, Q, H, N, H / G);
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

// The shapes and the plan of one backward call, every field 8 bytes wide
// (kernels/ssd_scan.py `_BwdArgs` mirrors it).  dtype 0 = float32, 1 =
// bfloat16; route 0 = SIMT (float32 only), 1 = tensor cores (bfloat16
// only); head_group heads a block of launch 1; threads a block of launch
// 1; smem and reduce_smem the dynamic shared memory of launches 1 and 2;
// blocks launch 1's grid; reduce_y launch 2's grid.y (its grid.x is Bc +
// 1); chunk the subtiles a warp's run (tensor cores; 0 on SIMT); tri_smem
// 1 when the S^T and dS^T triangles live in shared memory (tensor cores).
struct SsdBwdArgs {
  long long Bc, Q, H, P, N, dtype, route, head_group, threads, smem, blocks,
      reduce_smem, reduce_y, chunk, tri_smem;
};

// x (Bc,Q,H,P), Bm/Cm (Bc,Q,N), dx, dB, dC in the dtype; dt, ddt
// (Bc,Q,H), A, dA (H,), dy (Bc,Q,H,P) float32; all contiguous, and 16-byte
// aligned on the tensor-core route.  Scratch, float32: on SIMT ds_part (Bc,
// H / head_group, QT, QT), QT = Q rounded up to 64, st_part unused; on
// tensor cores ds_part (Bc, H / head_group, TRI) and, without tri_smem,
// st_part of the same shape, TRI = tri_floats(Q rounded up to 16);
// da_part (Bc, H).  Two launches on `stream`; returns cudaGetLastError()
// after them (0 = launched), or cudaErrorInvalidValue for a plan that is
// not this file's.
int ssd_scan_bwd_launch(const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* dy,
                        void* dx, void* ddt, void* dA, void* dB, void* dC,
                        void* ds_part, void* st_part, void* da_part,
                        const SsdBwdArgs* a, void* stream) {
  const int Bc = (int)a->Bc, Q = (int)a->Q, H = (int)a->H, P = (int)a->P,
            N = (int)a->N, G = (int)a->head_group;
  if (Bc <= 0 || Q <= 0 || Q > 256 || H <= 0 || N <= 0 || N > 128 ||
      G <= 0 || H % G || (P != 32 && P != 64) ||
      a->route != a->dtype || (a->dtype != 0 && a->dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dt);
  const float* av = static_cast<const float*>(A);
  const float* g = static_cast<const float*>(dy);
  float* dd = static_cast<float*>(ddt);
  float* da = static_cast<float*>(dA);
  float* dsp = static_cast<float*>(ds_part);
  float* dap = static_cast<float*>(da_part);
  if (a->route == 0) {
    const size_t smem = sizeof(float) * bwd_smem_floats(Q, N, P, G);
    const size_t reduce_smem = sizeof(float) * bwd_reduce_smem_floats(N);
    if (G > 16 || a->threads != kThreads || (size_t)a->smem != smem ||
        a->blocks != (long long)Bc * (H / G) ||
        (size_t)a->reduce_smem != reduce_smem ||
        a->reduce_y != 2 * ((Q + kRows - 1) / kRows) || a->chunk != 0 ||
        a->tri_smem != 0)
      return (int)cudaErrorInvalidValue;
#define BWD_CASE(PP)                                                        \
  return (int)launch_bwd<PP, float>(x, d, av, Bm, Cm, g, dx, dd, da, dB, dC, \
                                    dsp, dap, Bc, Q, H, N, G, smem,         \
                                    reduce_smem, s);
    if (P == 32) BWD_CASE(32)
    BWD_CASE(64)
#undef BWD_CASE
  }
  const int QS = round_up(Q, 16), nS = QS / 16;
  const int chunk = bwd_chunk(nS), warps = bwd_warps(nS, chunk);
  const int tri_smem = QS <= kTriSmemRows;
  const BwdLayout L = bwd_layout(Q, N, P, G, warps - nS, tri_smem);
  const int reduce_smem = bwd_reduce_mma_smem(N);
  if (G > kBwdMaxGroup || a->chunk != chunk || a->tri_smem != tri_smem ||
      a->threads != 32 * warps || a->smem != L.total ||
      L.total > 232448 || a->blocks != (long long)Bc * (H / G) ||
      a->reduce_smem != reduce_smem ||
      a->reduce_y != 2 * ((QS + kRedRows - 1) / kRedRows))
    return (int)cudaErrorInvalidValue;
#define BWD_MMA_CASE(PP)                                                    \
  return (int)launch_bwd_mma<PP>(                                           \
      static_cast<const bf16*>(x), d, av, static_cast<const bf16*>(Bm),     \
      static_cast<const bf16*>(Cm), g, static_cast<bf16*>(dx), dd, da,      \
      static_cast<bf16*>(dB), static_cast<bf16*>(dC), dsp,                  \
      static_cast<float*>(st_part), dap, Bc, Q, H, N, G, chunk, tri_smem,   \
      warps, L.total, reduce_smem, s);
  if (P == 32) BWD_MMA_CASE(32)
  BWD_MMA_CASE(64)
#undef BWD_MMA_CASE
}

}  // extern "C"
