// Paged attention over a two-tier KV page pool — CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/paged_attention.py
// (paged_attention_pallas, body _kernel; paged_prefill_pallas reuses it
// with the page table broadcast over S query rows).
//
// What it computes, per query row (token, query head) of KV head kh: the
// row attends over the pages its page table lists, with an online softmax
// in f32:
//   a position counts when   its page's slot >= 0,  pos < length  and,
//                            with a window,  (length-1-pos) < window
//   a row with length 0 (padded prefill row) is written as zeros.
// Decode passes a (B, MP) table (row stride MP); prefill passes one (MP,)
// table with row stride 0 and per-row causal lengths.
//
// The per-row contract.  A row's output depends only on its query vector,
// its table row, its length, the window and the dtype.  It does not depend
// on B or S, on MP, on the row's place in a tile, or on any other row.  So
// prefill row t is bit for bit the decode of the same query, table and
// length, which the engine's one-shot == chunked == decode and preemption
// by recompute rest on.  How the bf16 path keeps it:
//   - Key blocks at absolute positions: block j covers [j*64, (j+1)*64)
//     whatever the caller is, and a row walks its blocks in increasing j.
//     The online-softmax update (max, rescale, exp2, sum, P.V) runs once per
//     block with the same instructions for every row in both entry points.
//   - A fully masked block is an exact identity: the mask is a select to
//     -inf on the score, so m_new = m_prev, alpha = exp2(0) = 1, p = 0, and
//     l*1 + 0 = l, acc*1 + 0.V = acc (P.V of a block goes into a fresh
//     register tile and is folded in with one fma).  The pools are
//     zero-initialised and finite, and a page that is not loaded is
//     zero-filled, so 0.V is 0.  Prefill CTAs therefore walk the union of
//     their rows' blocks while decode walks only its row's own, and the two
//     agree.
//   - No split over keys: one warp carries a row through all of its blocks.
//     The tile shape (tokens per CTA) is chosen from G alone, and an
//     m16n8k16 product gives an output row the same bits wherever the row
//     sits in the 16-row tile.
//   - Row sums: each lane sums its 16 values in a fixed order, then the four
//     lanes of a row combine with two xor shuffles (commutative adds: all
//     four lanes hold the same bits).
//   - Pages never loaded: a slot < 0, or a page past MP, inside a block
//     that is read is zero-filled by cp.async with a source size of 0
//     (slot -1 would address before the pool) and its positions masked.
//
// Bound.  (q + the distinct K/V pages the lengths reach + out) bytes over
// 3.35 TB/s against the QK and PV operations (4 * H * sum(length) * dh)
// over 989 TFLOP/s (bf16).  Decode and the serving prefills are bound by
// bytes.
//
// Design, against what held the first version back:
//   - One block per (query row, KV head), prefill re-reading every page per
//     row (268 MB of loads at dense S=512): a bf16 CTA now holds 64 query
//     rows of one KV head in prefill (64/G tokens x G heads, 4 warps of 16
//     rows) sharing every K/V block from shared memory; decode holds the G
//     heads of one (b, kh) in one warp tile, the other rows zero, in a CTA
//     of 4 warps whose other 3 only issue loads.
//   - No tensor cores: Q.K^T and P.V are mma.sync m16n8k16 (bf16 in, f32
//     accumulate) fed by ldmatrix; P is rounded to bf16 for P.V.
//   - Scalar 2-byte loads, one page at a time with six barriers a page:
//     16-byte cp.async of whole 64-key blocks into a 3-stage ring, the next
//     blocks in flight while the current one is multiplied, one barrier a
//     block.
//   - Bank conflicts: shared rows are padded to dh + 8 elements, so the
//     eight 16-byte rows an ldmatrix reads fall on distinct banks.  The f32
//     path pads its K rows to dh + 1 floats.
//   - Threads idle in the reductions: the max and sum run on every lane of a
//     warp tile (a row on four lanes), in registers.
//   - Decode latency: a block is 64 keys, four 16-token pages, per barrier;
//     the table is read into a slot ring a block ahead of the loads, the
//     query rows come in with the first block's copies, and the block range
//     is reduced by shuffles, with no barrier of its own.  What remains is
//     latency: one warp carries its 16 rows through every block in turn.
// float32 runs on the card only in the checks: it keeps a SIMT path shared
// by both entry points (one block per (row, KV head), a page at a time),
// since TF32 tensor cores would break its 2e-5 tolerance.

#include <climits>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;          // key-block width of the bf16 path
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kMaxWarps = 8;
constexpr int kSimtThreads = 128;
constexpr float kNegInf = -1e30f;   // f32 path: initial running max

__device__ __forceinline__ float minus_inf() {
  return __int_as_float(0xff800000);
}

// ------------------------------------------------------------- f32, SIMT
__global__ void __launch_bounds__(kSimtThreads)
paged_attention_simt(const float* __restrict__ q,
                     const float* __restrict__ k_pool,
                     const float* __restrict__ v_pool,
                     const int* __restrict__ table,
                     const int* __restrict__ lengths, float* __restrict__ out,
                     int H, int K, int dh, int P, int MP,
                     long long table_row_stride, int window, float scale) {
  const int row = blockIdx.x;
  const int kh = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x;
  const int kld = dh + 1;            // padded K row: no bank conflicts

  extern __shared__ float smem_f[];
  float* q_s = smem_f;               // (G, dh)
  float* acc_s = q_s + G * dh;       // (G, dh)
  float* k_s = acc_s + G * dh;       // (P, dh + 1)
  float* v_s = k_s + P * kld;        // (P, dh)
  float* p_s = v_s + P * dh;         // (G, P) scores, then probabilities
  float* m_s = p_s + G * P;          // (G,)
  float* l_s = m_s + G;              // (G,)
  float* a_s = l_s + G;              // (G,) rescale factor of this page

  const int length = lengths[row];
  const int* trow = table + row * table_row_stride;
  const long long q_base = ((long long)row * H + (long long)kh * G) * dh;

  for (int i = tid; i < G * dh; i += kSimtThreads) {
    q_s[i] = q[q_base + i];
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kSimtThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  int first = 0;                     // first page inside the window
  if (window > 0 && length - window > 0) first = (length - window) / P;
  const int n_pages = min(MP, (length + P - 1) / P);   // p*P < length

  for (int p = first; p < n_pages; ++p) {
    const int slot = trow[p];
    if (slot < 0) continue;                 // uniform across the block
    __syncthreads();                        // previous page fully consumed
    const long long page_base = (long long)slot * P * K * dh;
    for (int i = tid; i < P * dh; i += kSimtThreads) {
      const int t = i / dh, d = i - t * dh;
      const long long off = page_base + ((long long)t * K + kh) * dh + d;
      k_s[t * kld + d] = k_pool[off];
      v_s[i] = v_pool[off];
    }
    __syncthreads();
    for (int i = tid; i < G * P; i += kSimtThreads) {
      const int g = i / P, t = i - g * P;
      const int pos = p * P + t;
      bool ok = pos < length;
      if (window > 0) ok = ok && (length - 1 - pos) < window;
      float s = minus_inf();
      if (ok) {
        const float* qg = q_s + g * dh;
        const float* kt = k_s + t * kld;
        float dot = 0.f;
        for (int d = 0; d < dh; ++d) dot = fmaf(qg[d], kt[d], dot);
        s = dot * scale;
      }
      p_s[i] = s;
    }
    __syncthreads();
    for (int g = tid; g < G; g += kSimtThreads) {
      const float m_prev = m_s[g];
      float m_cur = minus_inf();
      for (int t = 0; t < P; ++t) m_cur = fmaxf(m_cur, p_s[g * P + t]);
      const float m_new = fmaxf(m_prev, m_cur);
      a_s[g] = expf(m_prev - m_new);
      m_s[g] = m_new;
    }
    __syncthreads();
    for (int i = tid; i < G * P; i += kSimtThreads) {
      const int g = i / P;
      p_s[i] = expf(p_s[i] - m_s[g]);       // masked: exp(-inf) = 0
    }
    __syncthreads();
    for (int g = tid; g < G; g += kSimtThreads) {
      float sum = 0.f;
      for (int t = 0; t < P; ++t) sum += p_s[g * P + t];
      l_s[g] = l_s[g] * a_s[g] + sum;
    }
    for (int i = tid; i < G * dh; i += kSimtThreads) {
      const int g = i / dh, d = i - g * dh;
      const float* pg = p_s + g * P;
      float pv = 0.f;
      for (int t = 0; t < P; ++t) pv = fmaf(pg[t], v_s[t * dh + d], pv);
      acc_s[i] = acc_s[i] * a_s[g] + pv;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * dh; i += kSimtThreads) {
    const int g = i / dh;
    const float l = l_s[g];
    out[q_base + i] = l > 0.f ? acc_s[i] / l : 0.f;
  }
}

size_t simt_smem(int G, int dh, int P) {
  return sizeof(float) * ((size_t)2 * G * dh + (size_t)P * (dh + 1) +
                          (size_t)P * dh + (size_t)G * P + 3 * (size_t)G);
}

// ------------------------------------------------- bf16, tensor cores
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x = x + __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Shared memory of the bf16 path: the K and V rings, the CTA's query rows
// and a ring of kStages + 1 blocks' page slots.  Rows are
// padded to DH + 8 elements.  kernels/paged_attention.py `plan` computes
// the same number; the launcher refuses any other.
size_t mma_smem(int dh, int P, int warps) {
  const size_t lds = dh + 8;
  return 2 * (2 * (size_t)kStages * kBK * lds + (size_t)warps * 16 * lds) +
         4 * (size_t)(kStages + 1) * (kBK / P);
}

// One CTA: KV head kh = blockIdx.y, tokens [t0, t0 + tpc) of one table
// (decode: tpc = 1; prefill: the shared table, row stride 0).  Its query
// rows r = (token, head) = (r / G, r % G), 16 to a warp; a warp with no
// live row only helps to load.  P is a power of two that divides 64.
template <int DH>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_attention_mma(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                    const bf16* __restrict__ v_pool,
                    const int* __restrict__ table,
                    const int* __restrict__ lengths, bf16* __restrict__ out,
                    int rows, int H, int K, int P, int MP,
                    long long table_row_stride, int window, float scale_log2,
                    int tpc) {
  constexpr int LDS = DH + 8;
  constexpr int KT = DH / 16;        // k-steps of Q.K^T
  constexpr int NT = kBK / 8;        // key tiles of S
  constexpr int DT = DH / 8;         // dh tiles of O
  constexpr int CH = DH / 8;         // 16-byte chunks of a row
  const int G = H / K;
  const int kh = blockIdx.y;
  const int t0 = blockIdx.x * tpc;
  const int n_tok = min(tpc, rows - t0);
  const int n_rows = n_tok * G;
  const int nthreads = blockDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rows_pad = (nthreads >> 5) * 16;
  const int ppb = kBK / P;           // pages per block
  const int p_shift = __ffs(P) - 1;  // key -> page within a block
  const unsigned long long page_bits =  // P ones: one page's keys
      P == kBK ? ~0ull : (1ull << P) - 1ull;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kStages * kBK * LDS;
  bf16* sQ = sV + kStages * kBK * LDS;
  int* sSlot = reinterpret_cast<int*>(sQ + rows_pad * LDS);

  const int* trow = table + (long long)t0 * table_row_stride;

  // The CTA's query rows: cp.async, in the first block's group.
  for (int i = threadIdx.x; i < rows_pad * CH; i += nthreads) {
    const int r = i / CH, c = i - r * CH;
    const bf16* src = q;
    int bytes = 0;
    if (r < n_rows) {
      const int t = r / G, g = r - t * G;
      src = q + ((long long)(t0 + t) * H + (long long)kh * G + g) * DH + c * 8;
      bytes = 16;
    }
    cp_async16(sQ + r * LDS + c * 8, src, bytes);
  }
  // The blocks this CTA walks: the union of its rows' reaches, reduced in
  // every warp alike (integer min and max: exact).
  const int n_blk_table = (MP * P + kBK - 1) / kBK;
  int jb0 = INT_MAX, jb1 = -1;
  for (int t = lane; t < n_tok; t += 32) {
    const int len = lengths[t0 + t];
    if (len > 0) {
      const int last = min((len - 1) / kBK, n_blk_table - 1);
      const int first =
          (window > 0 && len > window) ? (len - window) / kBK : 0;
      if (first <= last) {
        jb0 = min(jb0, first);
        jb1 = max(jb1, last);
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    jb0 = min(jb0, __shfl_xor_sync(0xffffffffu, jb0, o));
    jb1 = max(jb1, __shfl_xor_sync(0xffffffffu, jb1, o));
  }
  if (jb1 < 0) jb0 = 0;               // no block: the loop below is empty

  // Block j's page slots (-1: not loaded) into entry j % (kStages + 1) of
  // the slot ring, read from the table one block before the block's loads
  // are issued, so no load waits on a table read.
  auto read_slots = [&](int j) {
    for (int pp = threadIdx.x; pp < ppb; pp += nthreads) {
      const int page = j * ppb + pp;
      sSlot[(j % (kStages + 1)) * ppb + pp] = page < MP ? trow[page] : -1;
    }
  };
  // Brings block j into ring stage `stage`; pages that are not there are
  // zero-filled.
  auto issue = [&](int j, int stage) {
    const int* slots = sSlot + (j % (kStages + 1)) * ppb;
    bf16* dK = sK + stage * kBK * LDS;
    bf16* dV = sV + stage * kBK * LDS;
    for (int i = threadIdx.x; i < kBK * CH; i += nthreads) {
      const int key = i / CH, c = i - key * CH;
      const int slot = slots[key >> p_shift];
      const bf16* srcK = k_pool;
      const bf16* srcV = v_pool;
      int bytes = 0;
      if (slot >= 0) {
        const long long off =
            (((long long)slot * P + (key & (P - 1))) * K + kh) * DH + c * 8;
        srcK = k_pool + off;
        srcV = v_pool + off;
        bytes = 16;
      }
      cp_async16(dK + key * LDS + c * 8, srcK, bytes);
      cp_async16(dV + key * LDS + c * 8, srcV, bytes);
    }
  };

  const bool live = warp * 16 < n_rows;
  uint32_t qa[KT][4];                // this warp's rows as A fragments
  // The two rows this lane holds: r_lo (c0, c1) and r_lo + 8 (c2, c3).
  const int r_lo = warp * 16 + (lane >> 2);
  const int len_lo = r_lo < n_rows ? lengths[t0 + r_lo / G] : 0;
  const int len_hi = r_lo + 8 < n_rows ? lengths[t0 + (r_lo + 8) / G] : 0;

  float m_lo = minus_inf(), m_hi = minus_inf(), l_lo = 0.f, l_hi = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = jb0; j <= min(jb1, jb0 + kStages - 1); ++j) read_slots(j);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (jb0 + s <= jb1) issue(jb0 + s, s);
    cp_async_commit();
  }
  for (int j = jb0; j <= jb1; ++j) {
    const int it = j - jb0;
    cp_async_wait<kStages - 2>();
    __syncthreads();                 // block j landed; block j-1 consumed
    if (j + kStages - 1 <= jb1)
      issue(j + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    if (j + kStages <= jb1) read_slots(j + kStages);   // block j-1's entry
    if (!live) continue;
    if (it == 0) {                   // the query rows landed with block jb0
      const bf16* qrow =
          sQ + (warp * 16 + (lane & 15)) * LDS + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < KT; ++ks) ldmatrix_x4(qa[ks], qrow + ks * 16);
    }
    const int stage = it % kStages;
    const bf16* cK = sK + stage * kBK * LDS;
    const bf16* cV = sV + stage * kBK * LDS;
    const int* slots = sSlot + (j % (kStages + 1)) * ppb;

    // S = Q.K^T over this block's 64 keys.
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KT; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, cK + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * LDS +
                           ks * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qa[ks], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qa[ks], b[2], b[3]);
      }
    }
    // Scale, mask (a select to -inf), block max.  Key col of the block is
    // valid for a row when its page is loaded, col < length - base and,
    // with a window, col >= length - window - base.
    const int base = j * kBK;
    unsigned long long loaded = 0ull;
    for (int pp = 0; pp < ppb; ++pp)
      if (slots[pp] >= 0) loaded |= page_bits << (pp * P);
    const int end_lo = len_lo - base, end_hi = len_hi - base;
    const int beg_lo = window > 0 ? end_lo - window : INT_MIN;
    const int beg_hi = window > 0 ? end_hi - window : INT_MIN;
    float mc_lo = minus_inf(), mc_hi = minus_inf();
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + (lane & 3) * 2 + (e & 1);
        const bool valid = ((loaded >> col) & 1ull) &&
                           col < (e < 2 ? end_lo : end_hi) &&
                           col >= (e < 2 ? beg_lo : beg_hi);
        s[n][e] = valid ? s[n][e] * scale_log2 : minus_inf();
        if (e < 2) mc_lo = fmaxf(mc_lo, s[n][e]);
        else mc_hi = fmaxf(mc_hi, s[n][e]);
      }
    }
    mc_lo = quad_max(mc_lo);
    mc_hi = quad_max(mc_hi);
    const float mn_lo = fmaxf(m_lo, mc_lo), mn_hi = fmaxf(m_hi, mc_hi);
    const float mu_lo = mn_lo == minus_inf() ? 0.f : mn_lo;
    const float mu_hi = mn_hi == minus_inf() ? 0.f : mn_hi;
    const float al_lo = exp2f(m_lo - mu_lo), al_hi = exp2f(m_hi - mu_hi);
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mu_lo);      // masked: exp2(-inf) = 0
      s[n][1] = exp2f(s[n][1] - mu_lo);
      s[n][2] = exp2f(s[n][2] - mu_hi);
      s[n][3] = exp2f(s[n][3] - mu_hi);
      rs_lo += s[n][0];
      rs_lo += s[n][1];
      rs_hi += s[n][2];
      rs_hi += s[n][3];
    }
    rs_lo = quad_sum(rs_lo);
    rs_hi = quad_sum(rs_hi);
    l_lo = fmaf(l_lo, al_lo, rs_lo);
    l_hi = fmaf(l_hi, al_hi, rs_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // P (bf16) as A fragments, then O = acc * alpha + P.V per 16 columns.
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < DH / 16; ++dp) {
      float pv0[4] = {0.f, 0.f, 0.f, 0.f}, pv1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, cV + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                   (lane & 7)) * LDS +
                                 dp * 16 + (lane >> 4) * 8);
        mma_bf16(pv0, pa[kk], b[0], b[1]);
        mma_bf16(pv1, pa[kk], b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float al = e < 2 ? al_lo : al_hi;
        acc[2 * dp][e] = fmaf(acc[2 * dp][e], al, pv0[e]);
        acc[2 * dp + 1][e] = fmaf(acc[2 * dp + 1][e], al, pv1[e]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // every copy into sQ has landed
  if (!live) return;

  // Normalise into this warp's own rows of sQ, then 16-byte stores.
  __syncwarp();
  bf16* sO = sQ + warp * 16 * LDS;
#pragma unroll
  for (int n = 0; n < DT; ++n) {
    const int col = n * 8 + (lane & 3) * 2;
    const float o0 = l_lo > 0.f ? acc[n][0] / l_lo : 0.f;
    const float o1 = l_lo > 0.f ? acc[n][1] / l_lo : 0.f;
    const float o2 = l_hi > 0.f ? acc[n][2] / l_hi : 0.f;
    const float o3 = l_hi > 0.f ? acc[n][3] / l_hi : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(sO + (lane >> 2) * LDS + col) =
        __floats2bfloat162_rn(o0, o1);
    *reinterpret_cast<__nv_bfloat162*>(sO + ((lane >> 2) + 8) * LDS + col) =
        __floats2bfloat162_rn(o2, o3);
  }
  __syncwarp();
  for (int i = lane; i < 16 * CH; i += 32) {
    const int rr = i / CH, c = i - rr * CH;
    const int r = warp * 16 + rr;
    if (r < n_rows) {
      const int t = r / G, g = r - t * G;
      *reinterpret_cast<uint4*>(
          out + ((long long)(t0 + t) * H + (long long)kh * G + g) * DH +
          c * 8) = *reinterpret_cast<const uint4*>(sO + rr * LDS + c * 8);
    }
  }
}

template <int DH>
cudaError_t launch_mma(const void* q, const void* k_pool, const void* v_pool,
                       const int* table, const int* lengths, void* out,
                       int rows, int H, int K, int P, int MP,
                       long long table_row_stride, int window, float scale,
                       int tpc, int warps, size_t smem, cudaStream_t stream) {
  static bool opted_in = false;      // the 227 KB ceiling, set once
  if (!opted_in) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_mma<DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, 227 * 1024);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const float log2e = 1.4426950408889634f;
  dim3 grid((rows + tpc - 1) / tpc, K);
  paged_attention_mma<DH><<<grid, warps * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), table, lengths,
      static_cast<bf16*>(out), rows, H, K, P, MP, table_row_stride, window,
      scale * log2e, tpc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The shapes and the plan of one call, every field 8 bytes wide
// (kernels/paged_attention.py `_Args` mirrors it): dtype 0 = float32
// (SIMT), 1 = bfloat16 (tensor cores); window <= 0 means no window;
// tokens_per_cta, warps and smem_bytes come from the wrapper's plan, and a
// plan whose shared memory is not what this file reckons is refused.
struct PagedArgs {
  long long rows, H, K, dh, P, MP, table_row_stride, window, dtype,
      tokens_per_cta, warps, smem_bytes;
  double scale;
};

// Returns cudaGetLastError() after the launch (0 = launched).
int paged_attention_launch(const void* q, const void* k_pool,
                           const void* v_pool, const void* table,
                           const void* lengths, void* out,
                           const PagedArgs* a, void* stream) {
  const int rows = (int)a->rows, H = (int)a->H, K = (int)a->K,
            dh = (int)a->dh, P = (int)a->P, MP = (int)a->MP,
            window = (int)a->window, tpc = (int)a->tokens_per_cta,
            warps = (int)a->warps;
  const long long stride = a->table_row_stride;
  const float scale = (float)a->scale;
  if (rows == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(table);
  const int* l = static_cast<const int*>(lengths);
  const size_t smem = (size_t)a->smem_bytes;
  if (a->dtype == 0) {
    if (smem != simt_smem(H / K, dh, P)) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          paged_attention_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    dim3 grid(rows, K);
    paged_attention_simt<<<grid, kSimtThreads, smem, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), t, l, static_cast<float*>(out), H,
        K, dh, P, MP, stride, window, scale);
    return (int)cudaGetLastError();
  }
  if (a->dtype != 1 || P <= 0 || kBK % P != 0 || warps < 1 ||
      warps > kMaxWarps || tpc < 1 || tpc * (H / K) > warps * 16 ||
      (tpc > 1 && stride != 0) || smem != mma_smem(dh, P, warps))
    return (int)cudaErrorInvalidValue;
#define PA_CASE(D)                                                         \
  case D:                                                                  \
    return (int)launch_mma<D>(q, k_pool, v_pool, t, l, out, rows, H, K, P, \
                              MP, stride, window, scale, tpc, warps, smem, \
                              s);
  switch (dh) {
    PA_CASE(16)
    PA_CASE(32)
    PA_CASE(48)
    PA_CASE(64)
    PA_CASE(80)
    PA_CASE(96)
    PA_CASE(112)
    PA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef PA_CASE
}

}  // extern "C"
