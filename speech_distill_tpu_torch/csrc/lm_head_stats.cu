// Fused lm-head statistics (K2-stats, K2-dh, K2-dw) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels speech_distill_tpu/ops/pallas_lm_loss.py
// `_stats_kernel`, `_dh_kernel` and `_dw_kernel` (lm_head_stats and its
// custom VJP). Inputs: h [N, D] and W [V, D] in bf16, int32 labels [N]
// (a label outside [0, V) never hits). With z = h W^T (fp32 sums):
//   lm_head_stats: lse1 = logsumexp(z), lseT = logsumexp(z / T) and
//                  label_logit = z[label] (-1e30 when it never hits), fp32
//   lm_head_dh:    dh = dl W     -> bf16 [N, D]
//   lm_head_dw:    dW = dl^T h   -> bf16 [V, D], every row
// where dl = a1 exp(z - lse1) + (aT / T) exp(z / T - lseT) + b [c == label]
// is rounded to bf16 before the product, as the TPU kernels round it, and
// dh and dW are fp32 sums over the whole contraction rounded once.
//
// What bounds them on the card: tensor-core operations. At N 16,380,
// V 159,488, D 1024 the statistics are 2 N V D = 5.35 TFLOP and dh and dW
// 4 N V D each (the logits are recomputed), against ~0.4 GB of operands.
//   * stats: z = h W^T as 128 x 256 tiles on the dl kernel's mainloop
//     (below), the online logsumexp at T = 1 and at T and the label logit
//     in registers (the tile's fp32 logits never leave them), the running
//     statistics of a row carried across the vocab tiles of a unit: 128
//     rows of h and one vocab split, the tiles walked in order. The plan
//     (ops/pallas_lm_loss._stats_plan) picks the splits that balance the
//     persistent grid over the SMs; the splits merge in a small combine
//     pass (lm_head_combine_kernel) in split order. The [N, V] logits
//     never reach memory.
//   * dh and dW: two wgmma GEMMs a vocab chunk with dl in device memory
//     between them, one bf16 chunk at a time. A fully fused kernel does not
//     fit at D 1024: a 64-row accumulator over all of D is 64 x 1024 fp32,
//     the whole register file of an SM, and 128 resident rows of bf16
//     operand are 256 KB, more than a block's 227 KB of shared memory; it
//     would recompute the logits once for each slice of D or sum partial
//     logits across a cluster every tile. So for each chunk of `chunk`
//     vocab columns (8,192 at N 16,380: a 268 MB dl chunk; 0.31 GiB of
//     scratch for dh with its fp32 partial, 0.25 GiB for dW):
//       1. lm_head_dl_kernel: z = h W_c^T as 128 x 256 tiles (wgmma
//          m64n256k16, h and W both K-major), dl formed in registers with
//          the rows' lse, cotangents and label read once a tile and exp2
//          with log2(e) folded in, 0 at rows >= N and columns >= V,
//          rounded to bf16 and stored transposed, dl^T [chunk, ld], ld = N
//          rounded up to 128, through swizzled shared memory with 16-byte
//          writes;
//       2. lm_head_gemm_kernel: C = A B with B MN-major (W_c for dh, h for
//          dW) and A the dl chunk, 128 x min(D, 256) tiles. dW (M = chunk
//          rows, K = ld tokens) reads dl^T K-major and writes its rows
//          once in bf16; dh (M = N, K = chunk) reads it MN-major (wgmma's
//          transpose bit), adds the previous chunks' fp32 partial [N, D]
//          and rounds the last chunk to bf16: no atomics and a fixed chunk
//          order, so the result is bitwise repeatable.
//     The work is the TPU design's 4 N V D a backward; the extra traffic
//     is the dl chunk written once and read once or more (D / 256 column
//     tiles) from L2, and dh's partial, about 10 GB for dh or dW at
//     N 16,380.
// All three GEMM kernels (stats, dl, GEMM): 384 threads, two 64-row
// consumer warpgroups with fp32 accumulators in registers and a producer
// warpgroup (setmaxnreg 24 / 240) whose one thread streams 64-deep stages
// through a ring of TMA loads (128-byte swizzle, zeros past N or V)
// completed on mbarriers; persistent blocks (one an SM), the producer
// running ahead across tiles and units.
// Masking: columns >= V and rows >= N get no contribution (the TPU kernels
// mask padded columns with -1e30 and pad rows with label -1 and zero
// cotangents; the results are the same). Shared memory: stats 193 KB, dl
// 209 KB, the GEMM 193 KB at D >= 256; one block an SM.
#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// K2-dh and K2-dW
// ---------------------------------------------------------------------------

constexpr int kTileM = kConsumers * kBQ;   // rows of a tile: 128
constexpr int kTileV = 256;                // vocab columns of a dl tile
constexpr int kStagesDl = 3;               // 48 KB stages + 64 KB staging
constexpr int kStagesGemm = 4;             // 48 KB stages at BN 256

// byte offsets in shared memory from a 1024-aligned base
struct DlSmem {
  static constexpr uint32_t a_bytes = kTileM * 128;  // 128 rows x 64 of h
  static constexpr uint32_t b_bytes = kTileV * 128;  // 256 rows x 64 of W
  static constexpr uint32_t stage = a_bytes + b_bytes;
  static constexpr uint32_t out_wg = kBQ * kTileV * 2;  // a warpgroup's dl
  static constexpr uint32_t out = kStagesDl * stage;
  // mbarriers: full, then empty, a stage
  static constexpr uint32_t bar = out + kConsumers * out_wg;
  static constexpr uint32_t bytes = bar + 16 * kStagesDl + 1024;
};

template <int BN>
struct GemmSmem {
  static constexpr uint32_t a_bytes = kTileM * 128;  // 128 x 64 of A
  static constexpr uint32_t b_bytes = kBox * BN * 2;  // 64 rows x BN of B
  static constexpr uint32_t stage = a_bytes + b_bytes;
  static constexpr uint32_t bar = kStagesGemm * stage;
  static constexpr uint32_t bytes = bar + 16 * kStagesGemm + 1024;
};

// the ring of a kernel's shared memory, barriers at `bar`
__device__ __forceinline__ Ring make_ring(uint32_t base, uint32_t stage,
                                          uint32_t bar, int stages) {
  return Ring{base, stage, base + bar, base + bar + 8 * stages, stages};
}

// ---------------------------------------------------------------------------
// K2-stats
// ---------------------------------------------------------------------------

constexpr int kStagesStats = 4;            // 48 KB stages

struct StatsSmem {
  static constexpr uint32_t a_bytes = kTileM * 128;  // 128 rows x 64 of h
  static constexpr uint32_t b_bytes = kTileV * 128;  // 256 rows x 64 of W
  static constexpr uint32_t stage = a_bytes + b_bytes;
  static constexpr uint32_t bar = kStagesStats * stage;
  static constexpr uint32_t bytes = bar + 16 * kStagesStats + 1024;
};

struct StatsArgs {
  const int* labels;
  float* part;     // [splits, 5, N]: m, s at T = 1, m / T, s at T, label
  int N, V, D;
  int splits;      // vocab splits
  int per;         // vocab tiles a split (the last may have fewer)
  float t;         // the temperature T
  float log2e_t;   // log2(e) / T
};

// The work of a block: units u = blockIdx.x, blockIdx.x + gridDim.x, ...
// of n_rt * splits, split-major (u = split * n_rt + row tile), so that
// the blocks running together sweep the same W tiles and share them in
// L2; a unit is the vocab tiles [split * per, min(n_vt, (split + 1) per))
// of 128 rows of h, walked in order.
struct StatsUnit {
  int rt, split, vt0, vt1;
};

__device__ __forceinline__ StatsUnit stats_unit(const StatsArgs& p, int u) {
  const int n_rt = (p.N + kTileM - 1) / kTileM;
  const int n_vt = (p.V + kTileV - 1) / kTileV;
  StatsUnit w;
  w.rt = u % n_rt;
  w.split = u / n_rt;
  w.vt0 = w.split * p.per;
  w.vt1 = min(n_vt, w.vt0 + p.per);
  return w;
}

// (lse1, lseT, label logit) partials of every unit: z = h W^T as 128 x 256
// tiles (the dl kernel's mainloop: two 64-row consumer warpgroups, K = D in
// 64-deep TMA stages), then an online logsumexp in registers. Thread t of
// a warpgroup holds rows r_a and r_a + 8 and 64 of the tile's columns; a
// row's four threads share its running max m (the tile max, reduced over
// the four lanes by shuffles) and each keeps its own sums of exp2 at
// T = 1 and at T, with log2(e) (and log2(e) / T) folded into one fmaf; the
// label logit is kept by a compare. Columns >= V (zeros from TMA) are set
// to -1e30 before the max and the sums; rows >= N are not written. At a
// unit's end the four lanes' sums are added and the five partials stored.
__global__ void __launch_bounds__(kThreadsWs, 1) lm_head_stats_kernel(
    const __grid_constant__ CUtensorMap tm_h,
    const __grid_constant__ CUtensorMap tm_w, const StatsArgs p) {
  using L = StatsSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring ring = make_ring(base, L::stage, L::bar, kStagesStats);
  const int n_units = (p.N + kTileM - 1) / kTileM * p.splits;
  const int n_k = p.D / kBox;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      uint32_t it = 0;
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        const StatsUnit w = stats_unit(p, u);
        for (int vt = w.vt0; vt < w.vt1; ++vt)
          for (int ks = 0; ks < n_k; ++ks, ++it) {
            const uint32_t full = ring.acquire(it, L::stage);
            const uint32_t s = ring.stage(it);
            tma_load_2d(s, &tm_h, ks * kBox, w.rt * kTileM, full);
            tma_load_2d(s + L::a_bytes, &tm_w, ks * kBox, vt * kTileV, full);
          }
      }
    }
  } else {
    // consumer warpgroup: 64 rows of each tile
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_a = (t / 32) * 16 + lane / 4;  // rows r_a and r_a + 8
    const int c_a = 2 * (lane % 4);            // columns 8 j + c_a (+ 1)
    float acc[kTileV / 2];
#pragma unroll
    for (int i = 0; i < kTileV / 2; ++i) acc[i] = 0.f;
    uint32_t it = 0;
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const StatsUnit w = stats_unit(p, u);
      const int row0 = w.rt * kTileM + wg * kBQ + r_a;
      float m[2], s1[2], st[2], lab[2];
      int label[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        label[r] = row < p.N ? p.labels[row] : -1;
        m[r] = kNegInf;
        s1[r] = st[r] = 0.f;
        lab[r] = kNegInf;
      }
      for (int vt = w.vt0; vt < w.vt1; ++vt) {
        mainloop<kTileV, false, false>(acc, ring, it, n_k, wg * kBQ * 128,
                                       L::a_bytes, lane);
        const int v0 = vt * kTileV;
        const int n_valid = p.V - v0;   // columns < V in the tile
        if (n_valid < kTileV) {
#pragma unroll
          for (int j = 0; j < kTileV / 8; ++j)
#pragma unroll
            for (int x = 0; x < 4; ++x)
              if (8 * j + c_a + (x & 1) >= n_valid) acc[4 * j + x] = kNegInf;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tmax = kNegInf;
#pragma unroll
          for (int j = 0; j < kTileV / 8; ++j)
            tmax = fmaxf(tmax, fmaxf(acc[4 * j + 2 * r],
                                     acc[4 * j + 2 * r + 1]));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float mn = fmaxf(m[r], tmax);
          s1[r] *= fast_exp2((m[r] - mn) * kLog2e);
          st[r] *= fast_exp2((m[r] - mn) * p.log2e_t);
          m[r] = mn;
          const float b1 = mn * kLog2e, bt = mn * p.log2e_t;
          float a1 = 0.f, at = 0.f;
#pragma unroll
          for (int j = 0; j < kTileV / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float z = acc[4 * j + 2 * r + e];
              a1 += fast_exp2(fmaf(z, kLog2e, -b1));
              at += fast_exp2(fmaf(z, p.log2e_t, -bt));
            }
          s1[r] += a1;
          st[r] += at;
          const int lc = label[r] - v0;
          if (lc >= 0 && lc < n_valid && (lc & 6) == c_a) {
#pragma unroll
            for (int j = 0; j < kTileV / 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (8 * j + c_a + e == lc) lab[r] = acc[4 * j + 2 * r + e];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int x = 1; x <= 2; x *= 2) {
          s1[r] += __shfl_xor_sync(0xffffffffu, s1[r], x);
          st[r] += __shfl_xor_sync(0xffffffffu, st[r], x);
          lab[r] = fmaxf(lab[r], __shfl_xor_sync(0xffffffffu, lab[r], x));
        }
        const int row = row0 + 8 * r;
        if (lane % 4 == 0 && row < p.N) {
          float* q = p.part + (size_t)w.split * 5 * p.N + row;
          q[0] = m[r];
          q[(size_t)p.N] = s1[r];
          q[(size_t)2 * p.N] = m[r] / p.t;
          q[(size_t)3 * p.N] = st[r];
          q[(size_t)4 * p.N] = lab[r];
        }
      }
    }
  }
}

// merge the vocab splits of each row into (lse1, lseT, label_logit)
__global__ void lm_head_combine_kernel(const float* __restrict__ part,
                                       float* __restrict__ lse1,
                                       float* __restrict__ lset,
                                       float* __restrict__ lab, int N,
                                       int splits) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float m1 = kNegInf, s1 = 0.f, mt = kNegInf, st = 0.f, lb = kNegInf;
  for (int k = 0; k < splits; ++k) {
    const float* p = part + (size_t)k * 5 * N + n;
    const float pm1 = p[0], pmt = p[(size_t)2 * N];
    const float m = fmaxf(m1, pm1);
    s1 = s1 * expf(m1 - m) + p[(size_t)N] * expf(pm1 - m);
    m1 = m;
    const float mm = fmaxf(mt, pmt);
    st = st * expf(mt - mm) + p[(size_t)3 * N] * expf(pmt - mm);
    mt = mm;
    lb = fmaxf(lb, p[(size_t)4 * N]);
  }
  lse1[n] = m1 + logf(fmaxf(s1, 1e-30f));
  lset[n] = mt + logf(fmaxf(st, 1e-30f));
  lab[n] = lb;
}

struct DlArgs {
  const int* labels;
  const float *lse1, *lset, *a1, *at, *b;
  bf16* dl;
  int N, V, D;
  int c0, vc;      // the chunk's first vocab column and width (% kTileV)
  int ld;          // elements between rows of dl
  float log2e_t;   // log2(e) / T
  float inv_t;     // 1 / T
};

// dl[R][C] of the warpgroup's 64 x 256 tile as bf16 into its staging tile
// transposed: staging row C (128 bytes, swizzled) holds the tile's column C
__device__ __forceinline__ void stage_dl(unsigned char* tile, int R, int C,
                                         float d) {
  *reinterpret_cast<bf16*>(tile + C * 128 + (((R / 8) ^ (C & 7)) * 16) +
                           (R % 8) * 2) = __float2bfloat16(d);
}

// dl for the vocab chunk [c0, c0 + vc): z = h W^T over 128 x 256 tiles
// (two 64-row consumer warpgroups, K = D in 64-deep TMA stages), then
// dl = a1 exp(z - lse1) + (aT / T) exp(z / T - lseT) + b [col == label]
// in registers, 0 at rows >= N and columns >= V, rounded to bf16 and
// stored transposed, dl^T [vc, ld]: every row < vc and column < ld is
// written. Persistent: block b takes tiles b, b + gridDim.x, ...; the
// producer runs ahead across tiles.
__global__ void __launch_bounds__(kThreadsWs, 1) lm_head_dl_kernel(
    const __grid_constant__ CUtensorMap tm_h,
    const __grid_constant__ CUtensorMap tm_w, const DlArgs p) {
  using L = DlSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const Ring ring = make_ring(base, L::stage, L::bar, kStagesDl);
  const int n_n = p.vc / kTileV;
  const int n_tiles = (p.N + kTileM - 1) / kTileM * n_n;
  const int n_k = p.D / kBox;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / n_n * kTileM;
        const int v0 = p.c0 + tile % n_n * kTileV;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const uint32_t full = ring.acquire(it, L::stage);
          const uint32_t s = ring.stage(it);
          tma_load_2d(s, &tm_h, ks * kBox, m0, full);
          tma_load_2d(s + L::a_bytes, &tm_w, ks * kBox, v0, full);
        }
      }
    }
  } else {
    // consumer warpgroup: 64 rows of each tile
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_a = (t / 32) * 16 + lane / 4;  // rows r_a and r_a + 8
    unsigned char* out_s = smem + L::out + wg * L::out_wg;
    float acc[kTileV / 2];
#pragma unroll
    for (int i = 0; i < kTileV / 2; ++i) acc[i] = 0.f;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / n_n * kTileM + wg * kBQ;
      const int n0 = tile % n_n * kTileV;      // column in the chunk
      mainloop<kTileV, false, false>(acc, ring, it, n_k, wg * kBQ * 128,
                                     L::a_bytes, lane);
      // the rows' terms, once a tile; rows >= N (zero h) get 0
      float m1[2], mt[2], c1[2], ct[2], cb[2];
      int lab[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + r_a + 8 * r;
        const bool ok = row < p.N;
        m1[r] = ok ? p.lse1[row] * kLog2e : 0.f;
        mt[r] = ok ? p.lset[row] * kLog2e : 0.f;
        c1[r] = ok ? p.a1[row] : 0.f;
        ct[r] = ok ? p.at[row] * p.inv_t : 0.f;
        cb[r] = ok ? p.b[row] : 0.f;
        lab[r] = ok ? p.labels[row] - (p.c0 + n0) : -1;
      }
      const int n_valid = p.V - (p.c0 + n0);   // columns < V in the tile
      // the staging tile is free once every thread has stored the last one
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
#pragma unroll
      for (int j = 0; j < kTileV / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float z = acc[4 * j + 2 * r + e];
            const float v = c1[r] * fast_exp2(fmaf(z, kLog2e, -m1[r])) +
                            ct[r] * fast_exp2(fmaf(z, p.log2e_t, -mt[r])) +
                            (col + e == lab[r] ? cb[r] : 0.f);
            stage_dl(out_s, r_a + 8 * r, col + e, col + e < n_valid ? v : 0.f);
          }
        }
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      // staging row c (64 tokens, 128 bytes) to dl^T row n0 + c
      bf16* out = p.dl + (size_t)n0 * p.ld + m0;
      for (int idx = t; idx < kTileV * 8; idx += 128) {
        const int c = idx / 8;
        const int u = idx % 8;
        *reinterpret_cast<uint4*>(out + (size_t)c * p.ld + u * 8) =
            *reinterpret_cast<const uint4*>(out_s + c * 128 +
                                            ((u ^ (c & 7)) * 16));
      }
    }
  }
}

struct GemmArgs {
  const float* prev;  // fp32 partial [m_valid, D] to add, or null
  float* part;        // fp32 partial to write (when out is null)
  bf16* out;          // bf16 result [m_valid, D], or null
  int M, m_valid, K, D;
  int b_row0;         // B's first row
};

// C[M, D] = A[M, K] B[K, D] (+ prev) with A a dl^T chunk [vc, ld]: for dW
// A = dl^T read K-major (M = vc vocab rows, K = ld tokens), for dh
// (kAMN) A = dl read MN-major (M = N tokens, K = vc); B MN-major (h for
// dW, W's chunk rows for dh). Both through TMA (zeros past their rows)
// into a 4-stage ring; 128 x BN output tiles, BN = min(D, 256), two
// 64-row consumer warpgroups with fp32 accumulators in registers. Rows
// >= m_valid are not written. Persistent, as lm_head_dl_kernel.
template <int BN, bool kAMN>
__global__ void __launch_bounds__(kThreadsWs, 1) lm_head_gemm_kernel(
    const __grid_constant__ CUtensorMap tm_a,
    const __grid_constant__ CUtensorMap tm_b, const GemmArgs p) {
  using L = GemmSmem<BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const Ring ring = make_ring(base, L::stage, L::bar, kStagesGemm);
  const int n_n = p.D / BN;
  const int n_tiles = (p.M + kTileM - 1) / kTileM * n_n;
  const int n_k = p.K / kBox;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / n_n * kTileM;
        const int d0 = tile % n_n * BN;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const uint32_t full = ring.acquire(it, L::stage);
          const uint32_t s = ring.stage(it);
          if constexpr (kAMN)   // two boxes of 64 tokens x 64 vocab rows
            for (int x = 0; x < kConsumers; ++x)
              tma_load_2d(s + x * kBQ * 128, &tm_a, m0 + x * kBQ,
                          ks * kBox, full);
          else
            tma_load_2d(s, &tm_a, ks * kBox, m0, full);
          for (int x = 0; x < BN / kBox; ++x)
            tma_load_2d(s + L::a_bytes + x * kBox * 128, &tm_b,
                        d0 + x * kBox, p.b_row0 + ks * kBox, full);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_a = (t / 32) * 16 + lane / 4;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int m0 = tile / n_n * kTileM + wg * kBQ;
      const int d0 = tile % n_n * BN;
      mainloop<BN, kAMN, true>(acc, ring, it, n_k, wg * kBQ * 128,
                               L::a_bytes, lane);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = m0 + r_a + 8 * r;
          if (row >= p.m_valid) continue;
          const size_t idx =
              (size_t)row * p.D + d0 + 8 * j + 2 * (lane % 4);
          float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
          if (p.prev != nullptr) {
            const float2 q = *reinterpret_cast<const float2*>(p.prev + idx);
            v0 += q.x;
            v1 += q.y;
          }
          if (p.out != nullptr)
            *reinterpret_cast<uint32_t*>(p.out + idx) = pack_bf16(v0, v1);
          else
            *reinterpret_cast<float2*>(p.part + idx) = make_float2(v0, v1);
        }
    }
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

int sm_count() {
  static const int n = [] {
    int dev = 0, v = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    return v > 0 ? v : 1;
  }();
  return n;
}

cudaError_t launch_dl(const CUtensorMap& tm_h, const CUtensorMap& tm_w,
                      const DlArgs& p, cudaStream_t stream) {
  static const cudaError_t attr =
      allow_smem(lm_head_dl_kernel, DlSmem::bytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (p.N + kTileM - 1) / kTileM * (p.vc / kTileV);
  lm_head_dl_kernel<<<std::min(tiles, sm_count()), kThreadsWs, DlSmem::bytes,
                      stream>>>(tm_h, tm_w, p);
  return cudaGetLastError();
}

template <int BN, bool kAMN>
cudaError_t launch_gemm(const CUtensorMap& tm_a, const CUtensorMap& tm_b,
                        const GemmArgs& p, cudaStream_t stream) {
  static const cudaError_t attr =
      allow_smem(lm_head_gemm_kernel<BN, kAMN>, GemmSmem<BN>::bytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (p.M + kTileM - 1) / kTileM * (p.D / BN);
  lm_head_gemm_kernel<BN, kAMN><<<std::min(tiles, sm_count()), kThreadsWs,
                                  GemmSmem<BN>::bytes, stream>>>(tm_a, tm_b,
                                                                 p);
  return cudaGetLastError();
}

// dh (kDh) or dW over vocab chunks of `chunk` columns: per chunk the dl
// kernel into dl^T [chunk, ld], then the GEMM. dh: C = dl W_c accumulated
// in the fp32 `part` [N, D] over the chunks in order, the last rounded to
// bf16 into `out`. dW: C = dl^T h written as bf16 rows c0 .. of `out`.
template <int BN, bool kDh>
cudaError_t run_bwd(const void* h, const void* w, DlArgs p, void* out,
                    float* part, int chunk, cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const int N = p.N, V = p.V, D = p.D;
  CUtensorMap tm_h, tm_w, tm_b;   // h and W K-major, B MN-major
  if (!make_bf16_map(encode, &tm_h, h, D, N, D, kTileM) ||
      !make_bf16_map(encode, &tm_w, w, D, V, D, kTileV) ||
      !make_bf16_map(encode, &tm_b, kDh ? w : h, D, kDh ? V : N, D, kBox))
    return cudaErrorInvalidValue;
  const int n_chunks = (V + chunk - 1) / chunk;
  for (int i = 0; i < n_chunks; ++i) {
    p.c0 = i * chunk;
    p.vc = std::min(chunk, (V - p.c0 + kTileV - 1) / kTileV * kTileV);
    // dl^T [vc, ld]: boxes of 64 tokens x 64 vocab rows (dh, MN-major A)
    // or 64 tokens x 128 vocab rows (dW, K-major A)
    CUtensorMap tm_a;
    if (!make_bf16_map(encode, &tm_a, p.dl, p.ld, p.vc, p.ld,
                       kDh ? kBox : kTileM))
      return cudaErrorInvalidValue;
    const bool last = i + 1 == n_chunks;
    const GemmArgs g =
        kDh ? GemmArgs{i > 0 ? part : nullptr, last ? nullptr : part,
                       last ? static_cast<bf16*>(out) : nullptr, N, N, p.vc,
                       D, p.c0}
            : GemmArgs{nullptr, nullptr,
                       static_cast<bf16*>(out) + (size_t)p.c0 * D, p.vc,
                       std::min(p.vc, V - p.c0), p.ld, D, 0};
    cudaError_t e = launch_dl(tm_h, tm_w, p, stream);
    if (e != cudaSuccess) return e;
    e = launch_gemm<BN, kDh>(tm_a, tm_b, g, stream);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <bool kDh>
int bwd_entry(const void* h, const void* w, const void* labels,
              const void* lse1, const void* lset, const void* a1,
              const void* at, const void* b, void* out, void* dl,
              void* part, int N, int V, int D, int chunk, int ld, float t,
              void* stream) {
  const bool dims_ok = D == 64 || D == 128 || D == 256 || D == 512 ||
                       D == 1024;
  const bool multi = V > chunk;
  if (N <= 0 || V <= 0 || !dims_ok || chunk <= 0 || chunk % kTileV != 0 ||
      ld < N || ld % kTileM != 0 || dl == nullptr ||
      (kDh && multi && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const DlArgs p{static_cast<const int*>(labels),
                 static_cast<const float*>(lse1),
                 static_cast<const float*>(lset),
                 static_cast<const float*>(a1),
                 static_cast<const float*>(at),
                 static_cast<const float*>(b),
                 static_cast<bf16*>(dl), N, V, D, 0, 0, ld, kLog2e / t,
                 1.f / t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(part);
  if (D == 64) return (int)run_bwd<64, kDh>(h, w, p, out, pf, chunk, s);
  if (D == 128) return (int)run_bwd<128, kDh>(h, w, p, out, pf, chunk, s);
  return (int)run_bwd<256, kDh>(h, w, p, out, pf, chunk, s);
}

}  // namespace

// bf16 h [N, D], W [V, D], int32 labels [N]; D in {64, 128, 256, 512,
// 1024}. `part` is fp32 scratch [splits, 5, N]; every split holds at
// least one of the ceil(V / 256) vocab tiles (per = ceil(n_vt / splits)).
// Writes fp32 lse1, lseT and label_logit [N]. Launches the stats kernel
// (persistent, min(units, SMs) blocks) and the combine pass. Returns
// cudaGetLastError() after the launches.
extern "C" int lm_head_stats(const void* h, const void* w, const void* labels,
                             void* part, void* lse1, void* lset, void* lab,
                             int N, int V, int D, int splits, float t,
                             void* stream) {
  const bool dims_ok = D == 64 || D == 128 || D == 256 || D == 512 ||
                       D == 1024;
  const int n_vt = (V + kTileV - 1) / kTileV;
  if (N <= 0 || V <= 0 || !dims_ok || splits < 1 || splits > n_vt)
    return (int)cudaErrorInvalidValue;
  const int per = (n_vt + splits - 1) / splits;
  if ((splits - 1) * per >= n_vt) return (int)cudaErrorInvalidValue;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap tm_h, tm_w;   // both K-major
  if (!make_bf16_map(encode, &tm_h, h, D, N, D, kTileM) ||
      !make_bf16_map(encode, &tm_w, w, D, V, D, kTileV))
    return (int)cudaErrorInvalidValue;
  static const cudaError_t attr =
      allow_smem(lm_head_stats_kernel, StatsSmem::bytes);
  if (attr != cudaSuccess) return (int)attr;
  const StatsArgs p{static_cast<const int*>(labels), static_cast<float*>(part),
                    N, V, D, splits, per, t, kLog2e / t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int units = (N + kTileM - 1) / kTileM * splits;
  lm_head_stats_kernel<<<std::min(units, sm_count()), kThreadsWs,
                         StatsSmem::bytes, s>>>(tm_h, tm_w, p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lm_head_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lse1),
      static_cast<float*>(lset), static_cast<float*>(lab), N, splits);
  return (int)cudaGetLastError();
}

// dh [N, D] bf16 from the cotangents a1, aT, b (fp32 [N]) of lse1, lseT
// and label_logit; D in {64, 128, 256, 512, 1024}. Scratch: dl, bf16
// [chunk, ld] with chunk % 256 == 0, ld >= N and ld % 128 == 0; part, fp32
// [N, D] (null when V <= chunk). Launches two kernels a vocab chunk.
extern "C" int lm_head_dh(const void* h, const void* w, const void* labels,
                          const void* lse1, const void* lset, const void* a1,
                          const void* at, const void* b, void* dh, void* dl,
                          void* part, int N, int V, int D, int chunk, int ld,
                          float t, void* stream) {
  return bwd_entry<true>(h, w, labels, lse1, lset, a1, at, b, dh, dl, part,
                         N, V, D, chunk, ld, t, stream);
}

// dW [V, D] bf16, every row; part is unused. As lm_head_dh otherwise.
extern "C" int lm_head_dw(const void* h, const void* w, const void* labels,
                          const void* lse1, const void* lset, const void* a1,
                          const void* at, const void* b, void* dw, void* dl,
                          void* part, int N, int V, int D, int chunk, int ld,
                          float t, void* stream) {
  return bwd_entry<false>(h, w, labels, lse1, lset, a1, at, b, dw, dl, part,
                          N, V, D, chunk, ld, t, stream);
}
