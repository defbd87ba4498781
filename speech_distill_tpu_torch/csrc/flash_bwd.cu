// Causal GQA flash-attention backward (K1-dq and K1-dkv) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernels speech_distill_tpu/ops/flash_attention.py
// `_dq_kernel` and `_dkv_kernel` (called from `_flash_bwd`), together with
// the reduction over the G query heads of each KV head that `_flash_bwd`
// does outside its dk/dv kernel. Inputs: q, dO [B, T, H, Dh] and k, v
// [B, T, KV, Dh] in bf16; lse (written by csrc/flash_fwd.cu) and
// delta = rowsum(dO * O), both fp32 [B, H, T]. With s = q k^T * scale
// (scale = Dh^-0.5 on the fp32 scores), p = exp(s - lse) and
// ds = p * (dO v^T - delta):
//   flash_dq : dq = scale * ds k                    -> bf16 [B, T, H, Dh]
//   flash_dkv: dk = scale * sum_g ds^T q, dv = sum_g p^T dO
//                                                  -> bf16 [B, T, KV, Dh]
//
// What bounds them on the card: tensor-core operations at long T. Per
// causal (query, key) pair dq does three products (s, dp, dq) and dk/dv
// four (s, dp, dv, dk), against O(B T (H + KV) Dh) bytes. dq stays a
// kernel of its own that recomputes s and dp (seven products in all, not
// the five of a fused backward) because the alternative sums dq over key
// blocks with atomics, and these kernels are deterministic, as the TPU's
// are. Both are built like flash_fwd.cu, from the pieces in hopper.cuh:
//   * a block is two consumer warpgroups of 64 rows and a producer
//     warpgroup (384 threads, one block an SM; setmaxnreg leaves the
//     producer 24 registers a thread and gives the consumers 240). One
//     producer thread streams tiles with TMA (4-D maps (Dh, heads, T, B),
//     128-byte swizzle, zeros past T) through a ring in shared memory,
//     completion on mbarriers; the consumers release each tile on an
//     `empty` barrier as soon as they are done with it;
//   * every product is a wgmma with fp32 accumulators in registers. Scores
//     and dp come from K-major shared tiles (`qk`); p and ds are computed
//     in registers and rounded pair-wise into bf16 A fragments, and the
//     products that consume them read their B operand MN-major (`pv`), as
//     the forward's P V does;
//   * flash_dq is the forward's block (`block_work`: two heads of one KV
//     group at the same 64 query rows when G is even, else 128 rows of one
//     head; the heaviest query tiles first) over 128-key K/V tiles, with a
//     second score product in place of the online softmax. Per tile:
//     S = Q K^T and dP = dO V^T (`wgmma m64n128k16`), V released, then
//     p = exp2(S scale log2(e) - lse log2(e)) and ds = p (dP - delta) for
//     the thread's two rows (lse and delta read once), and dQ += dS K with
//     K read MN-major, then K released;
//   * flash_dkv: a block owns 128 keys of one KV head (64 a warpgroup, K
//     and V resident) and streams (query head g of the group, 64-query
//     tile) stages of Q, dO, lse and delta through a 2-stage ring (3 or 4
//     stages measured slower), from the last query tile down to the
//     diagonal. Per stage: S^T = K Q^T and
//     dP^T = V dO^T (`wgmma m64n64k16`), then P^T and dS^T in registers
//     (lse and delta per column, from the stage), then dV += P^T dO and
//     dK += dS^T Q. dK and dV stay in registers over all G heads, so they
//     come out summed over the group with no fp32 intermediate, no second
//     pass and no atomics. A stage entirely above a warpgroup's diagonal
//     is skipped (its barrier still waited on and released). Key tile 0,
//     which sees every query tile, is issued first;
//   * precision as the TPU kernels: p is rounded to bf16 before p^T dO and
//     ds before ds k and ds^T q; every sum accumulates in fp32, in a fixed
//     order, so repeated runs are bit-identical;
//   * the causal mask (p = 0 exactly, exp never evaluated there) only on
//     the diagonal tile; keys past T are zero-filled and always masked;
//     rows >= T (half a tile when T % 128 == 64) are never stored;
//   * the epilogue scales, rounds to bf16, stages the rows in the
//     warpgroup's own Q (dq) or K and V (dk, dv) rows of shared memory and
//     stores whole 16-byte rows.
#include "hopper.cuh"

namespace {

constexpr int kStagesDq = 2;     // K/V tiles in flight (dq)
constexpr int kStagesKv = 2;     // Q/dO/lse/delta stages in flight (dk/dv)
// byte offsets in shared memory from a 1024-aligned base
template <int DH>
struct DqSmem {
  static constexpr uint32_t q_chunk = kBQ * 128;  // one box: 64 rows x 64
  static constexpr uint32_t kv_chunk = kBK * 128; // one box: 128 rows x 64
  static constexpr uint32_t q_bytes = kBQ * DH * 2;
  static constexpr uint32_t kv_bytes = kBK * DH * 2;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t dout = q + kConsumers * q_bytes;
  static constexpr uint32_t k = dout + kConsumers * q_bytes;
  static constexpr uint32_t v = k + kStagesDq * kv_bytes;
  // mbarriers: Q and dO, then full K, full V, empty K and empty V a stage
  static constexpr uint32_t bar = v + kStagesDq * kv_bytes;
  static constexpr uint32_t bytes = bar + 8 * (1 + 4 * kStagesDq) + 1024;
};

template <int DH>
struct DkvSmem {
  static constexpr uint32_t q_chunk = kBQ * 128;
  static constexpr uint32_t kv_chunk = kBK * 128;
  static constexpr uint32_t q_bytes = kBQ * DH * 2;
  static constexpr uint32_t kv_bytes = kBK * DH * 2;
  static constexpr uint32_t row_bytes = kBQ * 4;  // lse or delta of a stage
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = k + kv_bytes;
  static constexpr uint32_t q = v + kv_bytes;
  static constexpr uint32_t dout = q + kStagesKv * q_bytes;
  static constexpr uint32_t lse = dout + kStagesKv * q_bytes;
  static constexpr uint32_t delta = lse + kStagesKv * row_bytes;
  // mbarriers: K and V, then full and empty a stage
  static constexpr uint32_t bar = delta + kStagesKv * row_bytes;
  static constexpr uint32_t bytes = bar + 8 * (1 + 2 * kStagesKv) + 1024;
};

template <int DH>
__global__ void __launch_bounds__(kThreadsWs, 1) flash_dq_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int T, int H, int KV, int B, float scale_log2,
    float scale) {
  using L = DqSmem<DH>;
  constexpr int kChunks = DH / kBox;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::bar;
  const uint32_t bar_full_k = bar_q + 8;                   // + 8 s
  const uint32_t bar_full_v = bar_full_k + 8 * kStagesDq;  // + 8 s
  const uint32_t bar_empty_k = bar_full_v + 8 * kStagesDq;  // + 8 s
  const uint32_t bar_empty_v = bar_empty_k + 8 * kStagesDq;  // + 8 s
  const Work w = block_work(T, H, KV, B);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStagesDq; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty_k + 8 * s, kConsumers * 4);  // one arrive a warp
      mbar_init(bar_empty_v + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // producer warpgroup: one thread issues every TMA load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, 2 * kConsumers * L::q_bytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int x = 0; x < kChunks; ++x) {
          const uint32_t off = c * L::q_bytes + x * L::q_chunk;
          tma_load(base + L::q + off, &tm_q, x * kBox, w.head(c), w.row0(c),
                   w.b, bar_q);
          tma_load(base + L::dout + off, &tm_do, x * kBox, w.head(c),
                   w.row0(c), w.b, bar_q);
        }
      for (int it = 0; it < w.n_k; ++it) {
        const int s = it % kStagesDq;
        const uint32_t round = (it / kStagesDq) & 1;
        const int key0 = (w.n_k - 1 - it) * kBK;  // diagonal tile first
        mbar_wait(bar_empty_k + 8 * s, round ^ 1);  // round 0 passes
        mbar_expect_tx(bar_full_k + 8 * s, L::kv_bytes);
        for (int x = 0; x < kChunks; ++x)
          tma_load(base + L::k + s * L::kv_bytes + x * L::kv_chunk, &tm_k,
                   x * kBox, w.kvh, key0, w.b, bar_full_k + 8 * s);
        mbar_wait(bar_empty_v + 8 * s, round ^ 1);
        mbar_expect_tx(bar_full_v + 8 * s, L::kv_bytes);
        for (int x = 0; x < kChunks; ++x)
          tma_load(base + L::v + s * L::kv_bytes + x * L::kv_chunk, &tm_v,
                   x * kBox, w.kvh, key0, w.b, bar_full_v + 8 * s);
      }
    }
  } else {
    // consumer warpgroup: 64 query rows of one head
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_a = (t / 32) * 16 + lane / 4;  // rows r_a and r_a + 8
    const int head = w.head(wg);
    const int row0 = w.row0(wg);
    const uint32_t q_s = base + L::q + wg * L::q_bytes;
    const uint32_t do_s = base + L::dout + wg * L::q_bytes;

    // lse (in log2 units) and delta of the thread's two rows; rows past T
    // (zero Q and dO) get 0 and are never stored
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r_a + 8 * r;
      const size_t idx = ((size_t)w.b * H + head) * T + row;
      lse2[r] = row < T ? lse[idx] * kLog2e : 0.f;
      dlt[r] = row < T ? delta[idx] : 0.f;
    }
    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(bar_q, 0);
    for (int it = 0; it < w.n_k; ++it) {
      const int s = it % kStagesDq;
      const uint32_t round = (it / kStagesDq) & 1;
      const uint32_t k_s = base + L::k + s * L::kv_bytes;
      float sc[kBK / 2], dp[kBK / 2];
      // both tiles first: a spin on a barrier while a product is in flight
      // makes ptxas serialize every wgmma
      mbar_wait(bar_full_k + 8 * s, round);
      mbar_wait(bar_full_v + 8 * s, round);
      wgmma_fence();
      qk<DH, kBK>(sc, q_s, L::q_chunk, k_s, L::kv_chunk);  // S = Q K^T
      qk<DH, kBK>(dp, do_s, L::q_chunk, base + L::v + s * L::kv_bytes,
                  L::kv_chunk);                           // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);
      release(bar_empty_v + 8 * s);
      // ds = p (dp - delta) in bf16, p = 0 above the diagonal (tile 0)
      const int key0 = (w.n_k - 1 - it) * kBK;
      uint32_t ds[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float d2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 8 * kk + 2 * x + e;
            const int r = (i >> 1) & 1;
            const int key = key0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
            const bool masked = it == 0 && key > row0 + r_a + 8 * r;
            const float p =
                masked ? 0.f : fast_exp2(fmaf(sc[i], scale_log2, -lse2[r]));
            d2[e] = p * (dp[i] - dlt[r]);
          }
          ds[kk][x] = pack_bf16(d2[0], d2[1]);
        }
      fence_regs(acc);
      fence_regs(ds);
      wgmma_fence();
      pv<DH, kBK>(acc, ds, k_s);                          // dQ += dS K
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(ds);
      release(bar_empty_k + 8 * s);
    }

    const float mult[2] = {scale, scale};
    store_rows<DH>(acc, mult, smem + L::q + wg * L::q_bytes, L::q_chunk, 0,
                   dq + (((size_t)w.b * T + row0) * H + head) * DH,
                   (size_t)H * DH, T - row0, t, wg);
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreadsWs, 1) flash_dkv_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_lse,
    const __grid_constant__ CUtensorMap tm_delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int T, int H, int KV, int B, float scale_log2,
    float scale) {
  using L = DkvSmem<DH>;
  constexpr int kChunks = DH / kBox;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_kv = base + L::bar;
  const uint32_t bar_full = bar_kv + 8;                  // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStagesKv;   // + 8 s
  // key tile 0 (every query tile) first
  const int G = H / KV;
  const int units = B * KV;
  const int k0 = (static_cast<int>(blockIdx.x) / units) * kBK;
  const int b = (static_cast<int>(blockIdx.x) % units) / KV;
  const int kvh = static_cast<int>(blockIdx.x) % KV;
  const int n_q = T / kBQ;
  const int per_g = n_q - k0 / kBQ;  // query tiles from the diagonal on
  const int n_it = G * per_g;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStagesKv; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kConsumers * 4);  // one arrive a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // producer warpgroup: K and V once, then (head, query tile) stages,
    // the last query tile first
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_kv, 2 * L::kv_bytes);
      for (int x = 0; x < kChunks; ++x) {
        tma_load(base + L::k + x * L::kv_chunk, &tm_k, x * kBox, kvh, k0, b,
                 bar_kv);
        tma_load(base + L::v + x * L::kv_chunk, &tm_v, x * kBox, kvh, k0, b,
                 bar_kv);
      }
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kStagesKv;
        const uint32_t round = (it / kStagesKv) & 1;
        const int h = kvh * G + it / per_g;
        const int q0 = (n_q - 1 - it % per_g) * kBQ;
        const uint32_t full = bar_full + 8 * s;
        mbar_wait(bar_empty + 8 * s, round ^ 1);  // round 0 passes
        mbar_expect_tx(full, 2 * L::q_bytes + 2 * L::row_bytes);
        for (int x = 0; x < kChunks; ++x) {
          const uint32_t off = s * L::q_bytes + x * L::q_chunk;
          tma_load(base + L::q + off, &tm_q, x * kBox, h, q0, b, full);
          tma_load(base + L::dout + off, &tm_do, x * kBox, h, q0, b, full);
        }
        tma_load_2d(base + L::lse + s * L::row_bytes, &tm_lse, q0, b * H + h,
                    full);
        tma_load_2d(base + L::delta + s * L::row_bytes, &tm_delta, q0,
                    b * H + h, full);
      }
    }
  } else {
    // consumer warpgroup: 64 keys, rows 64 wg .. of the K and V tiles
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_a = (t / 32) * 16 + lane / 4;  // key rows r_a and r_a + 8
    const int kc = k0 + wg * kBQ;              // the warpgroup's first key
    const uint32_t k_s = base + L::k + wg * kBQ * 128;
    const uint32_t v_s = base + L::v + wg * kBQ * 128;

    float dk_acc[DH / 2], dv_acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) {
      dk_acc[i] = 0.f;
      dv_acc[i] = 0.f;
    }
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < n_it; ++it) {
      const int s = it % kStagesKv;
      const uint32_t round = (it / kStagesKv) & 1;
      const int q0 = (n_q - 1 - it % per_g) * kBQ;
      mbar_wait(bar_full + 8 * s, round);
      // a query tile wholly above this warpgroup's keys adds nothing
      if (q0 + kBQ > kc) {
        const uint32_t q_s = base + L::q + s * L::q_bytes;
        const uint32_t do_s = base + L::dout + s * L::q_bytes;
        const float* lse_s =
            reinterpret_cast<const float*>(smem + L::lse + s * L::row_bytes);
        const float* dlt_s = reinterpret_cast<const float*>(
            smem + L::delta + s * L::row_bytes);
        float st[kBQ / 2], dpt[kBQ / 2];
        wgmma_fence();
        qk<DH, kBQ>(st, k_s, L::kv_chunk, q_s, L::q_chunk);    // S^T
        qk<DH, kBQ>(dpt, v_s, L::kv_chunk, do_s, L::q_chunk);  // dP^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);
        // P^T and dS^T in bf16: rows are keys, columns queries
        const bool diag = q0 == kc;
        uint32_t pt[kBQ / 16][4], dst[kBQ / 16][4];
#pragma unroll
        for (int kk = 0; kk < kBQ / 16; ++kk)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float p2[2], d2[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int i = 8 * kk + 2 * x + e;
              const int col = (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
              const int key = kc + r_a + 8 * ((i >> 1) & 1);
              const bool masked = diag && key > q0 + col;
              const float p =
                  masked ? 0.f
                         : fast_exp2(fmaf(st[i], scale_log2,
                                          -lse_s[col] * kLog2e));
              p2[e] = p;
              d2[e] = p * (dpt[i] - dlt_s[col]);
            }
            pt[kk][x] = pack_bf16(p2[0], p2[1]);
            dst[kk][x] = pack_bf16(d2[0], d2[1]);
          }
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_regs(pt);
        fence_regs(dst);
        wgmma_fence();
        pv<DH, kBQ>(dv_acc, pt, do_s);   // dV += P^T dO
        pv<DH, kBQ>(dk_acc, dst, q_s);   // dK += dS^T Q
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dk_acc);
        fence_regs(dv_acc);
        fence_regs(pt);
        fence_regs(dst);
      }
      release(bar_empty + 8 * s);
    }

    // dK and dV staged in this warpgroup's own rows of the K and V tiles
    const size_t out = (((size_t)b * T + kc) * KV + kvh) * DH;
    const float mult_k[2] = {scale, scale}, mult_v[2] = {1.f, 1.f};
    store_rows<DH>(dk_acc, mult_k, smem + L::k, L::kv_chunk, wg * kBQ,
                   dk + out, (size_t)KV * DH, T - kc, t, wg);
    store_rows<DH>(dv_acc, mult_v, smem + L::v, L::kv_chunk, wg * kBQ,
                   dv + out, (size_t)KV * DH, T - kc, t, wg);
  }
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int T, int H, int KV, float scale,
                      cudaStream_t stream) {
  constexpr size_t smem = DqSmem<DH>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dq_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(encode, &tm_q, q, DH, H, T, B, kBQ) ||
      !make_map(encode, &tm_k, k, DH, KV, T, B, kBK) ||
      !make_map(encode, &tm_v, v, DH, KV, T, B, kBK) ||
      !make_map(encode, &tm_do, dout, DH, H, T, B, kBQ))
    return cudaErrorInvalidValue;
  flash_dq_kernel<DH><<<query_blocks(B, T, H, KV), kThreadsWs, smem,
                        stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), T, H, KV, B,
      scale * kLog2e, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int T, int H, int KV,
                       float scale, cudaStream_t stream) {
  constexpr size_t smem = DkvSmem<DH>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_dkv_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta;
  if (!make_map(encode, &tm_q, q, DH, H, T, B, kBQ) ||
      !make_map(encode, &tm_k, k, DH, KV, T, B, kBK) ||
      !make_map(encode, &tm_v, v, DH, KV, T, B, kBK) ||
      !make_map(encode, &tm_do, dout, DH, H, T, B, kBQ) ||
      !make_rows_map(encode, &tm_lse, lse, T, B * H, kBQ) ||
      !make_rows_map(encode, &tm_delta, delta, T, B * H, kBQ))
    return cudaErrorInvalidValue;
  const int blocks = (T + kBK - 1) / kBK * B * KV;
  flash_dkv_kernel<DH><<<blocks, kThreadsWs, smem, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, H, KV, B, scale * kLog2e, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 q/k/v/dO/dq, fp32 lse/delta [B, H, T]; T % 64 == 0, Dh in {64, 128},
// KV divides H. Returns cudaGetLastError() after launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int T, int H, int KV, int Dh,
                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(T, H, KV)) return (int)cudaErrorInvalidValue;
  if (Dh == 128)
    return (int)launch_dq<128>(q, k, v, dout, lse, delta, dq, B, T, H, KV,
                               scale, s);
  if (Dh == 64)
    return (int)launch_dq<64>(q, k, v, dout, lse, delta, dq, B, T, H, KV,
                              scale, s);
  return (int)cudaErrorInvalidValue;
}

// As flash_dq; writes bf16 dk and dv [B, T, KV, Dh], summed over the G
// query heads of each KV head.
extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* dout, const void* lse,
                         const void* delta, void* dk, void* dv, int B, int T,
                         int H, int KV, int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(T, H, KV)) return (int)cudaErrorInvalidValue;
  if (Dh == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, T, H,
                                KV, scale, s);
  if (Dh == 64)
    return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, T, H,
                               KV, scale, s);
  return (int)cudaErrorInvalidValue;
}
