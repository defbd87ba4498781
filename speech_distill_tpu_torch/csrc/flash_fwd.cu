// Causal GQA flash-attention forward (K1-fwd) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel speech_distill_tpu/ops/flash_attention.py
// `_fwd_kernel` (called through `_flash_call`): q [B, T, H, Dh] against
// k/v [B, T, KV, Dh] (T == S), causal, scale Dh^-0.5 applied to the fp32
// scores, online softmax over key tiles up to the diagonal, P rounded to
// bf16 before P V with fp32 accumulation, the row sum floored at 1e-30.
// Writes o [B, T, H, Dh] in bf16 and lse [B, H, T] in fp32, natural log
// (the backward kernels in flash_bwd.cu read it).
//
// What bounds it on the card: tensor-core operations at long T
// (2 * B * H * T^2 * Dh causal flops against 2 * B * T * (H + KV) * Dh
// bf16 bytes read and written). The design keeps the tensor cores fed:
//   * a block is two consumer warpgroups and one producer warp. Each
//     consumer owns 64 query rows of one head; both consume the same K/V
//     tiles: the two heads of one KV group at the same rows when the group
//     size G is even (each K/V tile is staged once for two query heads),
//     else 128 consecutive rows of one head;
//   * one producer thread streams 128-key K and V tiles through a 2-stage
//     ring in shared memory with TMA (4-D tensor maps (Dh, heads, T, B),
//     128-byte swizzle, zero fill past T), completion on mbarriers; the
//     consumers release K and V of a stage on their own `empty` barriers,
//     so the next tiles load while the current ones are in use; the
//     producer is a single warp, so no registers have to be moved to the
//     consumers (288 threads; ptxas budgets a wgmma kernel by whole
//     warpgroups, so up to 168 registers a thread, of which this kernel
//     needs 160 at Dh 128);
//   * within a warpgroup, a tile's S, softmax and P V run in turn; the two
//     warpgroups of the block (one block an SM: ~160 KB of shared memory
//     at Dh 128) fill each other's gaps on the tensor cores. Overlapping
//     the next tile's S with this tile's P V inside a warpgroup measured
//     slower: ptxas spilled the bf16 P fragments and serialized every
//     wgmma (PERF.md);
//   * S = Q K^T is `wgmma m64n128k16` with Q and K both K-major from
//     swizzled shared memory; O += P V is `wgmma m64nDhk16` with P taken
//     from registers (the fp32 S fragment converts pair-wise to the bf16 A
//     fragment) and V read MN-major (the transpose bit). S, P, O, the row
//     max and the row sum never leave registers;
//   * softmax in registers: exp2 of scores prescaled by scale * log2(e),
//     row max over the 4 lanes that share a row (shfl_xor 1, 2), row sums
//     reduced once at the end; the causal mask (-1e30, never -inf) only on
//     the diagonal tile, which is processed first;
//   * the heaviest query tiles are issued first (reversed tile order);
//   * the epilogue scales O by 1 / max(l, 1e-30), stages it as bf16 in the
//     warpgroup's Q tile and stores whole 16-byte rows; rows >= T (a half
//     last tile when T % 128 == 64) are never stored.
// The mbarrier, TMA, wgmma and epilogue pieces are in hopper.cuh, shared
// with the backward kernels (flash_bwd.cu).
#include "hopper.cuh"

namespace {

constexpr int kStages = 2;       // K/V tiles in flight
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// byte offsets in shared memory from a 1024-aligned base (the 128-byte
// swizzle repeats every 8 rows of 128 bytes)
template <int DH>
struct Smem {
  static constexpr uint32_t q_chunk = kBQ * 128;  // one box: 64 rows x 64
  static constexpr uint32_t kv_chunk = kBK * 128; // one box: 128 rows x 64
  static constexpr uint32_t q_bytes = kBQ * DH * 2;
  static constexpr uint32_t kv_bytes = kBK * DH * 2;
  static constexpr uint32_t q = 0;
  static constexpr uint32_t k = q + kConsumers * q_bytes;
  static constexpr uint32_t v = k + kStages * kv_bytes;
  // mbarriers: Q, then full K, full V, empty K and empty V for each stage
  static constexpr uint32_t bar = v + kStages * kv_bytes;
  static constexpr uint32_t bytes = bar + 8 * (1 + 4 * kStages) + 1024;
};

// online softmax of one S tile in place: the running max m (of scores
// scaled by scale * log2(e)) and this thread's part of the row sums l are
// updated, sc becomes exp2(sc * scale_log2 - m), corr rescales what was
// accumulated before. Rows r_a and r_a + 8 are shared by 4 lanes.
__device__ __forceinline__ void softmax(float (&sc)[kBK / 2], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        float scale_log2) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i)
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r] * scale_log2);
    corr[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -m[r]));
    l[r] += sc[i];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
    float* __restrict__ lse, int T, int H, int KV, int B, float scale_log2) {
  using L = Smem<DH>;
  constexpr int kChunks = DH / kBox;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t bar_q = base + L::bar;
  const uint32_t bar_full_k = bar_q + 8;                 // + 8 s
  const uint32_t bar_full_v = bar_full_k + 8 * kStages;  // + 8 s
  const uint32_t bar_empty_k = bar_full_v + 8 * kStages;  // + 8 s
  const uint32_t bar_empty_v = bar_empty_k + 8 * kStages;  // + 8 s
  const Work w = block_work(T, H, KV, B);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty_k + 8 * s, kConsumers * 4);  // one arrive a warp
      mbar_init(bar_empty_v + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // producer warp: one thread issues every TMA load
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(bar_q, kConsumers * L::q_bytes);
      for (int c = 0; c < kConsumers; ++c)
        for (int x = 0; x < kChunks; ++x)
          tma_load(base + L::q + c * L::q_bytes + x * L::q_chunk, &tm_q,
                   x * kBox, w.head(c), w.row0(c), w.b, bar_q);
      for (int it = 0; it < w.n_k; ++it) {
        const int s = it % kStages;
        const uint32_t round = (it / kStages) & 1;
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
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const int r_a = (t / 32) * 16 + lane / 4;  // rows r_a and r_a + 8
    const int head = w.head(wg);
    const int row0 = w.row0(wg);
    const uint32_t q_s = base + L::q + wg * L::q_bytes;

    float acc[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};   // running max of scaled log2 scores
    float l[2] = {0.f, 0.f};           // this thread's part of the row sum
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    mbar_wait(bar_q, 0);
    for (int it = 0; it < w.n_k; ++it) {
      const int s = it % kStages;
      const uint32_t round = (it / kStages) & 1;
      float sc[kBK / 2];
      mbar_wait(bar_full_k + 8 * s, round);
      wgmma_fence();
      qk<DH, kBK>(sc, q_s, L::q_chunk, base + L::k + s * L::kv_bytes,
                  L::kv_chunk);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      release(bar_empty_k + 8 * s);
      if (it == 0) {
        // the diagonal tile: keys past each row's own position
        const int key0 = (w.n_k - 1) * kBK;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int key = key0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
          const int qpos = row0 + r_a + ((i & 2) ? 8 : 0);
          if (key > qpos) sc[i] = kNegInf;
        }
      }
      float corr[2];
      softmax(sc, m, l, corr, scale_log2);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
      uint32_t p[kBK / 16][4];
      to_bf16<kBK>(sc, p);
      mbar_wait(bar_full_v + 8 * s, round);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      pv<DH, kBK>(acc, p, base + L::v + s * L::kv_bytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      fence_regs(p);
      release(bar_empty_v + 8 * s);
    }

    // epilogue: row sums over the 4 lanes of a row, O / l staged as bf16
    // in this warpgroup's Q tile (same swizzle as TMA's), then whole rows
    // stored with 16-byte writes
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / l[r];
    }
    store_rows<DH>(acc, inv, smem + L::q + wg * L::q_bytes, L::q_chunk, 0,
                   o + (((size_t)w.b * T + row0) * H + head) * DH,
                   (size_t)H * DH, T - row0, t, wg);
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qpos = row0 + r_a + 8 * r;
        if (qpos < T)
          lse[((size_t)w.b * H + head) * T + qpos] =
              m[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

template <int DH>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int T, int H, int KV, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<DH>::bytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return attr;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(encode, &tm_q, q, DH, H, T, B, kBQ) ||
      !make_map(encode, &tm_k, k, DH, KV, T, B, kBK) ||
      !make_map(encode, &tm_v, v, DH, KV, T, B, kBK))
    return cudaErrorInvalidValue;
  flash_fwd_kernel<DH><<<query_blocks(B, T, H, KV), kThreads, smem,
                         stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), T,
      H, KV, B, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// bf16 q/k/v/o, fp32 lse; T % 64 == 0, Dh in {64, 128}, KV divides H.
// Returns cudaGetLastError() after launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int T, int H, int KV,
                         int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shapes_ok(T, H, KV)) return (int)cudaErrorInvalidValue;
  if (Dh == 128)
    return (int)launch<128>(q, k, v, o, lse, B, T, H, KV, scale, s);
  if (Dh == 64) return (int)launch<64>(q, k, v, o, lse, B, T, H, KV, scale, s);
  return (int)cudaErrorInvalidValue;
}
