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
//     consumers (288 threads, up to 224 registers a thread);
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;          // query rows of one consumer warpgroup
constexpr int kConsumers = 2;    // consumer warpgroups a block
constexpr int kBK = 128;         // keys a K/V tile
constexpr int kStages = 2;       // K/V tiles in flight
constexpr int kThreads = 128 * kConsumers + 32;  // + one producer warp
constexpr int kBox = 64;         // bf16 columns of one 128-byte swizzle box
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// spins until the phase of `bar` with the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (Dh, heads, T, B) into shared memory
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x N] (+)= A B, bf16 in, fp32 accumulators in registers: thread t of
// the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and columns
// 8 j + 2 (t % 4) (+ 1), register 4 j + {0, 1} (row) and 4 j + {2, 3}
// (row + 8). _ss: A and B K-major in shared memory; _rs: A from registers
// (the same layout as two k8 halves of the accumulator), B MN-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
      "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// S = Q K^T for one 64 x 128 tile, Dh in k16 steps. Q [64][Dh] and
// K [128][Dh] are K-major boxes of 64 columns (one 128-byte swizzle atom
// wide), so a step moves 32 bytes inside a box; 8-row groups are 1024
// bytes apart.
template <int DH>
__device__ __forceinline__ void qk(float (&sc)[kBK / 2], uint32_t q_s,
                                   uint32_t k_s) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss_n128(sc,
                  smem_desc(q_s + (kk / 4) * kBQ * 128 + off, 16, 1024),
                  smem_desc(k_s + (kk / 4) * kBK * 128 + off, 16, 1024),
                  kk > 0);
  }
}

// O += P V over the tile's 128 keys in k16 steps. V [128][Dh] is MN-major
// for this product (the transpose bit): a step is two 8-row swizzle atoms
// (2048 bytes), the next 64 columns of Dh the next box (leading offset).
template <int DH>
__device__ __forceinline__ void pv(float (&acc)[DH / 2],
                                   const uint32_t (&p)[kBK / 16][4],
                                   uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t b = smem_desc(v_s + kk * 2048, kBK * 128, 1024);
    if constexpr (DH == 128)
      wgmma_rs_n128(acc, p[kk], b);
    else
      wgmma_rs_n64(acc, p[kk], b);
  }
}

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

// P in bf16 as the A fragments of the k16 steps over the tile's keys:
// the accumulator's registers 8 kk .. 8 kk + 7, pair-wise
__device__ __forceinline__ void to_bf16(const float (&sc)[kBK / 2],
                                        uint32_t (&p)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      p[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

// what a block works on: consumer c takes head h0 + c * dh, rows from
// r0 + c * dr, against n_k key tiles of KV head kvh of batch row b
struct Work {
  int b, kvh, n_k, h0, dh, r0, dr;
  __device__ int head(int c) const { return h0 + c * dh; }
  __device__ int row0(int c) const { return r0 + c * dr; }
};

__device__ __forceinline__ Work block_work(int T, int H, int KV, int B) {
  const int G = H / KV;
  const bool pair = G % 2 == 0;
  // heaviest query tiles first: blockIdx.x runs over tiles in reverse
  const int n_qt = pair ? T / kBQ : (T + 2 * kBQ - 1) / (2 * kBQ);
  const int units = pair ? B * KV * (G / 2) : B * H;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x) / units;
  const int u = static_cast<int>(blockIdx.x) % units;
  Work w;
  if (pair) {
    // two heads of one KV group at the same 64 rows
    const int per_b = KV * (G / 2);
    w.b = u / per_b;
    w.kvh = (u % per_b) / (G / 2);
    w.h0 = w.kvh * G + 2 * ((u % per_b) % (G / 2));
    w.dh = 1;
    w.r0 = qt * kBQ;
    w.dr = 0;
    w.n_k = qt * kBQ / kBK + 1;
  } else {
    // 128 consecutive rows of one head
    w.b = u / H;
    w.h0 = u % H;
    w.kvh = w.h0 / G;
    w.dh = 0;
    w.r0 = kConsumers * qt * kBQ;
    w.dr = kBQ;
    w.n_k = qt + 1;
  }
  return w;
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
      qk<DH>(sc, q_s, base + L::k + s * L::kv_bytes);
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
      to_bf16(sc, p);
      mbar_wait(bar_full_v + 8 * s, round);
      fence_regs(acc);
      fence_regs(p);
      wgmma_fence();
      pv<DH>(acc, p, base + L::v + s * L::kv_bytes);
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
    unsigned char* stage = smem + L::q + wg * L::q_bytes;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r_a + 8 * r;
        const int col = 8 * j + 2 * (lane % 4);
        const uint32_t off = (col / kBox) * L::q_chunk + row * 128 +
                             ((((col % kBox) / 8) ^ (row & 7)) * 16) +
                             (col % 8) * 2;
        *reinterpret_cast<uint32_t*>(stage + off) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r],
                      acc[4 * j + 2 * r + 1] * inv[r]);
      }
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    constexpr int kUnits = DH / 8;  // 16-byte units in a row
    for (int idx = t; idx < kBQ * kUnits; idx += 128) {
      const int row = idx / kUnits;
      const int u = idx % kUnits;
      if (row0 + row < T) {
        const uint32_t off = (u / 8) * L::q_chunk + row * 128 +
                             (((u % 8) ^ (row & 7)) * 16);
        *reinterpret_cast<uint4*>(
            o + (((size_t)w.b * T + row0 + row) * H + head) * DH + u * 8) =
            *reinterpret_cast<const uint4*>(stage + off);
      }
    }
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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, found through the runtime so that
// nothing links against libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// [B, T, heads, Dh] bf16 as the 4-D map (Dh, heads, T, B): boxes of 64
// columns x `rows` rows of one head, 128-byte swizzle, zeros past T
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int Dh,
              int heads, int T, int B, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)Dh, (cuuint64_t)heads,
                              (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Dh * 2,
                                 (cuuint64_t)heads * Dh * 2,
                                 (cuuint64_t)T * heads * Dh * 2};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
  const int G = H / KV;
  const int blocks = G % 2 == 0 ? (T / kBQ) * B * KV * (G / 2)
                                : (T + 2 * kBQ - 1) / (2 * kBQ) * B * H;
  flash_fwd_kernel<DH><<<blocks, kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), T,
      H, KV, B, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// bf16 q/k/v/o, fp32 lse; T % 64 == 0, Dh in {64, 128}, KV divides H.
// Returns cudaGetLastError() after launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int T, int H, int KV,
                         int Dh, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= 0 || T % kBQ != 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (Dh == 128)
    return (int)launch<128>(q, k, v, o, lse, B, T, H, KV, scale, s);
  if (Dh == 64) return (int)launch<64>(q, k, v, o, lse, B, T, H, KV, scale, s);
  return (int)cudaErrorInvalidValue;
}
