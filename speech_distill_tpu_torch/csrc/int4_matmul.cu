// Fused int4 dequantize-matmul (K3) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel speech_distill_tpu/ops/quant_matmul.py
// `_kernel` (called through `int4_matmul`): y = x @ ((nibble - 8) * scale)
// for x [M, K] bf16, the packed weight [K/2, N] uint8 in the split-halves
// layout (the high nibble of packed row r is contraction row r, the low
// nibble row K/2 + r) and a per-column fp32 scale [N]; fp32 accumulation,
// the scale applied after the sum, y in fp32 or bf16.
//
// Dequantization, in registers: two bytes of one column from packed rows
// r and r + 1 are brought into the low bytes of the two halves of a word
// by one byte permute; masking each half's nibble and or-ing 0x4300 makes
// the bf16 pair 128 + nibble (exponent 7, the nibble in the last mantissa
// bits), and one bf16x2 subtraction of 136 gives nibble - 8 exactly (all
// are integers of magnitude <= 8), the k pair of a tensor-core fragment.
// A thread loads whole words of a packed row and gives each byte its own
// fragment column (output columns are permuted into the fragments and
// back at the store), so the weight is read once, in wide loads, and never
// staged as bf16.
//
// What bounds it on the card:
//   * decode, M <= 16 (int4_decode_kernel): bytes. 2 * 16 * K * N flops
//     against K * N / 2 weight bytes is ~64 flop/byte, far below the
//     card's ~295, and at 1.6 MB a projection the time is latency: the
//     design keeps every load of the weight in flight at once and spreads
//     the tensor-core work over the warps. A block of eight warps owns 128
//     columns and one split of the contraction; each warp takes 16-row
//     packed steps (one or two at the 0.6B's shapes), every lane reading 16
//     bytes of each of four rows (and x in 8-byte pieces, the step's k
//     order permuted alike in both) with the next step's loads in flight,
//     and feeds mma.sync m16n8k16 with x's fragments read straight from
//     memory (rows >= M are zeros). The warps' sums are added in shared
//     memory; the splits of a column tile form one
//     thread-block cluster (at most 8) whose blocks push their sums into
//     each other's shared memory and, after one cluster barrier, add them
//     in split order, scale and store: one launch, no scratch in device
//     memory, bitwise repeatable.
//   * prefill, M > 16 (int4_prefill_kernel): operations. y^T = W^T x^T on
//     wgmma with the dequantized weight as the register-sourced A (so the
//     bf16 weight is never written to shared memory) and x as B, K-major,
//     from TMA boxes of 64 rows (zeros past M) at columns k0 and K/2 + k0
//     beside a 128-column box of 64 packed rows (128-byte swizzle, so the
//     word loads hit no bank twice). 384 threads: a producer warpgroup
//     (setmaxnreg 24) whose one thread streams 24 KB stages through a
//     7-stage TMA/mbarrier ring, and two consumer warpgroups (240) that
//     take a tile's even and odd stages, so that one converts while the
//     other's products run; 64 x 128 tiles of y (128 at the 0.6B's
//     M 1,024 down projection), persistent blocks. The epilogue stores
//     four consecutive columns a thread straight from registers.
// The split plan is ops/quant_matmul.k3_plan.
#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCols = 128;        // output columns of a prefill tile
constexpr int kStep = 16;         // packed rows of a decode step
constexpr int kDecWarps = 8;
constexpr int kDecCols = 128;     // output columns of a decode block
constexpr int kMaxSplits = 8;     // a portable cluster
constexpr int kPreRows = 64;      // rows of x a prefill tile
constexpr int kPreDepth = 64;     // packed rows of a prefill stage
constexpr int kPreStages = 7;     // 24 KB stages

// four consecutive outputs, one 16-byte (fp32) or 8-byte (bf16) store
__device__ __forceinline__ void store4(float* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(o) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void store4(bf16* o, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<uint2*>(o) = make_uint2(pack_bf16(a, b), pack_bf16(c, d));
}

// byte i of `a` and byte i of `b` (one column of packed rows r and r + 1)
// as bf16 pairs (row r low, row r + 1 high) of nibble - 8: the high
// nibbles (contraction rows r, r + 1) and the low ones (K/2 + r, + 1)
template <int I>
__device__ __forceinline__ void dequant_pair(uint32_t a, uint32_t b,
                                             uint32_t& hi, uint32_t& lo) {
  constexpr uint32_t sel = I | (I << 4) | ((4 + I) << 8) | ((4 + I) << 12);
  const uint32_t r = __byte_perm(a, b, sel);
  const uint32_t h = ((r >> 4) & 0x000F000Fu) | 0x43004300u;
  const uint32_t l = (r & 0x000F000Fu) | 0x43004300u;
  const __nv_bfloat162 k136 = __halves2bfloat162(__ushort_as_bfloat16(0x4308),
                                                 __ushort_as_bfloat16(0x4308));
  __nv_bfloat162 hv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&h),
                              k136);
  __nv_bfloat162 lv = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&l),
                              k136);
  hi = *reinterpret_cast<uint32_t*>(&hv);
  lo = *reinterpret_cast<uint32_t*>(&lv);
}

// ---------------------------------------------------------------------------
// decode, M <= 16
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// what a lane reads for one 16-row step: 16 bytes (columns 16 g ..) of
// packed rows 4q .. 4q + 3, and x's A fragments of the two nibble planes
// (columns k0 + 4q .. 4q + 3 and K/2 + k0 + 4q .., rows g and g + 8). The
// step's k order is permuted alike in A and B: fragment k pair (2q, 2q + 1)
// is rows 4q, 4q + 1 and pair (2q + 8, 2q + 9) rows 4q + 2, 4q + 3, so
// that a lane reads x in 8-byte pieces.
constexpr int kLaneWords = kDecCols / 32;   // words of a packed row a lane
static_assert(kLaneWords == 4, "a lane reads 16 bytes of a packed row");

struct DecodeLoad {
  uint4 w[4];
  uint32_t xh[4], xl[4];
};

__device__ __forceinline__ void decode_load(DecodeLoad& d, const bf16* x,
                                            const uint8_t* packed, int step,
                                            int n0, int M, int N, int K2,
                                            int ldx, int g, int q) {
  const int k0 = step * kStep + 4 * q;
  const uint8_t* col = packed + n0 + 4 * kLaneWords * g;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    d.w[i] = __ldg(reinterpret_cast<const uint4*>(col + (size_t)(k0 + i) * N));
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // a0, a2: row g; a1, a3: row g + 8
    const int m = g + 8 * h;
    const bf16* xr = x + (size_t)m * ldx + k0;
    uint2 vh = make_uint2(0u, 0u), vl = vh;
    if (m < M) {
      vh = __ldg(reinterpret_cast<const uint2*>(xr));
      vl = __ldg(reinterpret_cast<const uint2*>(xr + K2));
    }
    d.xh[h] = vh.x;
    d.xh[h + 2] = vh.y;
    d.xl[h] = vl.x;
    d.xl[h + 2] = vl.y;
  }
}

constexpr int kNTiles = kDecCols / 8;   // n-tiles (bytes) a lane

// the products of one step: byte t of a lane's is n-tile t (column
// kNTiles g + t), each against both nibble planes
__device__ __forceinline__ void decode_step(float (&acc)[kNTiles][4],
                                            const DecodeLoad& d) {
  // rows 4q, 4q + 1 give b0; rows 4q + 2, 4q + 3 give b1
  const uint32_t* r0 = reinterpret_cast<const uint32_t*>(&d.w[0]);
  const uint32_t* r1 = reinterpret_cast<const uint32_t*>(&d.w[1]);
  const uint32_t* r2 = reinterpret_cast<const uint32_t*>(&d.w[2]);
  const uint32_t* r3 = reinterpret_cast<const uint32_t*>(&d.w[3]);
#pragma unroll
  for (int wd = 0; wd < kLaneWords; ++wd) {
    uint32_t h0[4], l0[4], h2[4], l2[4];
    dequant_pair<0>(r0[wd], r1[wd], h0[0], l0[0]);
    dequant_pair<1>(r0[wd], r1[wd], h0[1], l0[1]);
    dequant_pair<2>(r0[wd], r1[wd], h0[2], l0[2]);
    dequant_pair<3>(r0[wd], r1[wd], h0[3], l0[3]);
    dequant_pair<0>(r2[wd], r3[wd], h2[0], l2[0]);
    dequant_pair<1>(r2[wd], r3[wd], h2[1], l2[1]);
    dequant_pair<2>(r2[wd], r3[wd], h2[2], l2[2]);
    dequant_pair<3>(r2[wd], r3[wd], h2[3], l2[3]);
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      mma_16816(acc[4 * wd + b], d.xh, h0[b], h2[b]);
      mma_16816(acc[4 * wd + b], d.xl, l0[b], l2[b]);
    }
  }
}

// a warp's 16 x kDecCols fp32 sums in shared memory: column c at
// c + 4 (c / (kDecCols / 4)) of its row, rows kDecCols + 16 floats apart,
// so that a quarter-warp's float4 stores (lanes g, g + 1 x q 0..3) hit
// every bank once
constexpr int kRedLd = kDecCols + 16;
constexpr int kTile4 = 16 * kDecCols / 4;   // float4s of a warp's tile

struct DecodeSmem {
  static constexpr int recv = kDecWarps * 16 * kRedLd;   // float offset
  static constexpr size_t bytes =
      (size_t)recv * 4 + (size_t)(kTile4 + kMaxSplits) * 16;
};

__device__ __forceinline__ int red_col(int c) {
  return c + 4 * (c / (kDecCols / 4));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// y[0:M, n0:n0 + kDecCols] for blockIdx.x = tile * splits + split: the block's
// split is packed steps [split * per, min(K2 / 16, (split + 1) * per)),
// warp w taking steps w, w + 8, ... with the loads of its next step in
// flight while it computes one. Launched as clusters of `splits` blocks
// (one column tile): a block adds its warps' sums in warp order, sends
// float4 i of its rows < M to block i / cap of the cluster (a warp's
// float4s to one block, contiguous), and after one cluster barrier each
// block adds the splits' float4s it received in split order, scales (the
// scales read at the start) and stores them.
template <typename TOut>
__global__ void __launch_bounds__(kDecWarps * 32) int4_decode_kernel(
    const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scale, TOut* __restrict__ out, int M, int N,
    int K2, int ldx, int splits, int per) {
  extern __shared__ __align__(16) float dsmem[];
  float (*red)[16][kRedLd] = reinterpret_cast<float (*)[16][kRedLd]>(dsmem);
  float4* recv = reinterpret_cast<float4*>(dsmem + DecodeSmem::recv);
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int n0 = blockIdx.x / splits * kDecCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int s1 = min(K2 / kStep, (split + 1) * per);
  constexpr int kRow4 = kDecCols / 4;   // float4s of a row
  const int n4 = M * kRow4;             // float4s of the rows < M
  // block `split` owns float4s [split * cap, (split + 1) * cap) of the
  // tile; this thread's (M <= 16: at most two, i = split * cap + t + 256 k)
  // and their scales, read now
  const int cap = (kTile4 + splits - 1) / splits;
  float4 sc[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = threadIdx.x + kDecWarps * 32 * k;
    const int i = split * cap + j;
    if (j < cap && i < n4)
      sc[k] = __ldg(reinterpret_cast<const float4*>(scale + n0) + i % kRow4);
  }

  float acc[kNTiles][4];
#pragma unroll
  for (int t = 0; t < kNTiles; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.f;
  DecodeLoad a, b;
  int step = split * per + warp;
  if (step < s1) decode_load(a, x, packed, step, n0, M, N, K2, ldx, g, q);
  for (; step < s1; step += 2 * kDecWarps) {
    const int sb = step + kDecWarps, sa = step + 2 * kDecWarps;
    if (sb < s1) decode_load(b, x, packed, sb, n0, M, N, K2, ldx, g, q);
    decode_step(acc, a);
    if (sb >= s1) break;
    if (sa < s1) decode_load(a, x, packed, sa, n0, M, N, K2, ldx, g, q);
    decode_step(acc, b);
  }
  // n-tile t, fragment column 2q + e is column kNTiles (2q + e) + t
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int t = 0; t < kNTiles; t += 4)
        *reinterpret_cast<float4*>(&red[warp][g + 8 * h][red_col(
            kNTiles * (2 * q + e) + t)]) =
            make_float4(acc[t][2 * h + e], acc[t + 1][2 * h + e],
                        acc[t + 2][2 * h + e], acc[t + 3][2 * h + e]);
  __syncthreads();
  for (int i = threadIdx.x; i < n4; i += kDecWarps * 32) {
    const int r = i / kRow4, c = red_col(4 * (i % kRow4));
    float4 v = *reinterpret_cast<const float4*>(&red[0][r][c]);
#pragma unroll
    for (int w = 1; w < kDecWarps; ++w)
      v = add4(v, *reinterpret_cast<const float4*>(&red[w][r][c]));
    *cluster.map_shared_rank(&recv[split * cap + i % cap], i / cap) = v;
  }
  cluster.sync();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int j = threadIdx.x + kDecWarps * 32 * k;
    const int i = split * cap + j;
    if (j >= cap || i >= n4) break;
    float4 v = recv[j];
    for (int z = 1; z < splits; ++z) v = add4(v, recv[z * cap + j]);
    store4(out + (size_t)(i / kRow4) * N + n0 + 4 * (i % kRow4),
           v.x * sc[k].x, v.y * sc[k].y, v.z * sc[k].z, v.w * sc[k].w);
  }
}

// ---------------------------------------------------------------------------
// prefill, M > 16
// ---------------------------------------------------------------------------

struct PreSmem {
  static constexpr uint32_t x_box = kPreRows * 128;     // 64 rows x 64 k
  static constexpr uint32_t w_box = kPreDepth * 128;    // 64 rows x 128 B
  static constexpr uint32_t stage = 2 * x_box + w_box;
  static constexpr uint32_t red = kPreStages * stage;   // 64 x 128 fp32
  static constexpr uint32_t bar = red + kPreRows * kCols * 4;
  static constexpr uint32_t bytes = bar + 16 * kPreStages + 1024;
};

struct PreArgs {
  const float* scale;
  void* out;
  int M, N, K2;
};

// y = x W for 64 x 128 tiles (tile = m tile * N / 128 + n tile), y^T =
// W^T x^T: per 64-row stage, k16 step and nibble plane two m64n64k16
// products (A: 64 columns of the dequantized weight each, from registers;
// B: the x box, K-major). The two consumer warpgroups take the even and
// the odd stages of a tile, each converting a whole stage into registers
// and issuing its 16 products back to back; at the tile's end warpgroup 1
// hands its sums to warpgroup 0 through shared memory, which adds them
// (even stages + odd stages, a fixed order) and stores the tile. Thread
// (warp w, lane 4 g + q) reads the word at byte 4 (8 w + g) of packed
// rows 2q, 2q + 1, 2q + 8, 2q + 9 of a k16 step: byte 2j + h is A-row
// 16 w + g + 8 h of product j, so its accumulator row holds column
// n0 + 4 (8 w + g) + 2j + h.
template <typename TOut>
__global__ void __launch_bounds__(kThreadsWs, 1) int4_prefill_kernel(
    const __grid_constant__ CUtensorMap tm_x,
    const __grid_constant__ CUtensorMap tm_w, const PreArgs p) {
  using L = PreSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  // a stage is read by one warpgroup: its four warps free it
  const Ring ring{base, L::stage, base + L::bar, base + L::bar + 8 * kPreStages,
                  kPreStages};
  const int n_n = p.N / kCols;
  const int n_tiles = (p.M + kPreRows - 1) / kPreRows * n_n;
  const int n_k = p.K2 / kPreDepth;

  if (threadIdx.x == 0) ring.init(4);
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int m0 = tile / n_n * kPreRows;
        const int n0 = tile % n_n * kCols;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const uint32_t full = ring.acquire(it, L::stage);
          const uint32_t s = ring.stage(it);
          const int k0 = ks * kPreDepth;
          tma_load_2d(s, &tm_x, k0, m0, full);
          tma_load_2d(s + L::x_box, &tm_x, p.K2 + k0, m0, full);
          tma_load_2d(s + 2 * L::x_box, &tm_w, n0, k0, full);
        }
      }
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    const int wg = threadIdx.x / 128;
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    const int g = lane / 4, q = lane % 4;
    const int cb = 4 * (8 * warp + g);    // byte of the packed box row
    float* red = reinterpret_cast<float*>(smem + L::red);
    float acc[2][kPreRows / 2];
    // [k16 step][plane: hi, lo][product j][4]
    uint32_t a_reg[kPreDepth / 16][2][2][4];
    uint32_t it0 = 0;   // the tile's first stage in the ring's sequence
    for (int tile = blockIdx.x; tile < n_tiles;
         tile += gridDim.x, it0 += n_k) {
      const int m0 = tile / n_n * kPreRows;
      const int n0 = tile % n_n * kCols;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int i = 0; i < kPreRows / 2; ++i) acc[j][i] = 0.f;
      for (int ks = wg; ks < n_k; ks += kConsumers) {
        const uint32_t it = it0 + ks;
        const uint32_t s = ring.stage(it);
        ring.wait(it);
        const unsigned char* wbox = smem_raw + (s + 2 * L::x_box - raw);
#pragma unroll
        for (int kk = 0; kk < kPreDepth / 16; ++kk) {
          uint32_t wd[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = 16 * kk + 2 * q + (i & 1) + 8 * (i >> 1);
            wd[i] = *reinterpret_cast<const uint32_t*>(
                wbox + row * 128 + ((((cb >> 4) ^ (row & 7)) << 4) |
                                    (cb & 15)));
          }
          // a0 / a1: rows 2q, 2q + 1 at A-rows g, g + 8 (bytes 2j, 2j + 1);
          // a2 / a3: rows 2q + 8, 2q + 9
          uint32_t(&ah)[2][4] = a_reg[kk][0];
          uint32_t(&al)[2][4] = a_reg[kk][1];
          dequant_pair<0>(wd[0], wd[1], ah[0][0], al[0][0]);
          dequant_pair<1>(wd[0], wd[1], ah[0][1], al[0][1]);
          dequant_pair<2>(wd[0], wd[1], ah[1][0], al[1][0]);
          dequant_pair<3>(wd[0], wd[1], ah[1][1], al[1][1]);
          dequant_pair<0>(wd[2], wd[3], ah[0][2], al[0][2]);
          dequant_pair<1>(wd[2], wd[3], ah[0][3], al[0][3]);
          dequant_pair<2>(wd[2], wd[3], ah[1][2], al[1][2]);
          dequant_pair<3>(wd[2], wd[3], ah[1][3], al[1][3]);
        }
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kPreDepth / 16; ++kk) {
          const uint64_t bh = smem_desc(s + kk * 32, 16, 1024);
          const uint64_t bl = smem_desc(s + L::x_box + kk * 32, 16, 1024);
          wgmma_rs_n64<0>(acc[0], a_reg[kk][0][0], bh);
          wgmma_rs_n64<0>(acc[1], a_reg[kk][0][1], bh);
          wgmma_rs_n64<0>(acc[0], a_reg[kk][1][0], bl);
          wgmma_rs_n64<0>(acc[1], a_reg[kk][1][1], bl);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
#pragma unroll
        for (int kk = 0; kk < kPreDepth / 16; ++kk) {
          fence_regs(a_reg[kk][0]);
          fence_regs(a_reg[kk][1]);
        }
        ring.release(it, lane);
      }
      // warpgroup 1's sums to warpgroup 0 (thread t's value i at
      // red[i][t]); the second barrier keeps warpgroup 1 from writing the
      // next tile's before they are read
      if (wg == 1) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < kPreRows / 2; ++i)
            red[(j * kPreRows / 2 + i) * 128 + t] = acc[j][i];
      }
      asm volatile("bar.sync 1, 256;" ::: "memory");
      if (wg == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < kPreRows / 2; ++i)
            acc[j][i] += red[(j * kPreRows / 2 + i) * 128 + t];
      }
      asm volatile("bar.sync 1, 256;" ::: "memory");
      if (wg == 1) continue;
      // acc[j][4i + 2h + e] = y[m0 + 8i + 2q + e][n0 + cb + 2j + h]
      const float4 sc = *reinterpret_cast<const float4*>(p.scale + n0 + cb);
      TOut* out = static_cast<TOut*>(p.out);
#pragma unroll
      for (int i = 0; i < kPreRows / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = m0 + 8 * i + 2 * q + e;
          if (m >= p.M) continue;
          store4(out + (size_t)m * p.N + n0 + cb, acc[0][4 * i + e] * sc.x,
                 acc[0][4 * i + 2 + e] * sc.y, acc[1][4 * i + e] * sc.z,
                 acc[1][4 * i + 2 + e] * sc.w);
        }
    }
  }
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

template <typename TOut>
cudaError_t decode(const bf16* x, const uint8_t* packed, const float* scale,
                   TOut* out, int M, int N, int K2, int ldx, int splits,
                   cudaStream_t stream) {
  const int steps = K2 / kStep;
  const int per = (steps + splits - 1) / splits;
  if ((splits - 1) * per >= steps) return cudaErrorInvalidValue;
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      int4_decode_kernel<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DecodeSmem::bytes);
  if (smem_ok != cudaSuccess) return smem_ok;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(N / kDecCols * splits);
  cfg.blockDim = dim3(kDecWarps * 32);
  cfg.dynamicSmemBytes = DecodeSmem::bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, int4_decode_kernel<TOut>, x,
                                     packed, scale, out, M, N, K2, ldx,
                                     splits, per);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// packed uint8 [K2, N] as the 2-D map (N, K2): boxes of 128 columns x 64
// rows, 128-byte swizzle
bool make_packed_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int N, int K2) {
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K2};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)kCols, (cuuint32_t)kPreDepth};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TOut>
cudaError_t prefill(const bf16* x, const uint8_t* packed, const float* scale,
                    TOut* out, int M, int N, int K2, int ldx,
                    cudaStream_t stream) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap tm_x, tm_w;
  if (!make_bf16_map(encode, &tm_x, x, 2 * K2, M, ldx, kPreRows) ||
      !make_packed_map(encode, &tm_w, packed, N, K2))
    return cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      int4_prefill_kernel<TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)PreSmem::bytes);
  if (attr != cudaSuccess) return attr;
  const int tiles = (M + kPreRows - 1) / kPreRows * (N / kCols);
  int4_prefill_kernel<TOut><<<std::min(tiles, sm_count()), kThreadsWs,
                              PreSmem::bytes, stream>>>(
      tm_x, tm_w, PreArgs{scale, out, M, N, K2});
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t dispatch(const bf16* x, const uint8_t* packed, const float* scale,
                     void* out, int M, int N, int K2, int ldx, int splits,
                     cudaStream_t stream) {
  TOut* o = static_cast<TOut*>(out);
  if (M <= 16)
    return decode<TOut>(x, packed, scale, o, M, N, K2, ldx, splits, stream);
  if (splits != 1) return cudaErrorInvalidValue;
  return prefill<TOut>(x, packed, scale, o, M, N, K2, ldx, stream);
}

}  // namespace

// x [M, ldx] bf16 (halves at columns 0 and K2), packed [K2, N] uint8,
// scale [N] fp32, out [M, N] (out_dtype 0 = float32, 1 = bfloat16).
// M <= 16 takes the decode kernel over `splits` (1..8, none empty)
// contraction splits, one cluster a 128-column tile; M > 16 the prefill
// kernel (splits 1). Needs K2 % 64 == 0, N % 128 == 0, ldx % 8 == 0 and
// 16-byte aligned x and packed. One launch; returns cudaGetLastError().
extern "C" int int4_matmul(const void* x, const void* packed,
                           const void* scale, void* out, int M, int N, int K2,
                           int ldx, int splits, int out_dtype, void* stream) {
  if (M <= 0 || N <= 0 || N % kCols || K2 <= 0 || K2 % kPreDepth ||
      ldx % 8 || splits < 1 || splits > kMaxSplits)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return (int)dispatch<bf16>(xb, pk, sc, out, M, N, K2, ldx, splits, s);
  if (out_dtype == 0)
    return (int)dispatch<float>(xb, pk, sc, out, M, N, K2, ldx, splits, s);
  return (int)cudaErrorInvalidValue;
}
