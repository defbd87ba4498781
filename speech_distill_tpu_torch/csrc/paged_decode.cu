// Paged decode attention (K4, K4-int8) for Hopper, sm_90a: flash-decoding
// over a thread-block cluster.
//
// Replaces the Pallas TPU kernel speech_distill_tpu/ops/paged_attention.py
// `_decode_kernel`: one query token per row attends over that row's keys,
// which live in a shared page pool [L, P, KV, page_size, Dh] and are named
// by a block table [B, max_pages]. GQA: the G = H / KV query heads of one
// KV head share every K/V row they read.
//
// What bounds it on the card: bytes, in principle. Every resident K and V
// row of every row is read once per layer per decode step against about
// 4 * G flops a value, far below the card's ~295 flop/byte balance point.
// In practice a call is short (tens of microseconds) and rows of a batch
// hold from 0 to max_len keys, so the time goes to the latency chain of
// the longest rows: block-table and page loads, the dependent arithmetic
// of each pass, the merge. The design:
//   * split the key range: the blocks of one thread-block cluster (grid
//     (KV * row groups, B, splits), cluster (1, 1, splits), splits <= 8)
//     own pages [r * pps, (r + 1) * pps) of the row each, so a long row
//     spreads over up to 8 SMs; the plan (splits, pps, stage_tokens,
//     stages) comes from ops/paged_attention.k4_plan, from static shapes
//     only, so the launch never reads `lengths` on the host;
//   * stream the pages: in the pool the rows of one (layer, page, KV head)
//     are contiguous, so thread 0 moves a stage of `stage_tokens` rows of
//     K and of V (int8: and both scale vectors) with 1-D bulk async copies
//     (cp.async.bulk) onto a full mbarrier of a ring of `stages` stages,
//     which the warps hand back on its empty barrier; the query rows ride
//     with the first stage. Warp 0 reads the split's block-table entries
//     into shared memory once, only those of pages below
//     ceil(len / page_size) (the entries past them are junk). Only the
//     rows below len are copied: pool rows past len, and pages no table
//     names, may hold NaN or Inf bit patterns, and 0 * NaN would poison
//     P.V (the TPU kernel zeroes its slack for the same reason). An int8
//     scale copy is rounded up to 16 bytes; the values staged past len are
//     never read;
//   * compute with no block barrier in the token loop: the four warps
//     take a stage's tokens in turn, a group of `lpt` lanes a token (16
//     values of a row a lane for up to two query rows, else 8), the
//     block's G query rows (at most 8 a block; G > 8 takes two row groups)
//     in registers as fp32. A lane group takes up to four tokens a pass
//     with no branch: their loads issue together, a score is summed over
//     its lanes by shuffles and scaled in fp32, and one max and one
//     rescale serve them all. Each lane group keeps its own online softmax
//     (m, l) and accumulator slice in registers (fp32, log2 domain),
//     merged across the groups and the warps once, at the end;
//   * merge the splits in distributed shared memory: a split with no
//     pages leaves at once (a cluster barrier waits for the threads that
//     have not exited only, and nothing reads its state, which would add
//     m = -1e30, l = 0, acc = 0); a row on one split is written by that
//     block with no cluster barrier. Otherwise every active block leaves
//     (m[G], l[G], acc[G, Dh]) in its shared memory, one cluster barrier,
//     then each reads every active split's state for its slice of the
//     G * Dh outputs through the cluster window and combines it in split
//     order (bitwise repeatable): M = max m_i, out = sum e^(m_i - M) acc_i
//     / max(sum e^(m_i - M) l_i, 1e-30); a second cluster barrier keeps
//     the shared memory alive until every block has read it. A row with
//     len 0 writes exact zeros. One launch, no scratch. P.V stays on CUDA
//     cores (4 G flops a value).
// `lengths` counts the current token (its K/V were scattered before the
// call).
//
// The int8 pool (K4-int8, the TPU kernel's `quantized=True` branch; entry
// `paged_decode_int8`) is the same kernel with int8 K/V rows and fp32
// per-(token, KV head) scales [L, P, KV, page_size]. As on the TPU, the
// scales fold into the recurrence instead of dequantizing the rows: the
// score of key t is (q . k_t) * ks[t], then the softmax scale; p_t * vs[t]
// enters P.V and the running sum l takes p_t alone. q and the output are
// bf16 or fp32.
#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplits = 8;      // a portable cluster
constexpr int kMaxStages = 8;
constexpr int kBars = 2 * kMaxStages * 8;   // barrier bytes, first
constexpr int kMaxSmem = 232448;
constexpr float kNegInf = -1e30f;

// values of a row a lane holds, and tokens a lane group scores at once,
// for kR query rows: as many as the registers allow
template <int kR>
__host__ __device__ constexpr int lane_elems() {
  return kR <= 2 ? 16 : 8;
}
template <int kR>
__host__ __device__ constexpr int tokens_at_once() {
  return kR <= 2 ? 4 : kR == 4 ? 2 : 1;
}
// blocks an SM should hold, the register budget ptxas gets (left to its
// own heuristics, ptxas spilled some instantiations at 96-128 registers):
// 170 registers for one or two rows of bf16 or int8, 255 for fp32 rows
// (twice the raw vectors) and for more query rows
template <typename T, int kR>
__host__ __device__ constexpr int min_blocks() {
  return sizeof(T) == 4 || kR > 2 ? 1 : 3;
}

struct Args {
  const void* q;              // [B, KV, G, Dh] TQ
  const void* k_pool;         // [L, P, KV, ps, Dh] T
  const void* v_pool;
  const float* k_scale;       // [L, P, KV, ps] (int8 pools)
  const float* v_scale;
  const int* bt;              // [B, max_pages]
  const int* lengths;         // [B]
  void* out;                  // [B, KV, G, Dh] TQ
  int KV, G, Dh, P, ps, max_pages, layer, pps, st, stages, row_groups;
  float scale_log2;           // softmax scale * log2(e)
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// A lane holds kE values of a row (kE 16 for up to two query rows, else
// 8, so that q and the accumulator stay in registers): kE / V vectors of
// V values, vector j at value (j * lpt + sub) * V, lpt lanes a token.
// V: 8 bf16 or 4 fp32 (16 bytes), 16 or 8 int8 (16 or 8 bytes).
template <typename T, int kE>
__host__ __device__ constexpr int vec_elems() {
  return sizeof(T) == 1 ? (kE < 16 ? 8 : 16) : 16 / (int)sizeof(T);
}

template <typename T, int kE>
__device__ __forceinline__ int elem_index(int sub, int lpt, int e) {
  constexpr int V = vec_elems<T, kE>();
  return ((e / V) * lpt + sub) * V + e % V;
}

// a vector of V values of T as it sits in shared memory: 16 or 8 bytes
template <typename T, int kE>
using Raw = typename std::conditional<vec_elems<T, kE>() * sizeof(T) == 16,
                                      uint4, uint2>::type;

// the values of one raw vector, as fp32
__device__ __forceinline__ void unpack(const uint4& w, float* x, bf16) {
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] = __uint_as_float(u[i] << 16);
    x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack(const uint4& w, float* x, float) {
  x[0] = __uint_as_float(w.x);
  x[1] = __uint_as_float(w.y);
  x[2] = __uint_as_float(w.z);
  x[3] = __uint_as_float(w.w);
}
// int8 by a byte permute into the mantissa of 2^23 (+128 bias, the sign
// bit flipped) and one subtraction: exact, full-rate instructions
__device__ __forceinline__ void unpack_word(uint32_t w, float* x) {
  w ^= 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + i)) -
           8388736.f;
}
__device__ __forceinline__ void unpack(const uint2& w, float* x, int8_t) {
  unpack_word(w.x, x);
  unpack_word(w.y, x + 4);
}
__device__ __forceinline__ void unpack(const uint4& w, float* x, int8_t) {
  unpack_word(w.x, x);
  unpack_word(w.y, x + 4);
  unpack_word(w.z, x + 8);
  unpack_word(w.w, x + 12);
}

// the lane's vectors of a staged row. A vector past Dh is read at the
// row's start instead (no branch, so the loads of several rows issue
// together): its values meet zeros of q, and its P.V sums are never
// stored.
template <typename T, int kE>
__device__ __forceinline__ void load_raw(
    const T* row, int sub, int lpt, int Dh,
    Raw<T, kE> (&r)[kE / vec_elems<T, kE>()]) {
  constexpr int V = vec_elems<T, kE>();
#pragma unroll
  for (int j = 0; j < kE / V; ++j) {
    const int d = (j * lpt + sub) * V;
    r[j] = *reinterpret_cast<const Raw<T, kE>*>(row + (d < Dh ? d : 0));
  }
}

template <typename T, int kE>
__device__ __forceinline__ void unpack_row(
    const Raw<T, kE> (&r)[kE / vec_elems<T, kE>()], float (&x)[kE]) {
  constexpr int V = vec_elems<T, kE>();
#pragma unroll
  for (int j = 0; j < kE / V; ++j) unpack(r[j], x + j * V, T());
}

// one contiguous run of global memory into shared memory, its bytes
// counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// lanes a token: Dh / kE rounded up to a power of two (at most 32)
__device__ __forceinline__ int lanes_per_token(int Dh, int kE) {
  int p = 1;
  while (p * kE < Dh) p <<= 1;
  return p;
}

template <typename T>
__host__ __device__ __forceinline__ uint32_t stage_bytes(int Dh, int st) {
  return 2u * st * Dh * sizeof(T) + (sizeof(T) == 1 ? 8u * st : 0u);
}

// the merge state after the loop, on the ring: the block's (m, l, acc)
// [kR], [kR], [kR][Dh], then each warp's
template <int kR>
__host__ __device__ __forceinline__ uint32_t merge_floats(int Dh) {
  return (1 + kWarps) * (2 * kR + kR * Dh);
}

// shared memory: the barriers, the split's block-table entries (pps ints,
// rounded up to 16 bytes), the block's query rows (kR rows of TQ, a
// multiple of 16 bytes), then the ring, which the merge state reuses
__host__ __device__ __forceinline__ uint32_t q_offset(int pps) {
  return kBars + ((4 * pps + 15) & ~15);
}

template <typename TQ, int kR>
__host__ __device__ __forceinline__ uint32_t ring_offset(int Dh, int pps) {
  return q_offset(pps) + kR * Dh * sizeof(TQ);
}

template <typename TQ, typename T, int kR>
size_t smem_bytes(int Dh, int pps, int st, int stages) {
  const size_t ring = (size_t)stages * stage_bytes<T>(Dh, st);
  const size_t merge = (size_t)merge_floats<kR>(Dh) * sizeof(float);
  return ring_offset<TQ, kR>(Dh, pps) + (ring > merge ? ring : merge);
}

// item j of a split's tokens [t0, t1): tokens [t0 + j st, +n) of one page
// (KV head h; `pages` the split's block-table entries) into stage
// j % stages of the ring, by the block's thread 0; `extra_tx`
// more bytes (item 0: the query rows) land on the same full barrier,
// which it returns
template <typename T>
__device__ __forceinline__ uint32_t issue(const Args& a, const Ring& ring,
                                          const int* pages, int h, int t0,
                                          int t1, int j,
                                          uint32_t extra_tx = 0) {
  constexpr bool kQuant = sizeof(T) == 1;
  const int ps = a.ps, st = a.st;
  const uint32_t row_bytes = a.Dh * sizeof(T);
  const int tok = t0 + j * st;
  const int n = min(st, t1 - tok);
  const int page = pages[(tok - t0) / ps];
  const size_t row0 =
      (((size_t)a.layer * a.P + page) * a.KV + h) * ps + tok % ps;
  const uint32_t kv = n * row_bytes;
  const uint32_t sc = kQuant ? (n * 4 + 15) & ~15u : 0u;
  const uint32_t dst = ring.stage(j);
  const uint32_t full = ring.acquire(j, 2 * kv + 2 * sc + extra_tx);
  bulk_load(dst, static_cast<const T*>(a.k_pool) + row0 * a.Dh, kv, full);
  bulk_load(dst + st * row_bytes,
            static_cast<const T*>(a.v_pool) + row0 * a.Dh, kv, full);
  if constexpr (kQuant) {
    bulk_load(dst + 2 * st * row_bytes, a.k_scale + row0, sc, full);
    bulk_load(dst + 2 * st * row_bytes + 4 * st, a.v_scale + row0, sc, full);
  }
  return full;
}

template <typename TQ, typename T, int kR>
__global__ void __launch_bounds__(kThreads, min_blocks<T, kR>())
    paged_decode_kernel(Args a) {
  constexpr bool kQuant = sizeof(T) == 1;
  constexpr int kU = tokens_at_once<kR>();
  constexpr int kE = lane_elems<kR>();
  constexpr int kV = vec_elems<T, kE>();
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int splits = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.x / a.row_groups;
  const int g0 = (blockIdx.x % a.row_groups) * kR;
  const int rows = min(kR, a.G - g0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.y;
  const int Dh = a.Dh, ps = a.ps, st = a.st, stages = a.stages;
  const int lpt = lanes_per_token(Dh, kE);
  const int sub = lane % lpt, grp = lane / lpt, tps = 32 / lpt;
  const int len = min(max(a.lengths[b], 0), a.max_pages * ps);
  const int total = rows * Dh;      // outputs of the block's rows
  TQ* const ob =
      static_cast<TQ*>(a.out) + (((size_t)b * a.KV + h) * a.G + g0) * Dh;
  if (len == 0) {
    // an idle row: exact zeros, a slice a block; every block of the
    // cluster leaves here, before any cluster barrier
    const int cap = (total + splits - 1) / splits;
    for (int i = split * cap + tid; i < min(total, (split + 1) * cap);
         i += kThreads)
      ob[i] = from_f<TQ>(0.f);
    return;
  }
  // the splits that hold pages. A split with none leaves at once: its
  // state would add m = -1e30, l = 0, acc = 0 (nothing), no block reads
  // its shared memory, and a cluster barrier waits for the threads that
  // have not exited only. With one split left, it writes the output and
  // meets no cluster barrier.
  const int active = ((len + ps - 1) / ps + a.pps - 1) / a.pps;
  if (split >= active) return;
  // this split's tokens [t0, t1), in items of st tokens inside one page
  const int t0 = split * a.pps * ps;
  const int t1 = min(len, t0 + a.pps * ps);
  const int n_items = t1 > t0 ? (t1 - t0 + st - 1) / st : 0;
  const uint32_t row_bytes = Dh * sizeof(T);
  const uint32_t sbytes = stage_bytes<T>(Dh, st);
  const uint32_t bars = smem_u32(smem);
  const uint32_t ring_at = ring_offset<TQ, kR>(Dh, a.pps);
  const Ring ring{bars + ring_at, sbytes, bars, bars + 8 * kMaxStages,
                  stages};
  int* pages = reinterpret_cast<int*>(smem + kBars);
  const TQ* q_s = reinterpret_cast<const TQ*>(smem + q_offset(a.pps));
  if (warp == 0) {
    // the split's block-table entries of pages that hold tokens, once
    // (the entries past them are junk and never read); thread 0 issues
    // every copy: the query rows with item 0, the first round of the
    // ring now, each later item once the warps have handed its stage back
    const int np = (t1 - t0 + ps - 1) / ps;
    for (int i = lane; i < np; i += 32)
      pages[i] = a.bt[(size_t)b * a.max_pages + split * a.pps + i];
    __syncwarp();
    if (lane == 0) {
      ring.init(kWarps);
      const uint32_t q_bytes = rows * Dh * sizeof(TQ);
      const uint32_t full0 = issue<T>(a, ring, pages, h, t0, t1, 0, q_bytes);
      bulk_load(bars + q_offset(a.pps),
                static_cast<const TQ*>(a.q) +
                    (((size_t)b * a.KV + h) * a.G + g0) * Dh,
                q_bytes, full0);
      for (int j = 1; j < min(stages, n_items); ++j)
        issue<T>(a, ring, pages, h, t0, t1, j);
    }
  }
  __syncthreads();   // the barriers' init
  float m[kR], l[kR], acc[kR][kE];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kE; ++e) acc[r][e] = 0.f;
  }
  // the block's query rows, fp32 in registers (rows past G are zeros)
  ring.wait(0);
  float q[kR][kE];
#pragma unroll
  for (int r = 0; r < kR; ++r)
#pragma unroll
    for (int e = 0; e < kE; ++e) {
      const int d = elem_index<T, kE>(sub, lpt, e);
      q[r][e] = r < rows && d < Dh ? to_f(q_s[r * Dh + d]) : 0.f;
    }

  const int slots = kWarps * tps;
  for (int it = 0; it < n_items; ++it) {
    if (tid == 0 && it >= 1 && it - 1 + stages < n_items)
      issue<T>(a, ring, pages, h, t0, t1, it - 1 + stages);
    ring.wait(it);
    const unsigned char* s = smem + ring_at + (it % stages) * sbytes;
    const T* ks = reinterpret_cast<const T*>(s);
    const T* vs = reinterpret_cast<const T*>(s + st * row_bytes);
    const float* ksc = reinterpret_cast<const float*>(s + 2 * st * row_bytes);
    const float* vsc = ksc + st;
    const int n = min(st, t1 - (t0 + it * st));
    // kU tokens a lane group at once, with no branch: the loads of their
    // K rows, the dots, the loads of their V rows under the shuffles, one
    // max and one rescale for them. A token past n reads row 0 (a real
    // row) and gets p = 0. The trip count is warp-uniform, so every lane
    // joins the shuffles.
    for (int base = warp * tps + grp; base - grp < n; base += kU * slots) {
      Raw<T, kE> kr[kU][kE / kV], vr[kU][kE / kV];
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        const int t = base + j * slots;
        load_raw<T, kE>(ks + (size_t)(t < n ? t : 0) * Dh, sub, lpt, Dh,
                        kr[j]);
      }
      float x[kU][kR];
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        float kx[kE];
        unpack_row<T, kE>(kr[j], kx);
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          float p0 = 0.f, p1 = 0.f;   // two chains: half the latency
#pragma unroll
          for (int e = 0; e < kE; e += 2) {
            p0 = fmaf(q[r][e], kx[e], p0);
            p1 = fmaf(q[r][e + 1], kx[e + 1], p1);
          }
          x[j][r] = p0 + p1;
        }
      }
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        const int t = base + j * slots;
        load_raw<T, kE>(vs + (size_t)(t < n ? t : 0) * Dh, sub, lpt, Dh,
                        vr[j]);
      }
#pragma unroll
      for (int k = 4; k >= 0; --k)
        if ((1 << k) < lpt)
#pragma unroll
          for (int j = 0; j < kU; ++j)
#pragma unroll
            for (int r = 0; r < kR; ++r)
              x[j][r] += __shfl_xor_sync(0xffffffffu, x[j][r], 1 << k);
      // fp32 scores in the log2 domain (int8: times the key's scale, then
      // the softmax scale)
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        const int t = base + j * slots;
        const float kf = kQuant ? ksc[t < n ? t : 0] : 1.f;
#pragma unroll
        for (int r = 0; r < kR; ++r)
          x[j][r] = t < n ? (kQuant ? x[j][r] * kf : x[j][r]) * a.scale_log2
                          : kNegInf;
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        float mx = m[r];
#pragma unroll
        for (int j = 0; j < kU; ++j) mx = fmaxf(mx, x[j][r]);
        const float c = fast_exp2(m[r] - mx);
        l[r] *= c;
#pragma unroll
        for (int e = 0; e < kE; ++e) acc[r][e] *= c;
        m[r] = mx;
      }
#pragma unroll
      for (int j = 0; j < kU; ++j) {
        const int t = base + j * slots;
        float vx[kE];
        unpack_row<T, kE>(vr[j], vx);
        const float vf = kQuant ? vsc[t < n ? t : 0] : 1.f;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float p = t < n ? fast_exp2(x[j][r] - m[r]) : 0.f;
          l[r] += p;
          const float pv = kQuant ? p * vf : p;
#pragma unroll
          for (int e = 0; e < kE; ++e)
            acc[r][e] = fmaf(pv, vx[e], acc[r][e]);
        }
      }
    }
    ring.release(it, lane);
  }

  float* bm = reinterpret_cast<float*>(smem + ring_at);  // block: m [kR]
  float* bl = bm + kR;                                   // l [kR]
  float* bacc = bl + kR;                                 // acc [kR][Dh]
  // the lane groups of a warp, merged by shuffles
  for (int o = lpt; o < 32; o <<= 1)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lo = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float M = fmaxf(m[r], mo);
      const float ca = fast_exp2(m[r] - M), cb = fast_exp2(mo - M);
      l[r] = l[r] * ca + lo * cb;
#pragma unroll
      for (int e = 0; e < kE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = acc[r][e] * ca + ao * cb;
      }
      m[r] = M;
    }
  __syncthreads();   // every warp is done with the ring: the merge reuses it
  float* wst = bacc + kR * Dh;     // warp w: acc [kR][Dh], m [kR], l [kR]
  const int wstride = kR * Dh + 2 * kR;
  {
    float* w = wst + warp * wstride;
    if (grp == 0) {
#pragma unroll
      for (int r = 0; r < kR; ++r)
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int d = elem_index<T, kE>(sub, lpt, e);
          if (d < Dh) w[r * Dh + d] = acc[r][e];
        }
    }
    if (lane == 0)
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        w[kR * Dh + r] = m[r];
        w[kR * Dh + kR + r] = l[r];
      }
  }
  __syncthreads();
  // the warps' states, merged in warp order
  for (int i = tid; i < rows * Dh; i += kThreads) {
    const int r = i / Dh;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      M = fmaxf(M, wst[w * wstride + kR * Dh + r]);
    float sum = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* ws = wst + w * wstride;
      const float c = fast_exp2(ws[kR * Dh + r] - M);
      sum += c * ws[i];
      lsum += c * ws[kR * Dh + kR + r];
    }
    bacc[i] = sum;
    if (i % Dh == 0) {
      bm[r] = M;
      bl[r] = lsum;
    }
  }
  if (active == 1) {
    __syncthreads();
    for (int i = tid; i < total; i += kThreads)
      ob[i] = from_f<TQ>(bacc[i] / fmaxf(bl[i / Dh], 1e-30f));
    return;
  }
  cluster.sync();

  // the active splits' states, merged in split order; block `split`
  // writes outputs [split * cap, (split + 1) * cap)
  const int cap = (total + active - 1) / active;
  for (int i = split * cap + tid; i < min(total, (split + 1) * cap);
       i += kThreads) {
    const int r = i / Dh;
    float mz[kMaxSplits];
    float M = kNegInf;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < active) {
        mz[z] = *cluster.map_shared_rank(bm + r, z);
        M = fmaxf(M, mz[z]);
      }
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int z = 0; z < kMaxSplits; ++z)
      if (z < active) {
        const float c = fast_exp2(mz[z] - M);
        num += c * *cluster.map_shared_rank(bacc + i, z);
        den += c * *cluster.map_shared_rank(bl + r, z);
      }
    ob[i] = from_f<TQ>(num / fmaxf(den, 1e-30f));
  }
  cluster.sync();   // no block leaves while another reads its state
}

template <typename TQ, typename T, int kR>
cudaError_t launch_rows(Args a, int B, int splits, cudaStream_t stream) {
  const size_t smem = smem_bytes<TQ, T, kR>(a.Dh, a.pps, a.st, a.stages);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  auto kernel = paged_decode_kernel<TQ, T, kR>;
  // once per instantiation: the most any call asks for
  static const cudaError_t smem_ok = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (smem_ok != cudaSuccess) return smem_ok;
  a.row_groups = (a.G + kR - 1) / kR;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KV * a.row_groups, B, splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the query rows a block holds in registers: G up to 8, else row groups
// of 8
template <typename TQ, typename T>
cudaError_t launch(const Args& a, int B, int splits, cudaStream_t stream) {
  if (a.G <= 1) return launch_rows<TQ, T, 1>(a, B, splits, stream);
  if (a.G <= 2) return launch_rows<TQ, T, 2>(a, B, splits, stream);
  if (a.G <= 4) return launch_rows<TQ, T, 4>(a, B, splits, stream);
  return launch_rows<TQ, T, 8>(a, B, splits, stream);
}

// what the kernel takes: Dh % 8 (int8: % 16), Dh <= 256, G <= 16, and a
// plan whose splits cover the pages exactly, with no split past the last
// page, and stages that tile a page (int8: 16-byte scale runs)
bool args_ok(const Args& a, int B, int splits, bool quant) {
  if (B < 1 || a.KV < 1 || a.G < 1 || a.G > 16 || a.Dh < 8 || a.Dh > 256 ||
      a.Dh % (quant ? 16 : 8) || a.ps < 1 || a.max_pages < 1 || a.P < 1)
    return false;
  if (splits < 1 || splits > kMaxSplits || a.pps < 1 ||
      (splits - 1) * a.pps >= a.max_pages || splits * a.pps < a.max_pages)
    return false;
  if (a.st < 1 || a.ps % a.st || a.stages < 1 || a.stages > kMaxStages)
    return false;
  return !quant || (a.st % 4 == 0 && a.ps % 4 == 0);
}

Args make_args(const void* q, const void* k_pool, const void* v_pool,
               const void* k_scale, const void* v_scale,
               const void* block_tables, const void* lengths, void* out,
               int KV, int G, int Dh, int P, int ps, int max_pages,
               int layer, int pps, int stage_tokens, int stages,
               float scale) {
  Args a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scale = static_cast<const float*>(k_scale);
  a.v_scale = static_cast<const float*>(v_scale);
  a.bt = static_cast<const int*>(block_tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.KV = KV;
  a.G = G;
  a.Dh = Dh;
  a.P = P;
  a.ps = ps;
  a.max_pages = max_pages;
  a.layer = layer;
  a.pps = pps;
  a.st = stage_tokens;
  a.stages = stages;
  a.row_groups = 1;
  a.scale_log2 = scale * kLog2e;
  return a;
}

}  // namespace

// bf16/fp32 pools; dtype: 0 = float32, 1 = bfloat16 (q, pools, out). The
// plan (splits, pages per split, stage tokens, stages) is
// ops/paged_attention.k4_plan's. One launch; returns cudaGetLastError().
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* block_tables,
                            const void* lengths, void* out, int B, int KV,
                            int G, int Dh, int P, int ps, int max_pages,
                            int layer, int splits, int pps, int stage_tokens,
                            int stages, float scale, int dtype,
                            void* stream) {
  const Args a = make_args(q, k_pool, v_pool, nullptr, nullptr, block_tables,
                           lengths, out, KV, G, Dh, P, ps, max_pages,
                           layer, pps, stage_tokens, stages, scale);
  if (!args_ok(a, B, splits, false)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return (int)launch<bf16, bf16>(a, B, splits, s);
  if (dtype == 0) return (int)launch<float, float>(a, B, splits, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pools with fp32 scales [L, P, KV, ps]; q_dtype: 0 = float32, 1 =
// bfloat16 (q and out). Needs Dh % 16 == 0 and ps, stage tokens % 4 == 0.
// One launch; returns cudaGetLastError().
extern "C" int paged_decode_int8(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale,
                                 const void* block_tables,
                                 const void* lengths, void* out, int B,
                                 int KV, int G, int Dh, int P, int ps,
                                 int max_pages, int layer, int splits,
                                 int pps, int stage_tokens, int stages,
                                 float scale, int q_dtype, void* stream) {
  const Args a = make_args(q, k_pool, v_pool, k_scale, v_scale, block_tables,
                           lengths, out, KV, G, Dh, P, ps, max_pages,
                           layer, pps, stage_tokens, stages, scale);
  if (!args_ok(a, B, splits, true)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 1) return (int)launch<bf16, int8_t>(a, B, splits, s);
  if (q_dtype == 0) return (int)launch<float, int8_t>(a, B, splits, s);
  return (int)cudaErrorInvalidValue;
}
