// Paged decode attention (K4) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel speech_distill_tpu/ops/paged_attention.py
// `_decode_kernel`: one query token per row attends over that row's keys,
// which live in a shared page pool [L, P, KV, page_size, Dh] and are named
// by a block table [B, max_pages]. GQA: the G = H / KV query heads of one
// KV head share every K/V row they read.
//
// What bounds it on the card: bytes. Every resident K and V row of every
// row is read once per layer per decode step (B * len * KV * Dh * 2 values)
// against about 4 * G flops per value, far below the card's ~295 flop/byte
// balance point. So the design only tries to read each byte once, in wide
// coalesced loads:
//   * one block per (KV head, row): the G query rows are held in shared
//     memory as fp32 and reuse each staged K/V row;
//   * keys are staged 64 at a time (any page size): 16-byte vector loads,
//     neighbouring threads on neighbouring addresses, one row's
//     block-table entry looked up per token, so entries beyond
//     ceil(len / page_size) are never read (they hold junk);
//   * the online softmax (running max, running sum, rescaled accumulator)
//     runs in fp32 with the scale applied to the fp32 scores;
//   * only the chunk's real tokens are staged and summed: keys >= len are
//     never read, so no uninitialised shared memory can reach the P.V
//     product (the TPU kernel zeroes its scratch for the same reason);
//   * a row with len == 0 writes exact zeros.
// `lengths` counts the current token (its K/V were scattered before the
// call). A faster version (several blocks per row with a merge pass,
// cp.async/TMA double buffering) is later work.
//
// The int8 pool (K4-int8, the TPU kernel's `quantized=True` branch; entry
// `paged_decode_int8`) is the same kernel with int8 K/V rows and fp32
// per-(token, KV head) scales [L, P, KV, page_size]: 16 int8 values a
// 16-byte load (half K4's bytes a token), converted to fp32 on use. As on
// the TPU, the scales fold into the recurrence instead of dequantizing the
// rows: the score of key t is (q . k_t) * ks[t] before the softmax scale
// and the mask, and p_t * vs[t] enters the P.V sum (the running sum l
// takes p_t alone). Scales are staged, like the rows, only for tokens
// below len. q and the output are bf16 or fp32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;          // keys staged in shared memory per pass
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dot of an fp32 query row with one staged K row of kVec-element vectors
template <typename T>
__device__ __forceinline__ float dot_row(const float* q, const T* k, int Dh) {
  constexpr int kVec = 16 / sizeof(T);
  float s = 0.f;
  for (int d = 0; d < Dh; d += kVec) {
    uint4 raw = *reinterpret_cast<const uint4*>(k + d);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kVec; ++i) s += q[d + i] * to_f(e[i]);
  }
  return s;
}

// TQ: the type of q and out; T: the type of the pool rows (TQ, or int8_t
// with scales)
template <typename T>
size_t smem_bytes(int G, int Dh) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr bool kQuant = sizeof(T) == 1;
  const int ld = Dh + kVec;
  return 2 * (size_t)kChunk * ld * sizeof(T) +
         ((size_t)2 * G * Dh + (size_t)G * kChunk + 3 * (size_t)G +
          (kQuant ? 2 * (size_t)kChunk : 0)) *
             sizeof(float);
}

template <typename TQ, typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q,            // [B, KV, G, Dh]
    const T* __restrict__ k_pool,        // [L, P, KV, ps, Dh]
    const T* __restrict__ v_pool,        // [L, P, KV, ps, Dh]
    const float* __restrict__ k_scale,   // [L, P, KV, ps] (int8 pools)
    const float* __restrict__ v_scale,   // [L, P, KV, ps] (int8 pools)
    const int* __restrict__ block_tables,  // [B, max_pages]
    const int* __restrict__ lengths,       // [B]
    TQ* __restrict__ out,                // [B, KV, G, Dh]
    int KV, int G, int Dh, int P, int ps, int max_pages, int layer,
    float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr bool kQuant = sizeof(T) == 1;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int len = lengths[b];
  const int ld = Dh + kVec;   // padded row: conflict-free 16-byte reads

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);                    // [kChunk][ld]
  T* v_s = k_s + kChunk * ld;                                  // [kChunk][ld]
  float* q_s = reinterpret_cast<float*>(v_s + kChunk * ld);    // [G][Dh]
  float* acc_s = q_s + G * Dh;                                 // [G][Dh]
  float* p_s = acc_s + G * Dh;                                 // [G][kChunk]
  float* m_s = p_s + G * kChunk;                               // [G]
  float* l_s = m_s + G;                                        // [G]
  float* c_s = l_s + G;                                        // [G]
  float* ks_s = c_s + G;                     // [kChunk] (int8 pools only)
  float* vs_s = ks_s + kChunk;               // [kChunk]

  const TQ* qb = q + ((size_t)b * KV + h) * G * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) {
    q_s[i] = to_f(qb[i]);
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int vecs = Dh / kVec;
  const size_t page_elems = (size_t)KV * ps * Dh;
  const size_t head_off = (size_t)layer * P * page_elems + (size_t)h * ps * Dh;
  // scales [L, P, KV, ps]: one per token and KV head
  const size_t scale_off = ((size_t)layer * P * KV + h) * ps;
  const int* bt = block_tables + (size_t)b * max_pages;

  for (int c0 = 0; c0 < len; c0 += kChunk) {
    const int n = min(kChunk, len - c0);
    // stage tokens [c0, c0 + n): token j sits in page bt[j / ps], slot j % ps
    for (int i = tid; i < n * vecs; i += kThreads) {
      const int t = i / vecs;
      const int cv = (i - t * vecs) * kVec;
      const int j = c0 + t;
      const size_t src = head_off + (size_t)bt[j / ps] * page_elems +
                         (size_t)(j % ps) * Dh + cv;
      *reinterpret_cast<uint4*>(k_s + t * ld + cv) =
          *reinterpret_cast<const uint4*>(k_pool + src);
      *reinterpret_cast<uint4*>(v_s + t * ld + cv) =
          *reinterpret_cast<const uint4*>(v_pool + src);
    }
    if (kQuant) {
      for (int t = tid; t < n; t += kThreads) {
        const int j = c0 + t;
        const size_t si = scale_off + (size_t)bt[j / ps] * KV * ps + j % ps;
        ks_s[t] = k_scale[si];
        vs_s[t] = v_scale[si];
      }
    }
    __syncthreads();
    // fp32 scores of the chunk's real tokens (int8: times the key's scale,
    // then the softmax scale, as the TPU kernel associates them)
    for (int i = tid; i < G * n; i += kThreads) {
      const int g = i / n;
      const int t = i - g * n;
      float sc = dot_row(q_s + g * Dh, k_s + t * ld, Dh);
      if (kQuant) sc *= ks_s[t];
      p_s[g * kChunk + t] = sc * scale;
    }
    __syncthreads();
    // online softmax: one warp per query row
    for (int g = warp; g < G; g += nwarps) {
      float* pg = p_s + g * kChunk;
      float mx = kNegInf;
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, pg[t]);
      mx = warp_max(mx);
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int t = lane; t < n; t += 32) {
        const float e = expf(pg[t] - m_new);
        pg[t] = kQuant ? e * vs_s[t] : e;   // int8: p * v_scale for P.V
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[g] = corr;
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p . V over the chunk's real tokens only
    for (int i = tid; i < G * Dh; i += kThreads) {
      const int g = i / Dh;
      const int d = i - g * Dh;
      const float* pg = p_s + g * kChunk;
      float a = 0.f;
      for (int t = 0; t < n; ++t) a += pg[t] * to_f(v_s[t * ld + d]);
      acc_s[i] = acc_s[i] * c_s[g] + a;
    }
    __syncthreads();
  }

  TQ* ob = out + ((size_t)b * KV + h) * G * Dh;
  for (int i = tid; i < G * Dh; i += kThreads) {
    const int g = i / Dh;
    const float o = len > 0 ? acc_s[i] / fmaxf(l_s[g], 1e-30f) : 0.f;
    ob[i] = from_f<TQ>(o);
  }
}

template <typename TQ, typename T>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int* bt, const int* lengths, void* out, int B,
                   int KV, int G, int Dh, int P, int ps, int max_pages,
                   int layer, float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(G, Dh);
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel<TQ, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid(KV, B);
  paged_decode_kernel<TQ, T><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), k_scale, v_scale, bt, lengths,
      static_cast<TQ*>(out), KV, G, Dh, P, ps, max_pages, layer, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after launch.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* block_tables,
                            const void* lengths, void* out, int B, int KV,
                            int G, int Dh, int P, int ps, int max_pages,
                            int layer, float scale, int dtype, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, bt, ln, out, B, KV, G, Dh, P,
        ps, max_pages, layer, scale, s);
  if (dtype == 0)
    return (int)launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, bt,
                                     ln, out, B, KV, G, Dh, P, ps, max_pages,
                                     layer, scale, s);
  return (int)cudaErrorInvalidValue;
}

// int8 pools with fp32 scales [L, P, KV, ps]; q_dtype: 0 = float32, 1 =
// bfloat16 (q and out). Needs Dh % 16 == 0. Returns cudaGetLastError().
extern "C" int paged_decode_int8(const void* q, const void* k_pool,
                                 const void* v_pool, const void* k_scale,
                                 const void* v_scale,
                                 const void* block_tables,
                                 const void* lengths, void* out, int B,
                                 int KV, int G, int Dh, int P, int ps,
                                 int max_pages, int layer, float scale,
                                 int q_dtype, void* stream) {
  const int* bt = static_cast<const int*>(block_tables);
  const int* ln = static_cast<const int*>(lengths);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dh % 16) return (int)cudaErrorInvalidValue;
  if (q_dtype == 1)
    return (int)launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, ks, vs, bt,
                                              ln, out, B, KV, G, Dh, P, ps,
                                              max_pages, layer, scale, s);
  if (q_dtype == 0)
    return (int)launch<float, int8_t>(q, k_pool, v_pool, ks, vs, bt, ln, out,
                                      B, KV, G, Dh, P, ps, max_pages, layer,
                                      scale, s);
  return (int)cudaErrorInvalidValue;
}
