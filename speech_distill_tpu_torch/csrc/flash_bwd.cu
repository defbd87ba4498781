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
// four (s, dp, dv, dk), against O(B T (H + KV) Dh) bytes. So every product
// runs as 16x16x16 bf16 WMMA with fp32 accumulation:
//   * one block of 4 warps per (64-row tile, head, batch row); each warp
//     owns 16 rows of the tile (query rows in dq, key rows in dkv), so only
//     the staging of shared tiles needs block-wide barriers;
//   * the fp32 accumulators (dq, or dk and dv) live in WMMA fragments in
//     registers for the whole loop and are written once, in bf16;
//   * flash_dkv loops over the G query heads of its KV head and over the
//     query tiles from the diagonal on, so dk/dv come out summed over the
//     group with no fp32 [B, H, T, Dh] intermediate, no second pass and no
//     atomics: the result is deterministic, as the TPU design is;
//   * precision as the TPU kernel: p is rounded to bf16 before p^T dO and
//     ds before ds k and ds^T q; every sum accumulates in fp32.
// Where trouble is likely:
//   * the diagonal tile: keys above the diagonal get p = 0 exactly (the
//     select never evaluates exp there), and every element of the S, dP, P
//     and dS tiles is written by a product or by the elementwise pass
//     before any product reads it, so no uninitialised shared memory
//     reaches a product;
//   * lse must be the forward kernel's own, for the p recomputed here to
//     be the forward's softmax; the tile height (64) is the forward's.
// Shared memory is ~112 KB (dq) and ~121 KB (dkv) a block at Dh = 128.
// wgmma, TMA and a pipelined K/V stream are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kBlk = 64;     // rows of a query or key tile
constexpr int kThreads = 128;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int DH>
struct Dims {
  static constexpr int LDH = DH + 8;     // bf16 row of a q/k/v/dO tile
  static constexpr int LDS = kBlk + 4;   // fp32 row of S or dP
  static constexpr int LDP = kBlk + 8;   // bf16 row of P or dS
  static constexpr int LDO = DH + 4;     // fp32 row of the epilogue staging
  static constexpr size_t tile = (size_t)kBlk * LDH * 2;
  static constexpr size_t score = (size_t)kBlk * LDS * 4;
  static constexpr size_t prob = (size_t)kBlk * LDP * 2;
  static_assert(tile % 32 == 0 && score % 32 == 0 && prob % 32 == 0,
                "WMMA tiles need 32-byte aligned shared memory");
  static_assert((size_t)kBlk * LDO * 4 <= 2 * score,
                "the epilogue staging reuses the two score tiles");
};

// byte offsets of the dq kernel's shared memory
template <int DH>
struct DqLayout {
  using D = Dims<DH>;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + D::tile;
  static constexpr size_t k = dout + D::tile;
  static constexpr size_t v = k + D::tile;
  static constexpr size_t s = v + D::tile;       // S, then P (fp32)
  static constexpr size_t dp = s + D::score;
  static constexpr size_t ds = dp + D::score;    // dS (bf16)
  static constexpr size_t lse = ds + D::prob;
  static constexpr size_t delta = lse + kBlk * 4;
  static constexpr size_t bytes = delta + kBlk * 4;
};

// byte offsets of the dk/dv kernel's shared memory
template <int DH>
struct DkvLayout {
  using D = Dims<DH>;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + D::tile;
  static constexpr size_t q = v + D::tile;
  static constexpr size_t dout = q + D::tile;
  static constexpr size_t st = dout + D::tile;   // S^T (fp32)
  static constexpr size_t dpt = st + D::score;   // dP^T (fp32)
  static constexpr size_t pt = dpt + D::score;   // P^T (bf16)
  static constexpr size_t dst = pt + D::prob;    // dS^T (bf16)
  static constexpr size_t lse = dst + D::prob;
  static constexpr size_t delta = lse + kBlk * 4;
  static constexpr size_t bytes = delta + kBlk * 4;
};

// kBlk x DH bf16 tile from global (row stride `stride` elements) to shared
template <int DH>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src,
                                      size_t stride, int tid) {
  constexpr int kVecs = DH / 8;
  for (int i = tid; i < kBlk * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i - r * kVecs) * 8;
    *reinterpret_cast<uint4*>(dst + r * Dims<DH>::LDH + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
  }
}

// out[r0:r0+16, 0:64] = A[r0:r0+16, :] B^T, with A and B kBlk x DH bf16
// tiles in shared memory (B^T is B read column-major)
template <int DH>
__device__ __forceinline__ void rows_times_tile_t(float* out, const bf16* a,
                                                  const bf16* b, int r0) {
  constexpr int LDH = Dims<DH>::LDH;
#pragma unroll
  for (int nc = 0; nc < kBlk / 16; ++nc) {
    FragAcc acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      FragA fa;
      FragBCol fb;
      wmma::load_matrix_sync(fa, a + r0 * LDH + kk * 16, LDH);
      wmma::load_matrix_sync(fb, b + nc * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + r0 * Dims<DH>::LDS + nc * 16, acc,
                            Dims<DH>::LDS, wmma::mem_row_major);
  }
}

// acc[nc] += P[r0:r0+16, 0:64] X[0:64, nc*16:(nc+1)*16] for every column
// block nc, with P a kBlk x kBlk bf16 tile and X a kBlk x DH bf16 tile
template <int DH>
__device__ __forceinline__ void accumulate_rows(FragAcc (&acc)[DH / 16],
                                                const bf16* p, const bf16* x,
                                                int r0) {
  constexpr int LDH = Dims<DH>::LDH;
  constexpr int LDP = Dims<DH>::LDP;
#pragma unroll
  for (int kk = 0; kk < kBlk / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + r0 * LDP + kk * 16, LDP);
#pragma unroll
    for (int nc = 0; nc < DH / 16; ++nc) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, x + kk * 16 * LDH + nc * 16, LDH);
      wmma::mma_sync(acc[nc], fa, fb, acc[nc]);
    }
  }
}

// scale * acc (16 rows of this warp) -> bf16 rows of `dst` (row stride
// `stride` elements), through the warp's rows of an fp32 staging tile
template <int DH>
__device__ __forceinline__ void write_rows(bf16* dst, size_t stride,
                                           FragAcc (&acc)[DH / 16],
                                           float scale, float* staging,
                                           int r0, int lane) {
  constexpr int LDO = Dims<DH>::LDO;
#pragma unroll
  for (int nc = 0; nc < DH / 16; ++nc) {
#pragma unroll
    for (int i = 0; i < acc[nc].num_elements; ++i) acc[nc].x[i] *= scale;
    wmma::store_matrix_sync(staging + r0 * LDO + nc * 16, acc[nc], LDO,
                            wmma::mem_row_major);
  }
  __syncwarp();
  for (int i = lane; i < 16 * DH; i += 32) {
    const int r = i / DH;
    const int c = i - r * DH;
    dst[(size_t)r * stride + c] =
        __float2bfloat16(staging[(r0 + r) * LDO + c]);
  }
  __syncwarp();
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int T, int H, int KV, float scale) {
  using L = DqLayout<DH>;
  using D = Dims<DH>;
  const int iq = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16;            // this warp's 16 query rows

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::dout);
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  float* dp_s = reinterpret_cast<float*>(smem + L::dp);
  bf16* ds_s = reinterpret_cast<bf16*>(smem + L::ds);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const size_t q_stride = (size_t)H * DH;     // between tokens in q, dO, dq
  const size_t kv_stride = (size_t)KV * DH;   // between tokens in k and v
  const size_t q_off =
      ((size_t)b * T + (size_t)iq * kBlk) * q_stride + (size_t)h * DH;
  const bf16* kg = k + (size_t)b * T * kv_stride + (size_t)kvh * DH;
  const bf16* vg = v + (size_t)b * T * kv_stride + (size_t)kvh * DH;
  const size_t row_off = ((size_t)b * H + h) * T + (size_t)iq * kBlk;

  stage<DH>(q_s, q + q_off, q_stride, tid);
  stage<DH>(do_s, dout + q_off, q_stride, tid);
  if (tid < kBlk) {
    lse_s[tid] = lse[row_off + tid];
    delta_s[tid] = delta[row_off + tid];
  }

  FragAcc acc[DH / 16];
#pragma unroll
  for (int nc = 0; nc < DH / 16; ++nc) wmma::fill_fragment(acc[nc], 0.f);

  for (int j = 0; j <= iq; ++j) {
    __syncthreads();   // every warp is done with the previous K/V tile
    stage<DH>(k_s, kg + (size_t)j * kBlk * kv_stride, kv_stride, tid);
    stage<DH>(v_s, vg + (size_t)j * kBlk * kv_stride, kv_stride, tid);
    __syncthreads();

    rows_times_tile_t<DH>(s_s, q_s, k_s, r0);    // S  = Q K^T
    rows_times_tile_t<DH>(dp_s, do_s, v_s, r0);  // dP = dO V^T
    __syncwarp();

    // P and dS for this warp's 16 rows; keys above the diagonal get p = 0
    for (int i = lane; i < 16 * kBlk; i += 32) {
      const int r = r0 + i / kBlk;
      const int c = i % kBlk;
      const int q_pos = iq * kBlk + r;
      const int k_pos = j * kBlk + c;
      const float p = k_pos <= q_pos
                          ? expf(s_s[r * D::LDS + c] * scale - lse_s[r])
                          : 0.f;
      ds_s[r * D::LDP + c] =
          __float2bfloat16(p * (dp_s[r * D::LDS + c] - delta_s[r]));
    }
    __syncwarp();

    accumulate_rows<DH>(acc, ds_s, k_s, r0);     // dQ += dS K
  }

  __syncthreads();   // the score tiles become the epilogue's staging
  write_rows<DH>(dq + q_off + (size_t)r0 * q_stride, q_stride, acc, scale,
                 s_s, r0, lane);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int H, int KV,
    float scale) {
  using L = DkvLayout<DH>;
  using D = Dims<DH>;
  const int ik = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / KV;
  const int n_tiles = T / kBlk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int r0 = warp * 16;            // this warp's 16 key rows

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* k_s = reinterpret_cast<bf16*>(smem + L::k);
  bf16* v_s = reinterpret_cast<bf16*>(smem + L::v);
  bf16* q_s = reinterpret_cast<bf16*>(smem + L::q);
  bf16* do_s = reinterpret_cast<bf16*>(smem + L::dout);
  float* st_s = reinterpret_cast<float*>(smem + L::st);
  float* dpt_s = reinterpret_cast<float*>(smem + L::dpt);
  bf16* pt_s = reinterpret_cast<bf16*>(smem + L::pt);
  bf16* dst_s = reinterpret_cast<bf16*>(smem + L::dst);
  float* lse_s = reinterpret_cast<float*>(smem + L::lse);
  float* delta_s = reinterpret_cast<float*>(smem + L::delta);

  const size_t q_stride = (size_t)H * DH;
  const size_t kv_stride = (size_t)KV * DH;
  const size_t kv_off =
      ((size_t)b * T + (size_t)ik * kBlk) * kv_stride + (size_t)kvh * DH;
  stage<DH>(k_s, k + kv_off, kv_stride, tid);
  stage<DH>(v_s, v + kv_off, kv_stride, tid);

  FragAcc dk_acc[DH / 16];
  FragAcc dv_acc[DH / 16];
#pragma unroll
  for (int nc = 0; nc < DH / 16; ++nc) {
    wmma::fill_fragment(dk_acc[nc], 0.f);
    wmma::fill_fragment(dv_acc[nc], 0.f);
  }

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int jq = ik; jq < n_tiles; ++jq) {
      __syncthreads();   // every warp is done with the previous Q/dO tile
      const size_t q_off =
          ((size_t)b * T + (size_t)jq * kBlk) * q_stride + (size_t)h * DH;
      stage<DH>(q_s, q + q_off, q_stride, tid);
      stage<DH>(do_s, dout + q_off, q_stride, tid);
      if (tid < kBlk) {
        const size_t row_off = ((size_t)b * H + h) * T + (size_t)jq * kBlk;
        lse_s[tid] = lse[row_off + tid];
        delta_s[tid] = delta[row_off + tid];
      }
      __syncthreads();

      rows_times_tile_t<DH>(st_s, k_s, q_s, r0);    // S^T  = K Q^T
      rows_times_tile_t<DH>(dpt_s, v_s, do_s, r0);  // dP^T = V dO^T
      __syncwarp();

      // P^T and dS^T for this warp's 16 key rows (columns are queries);
      // keys above the diagonal get p = 0
      for (int i = lane; i < 16 * kBlk; i += 32) {
        const int r = r0 + i / kBlk;
        const int c = i % kBlk;
        const int k_pos = ik * kBlk + r;
        const int q_pos = jq * kBlk + c;
        const float p = k_pos <= q_pos
                            ? expf(st_s[r * D::LDS + c] * scale - lse_s[c])
                            : 0.f;
        pt_s[r * D::LDP + c] = __float2bfloat16(p);
        dst_s[r * D::LDP + c] =
            __float2bfloat16(p * (dpt_s[r * D::LDS + c] - delta_s[c]));
      }
      __syncwarp();

      accumulate_rows<DH>(dv_acc, pt_s, do_s, r0);   // dV += P^T dO
      accumulate_rows<DH>(dk_acc, dst_s, q_s, r0);   // dK += dS^T Q
    }
  }

  __syncthreads();   // the score tiles become the epilogue's staging
  const size_t out_off = kv_off + (size_t)r0 * kv_stride;
  write_rows<DH>(dk + out_off, kv_stride, dk_acc, scale, st_s, r0, lane);
  write_rows<DH>(dv + out_off, kv_stride, dv_acc, 1.f, st_s, r0, lane);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int DH>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int B, int T, int H, int KV, float scale,
                      cudaStream_t stream) {
  const size_t smem = DqLayout<DH>::bytes;
  cudaError_t e = allow_smem(flash_dq_kernel<DH>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(T / kBlk, H, B);
  flash_dq_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), T, H, KV, scale);
  return cudaGetLastError();
}

template <int DH>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int B, int T, int H, int KV,
                       float scale, cudaStream_t stream) {
  const size_t smem = DkvLayout<DH>::bytes;
  cudaError_t e = allow_smem(flash_dkv_kernel<DH>, smem);
  if (e != cudaSuccess) return e;
  dim3 grid(T / kBlk, KV, B);
  flash_dkv_kernel<DH><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H, KV, scale);
  return cudaGetLastError();
}

}  // namespace

// bf16 q/k/v/dO/dq, fp32 lse/delta [B, H, T]; T % 64 == 0, Dh in {64, 128}.
// Returns cudaGetLastError() after launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dq, int B, int T, int H, int KV, int Dh,
                        float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
  if (Dh == 128)
    return (int)launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, T, H,
                                KV, scale, s);
  if (Dh == 64)
    return (int)launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, T, H,
                               KV, scale, s);
  return (int)cudaErrorInvalidValue;
}
