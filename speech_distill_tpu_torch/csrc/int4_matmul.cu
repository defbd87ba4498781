// Fused int4 dequantize-matmul (K3) for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel speech_distill_tpu/ops/quant_matmul.py
// `_kernel` (called through `int4_matmul`): y = x @ ((nibble - 8) * scale)
// for x [M, K] bf16, the packed weight [K/2, N] uint8 in the split-halves
// layout (the high nibble of packed row r is contraction row r, the low
// nibble row K/2 + r) and a per-column fp32 scale [N]; fp32 accumulation,
// the scale applied after the sum, y in fp32 or bf16.
//
// What bounds it on the card: bytes at decode (M = 16 rows: 2 * 16 * K * N
// flops against K * N / 2 weight bytes, ~64 flop/byte, far below the
// card's ~295), operations at prefill (M in the thousands). The design
// reads the packed weight once and never writes the bf16 weight:
//   * one block of 4 warps per (BM-row tile, 128-column tile, contraction
//     split); BM is 16 for M <= 16 (decode) and 64 otherwise. Rows >= M
//     are masked at the load (zeros in shared memory) and at the store;
//     x is never padded in memory;
//   * each step stages 32 packed rows x 128 columns with 16-byte loads,
//     widens every byte to int before the shift and mask,
//     (p >> 4) - 8 and (p & 0xF) - 8 as the TPU kernel does, and writes
//     the two bf16 half-tiles to shared memory (integers up to 8 in
//     magnitude are exact in bf16); the two matching 32-column slices of x
//     (columns k0 and K/2 + k0 of the same row-major x, at its row stride)
//     are staged beside them;
//   * two 16x16x16 bf16 WMMA products a k-slice, one per half, accumulate
//     in fp32 fragments; the epilogue goes through shared memory (reusing
//     the operand tiles) so the stores are coalesced;
//   * at small M the output tiles alone cannot fill 132 SMs, so the
//     contraction is split over blockIdx.z: each split writes fp32 partial
//     sums [split, M, N], and a second small kernel adds them in split
//     order (deterministic) and applies the scale. With one split the
//     first kernel applies the scale itself.
// Single-stage staging with block-wide barriers: a cp.async/TMA pipeline
// and wgmma are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kBN = 128;   // output columns per block
constexpr int kBK2 = 32;   // packed rows per step (64 contraction rows)

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// 16 bf16 values: one unpacked nibble plane of 16 packed bytes
union Pack {
  uint4 v[2];
  __nv_bfloat162 h[8];
};

template <int BM>
struct Tile {
  static constexpr int WARPS_M = BM == 16 ? 1 : 2;
  static constexpr int WARPS_N = 4 / WARPS_M;
  static constexpr int WM = BM / WARPS_M;   // rows of a warp's sub-tile
  static constexpr int WN = kBN / WARPS_N;  // columns of a warp's sub-tile
  static constexpr int FM = WM / 16;
  static constexpr int FN = WN / 16;
  static constexpr int LDX = kBK2 + 8;      // bf16 row of an x half-tile
  static constexpr int LDW = kBN + 8;       // bf16 row of a weight half-tile
  static constexpr int LDC = kBN + 4;       // fp32 row of the output tile
  // byte offsets, each a multiple of 32 (WMMA needs 256-bit alignment)
  static constexpr size_t xh = 0;
  static constexpr size_t xl = xh + (size_t)BM * LDX * 2;
  static constexpr size_t wh = xl + (size_t)BM * LDX * 2;
  static constexpr size_t wl = wh + (size_t)kBK2 * LDW * 2;
  static constexpr size_t operands = wl + (size_t)kBK2 * LDW * 2;
  static constexpr size_t out = (size_t)BM * LDC * 4;  // reuses operands
  static constexpr size_t bytes = operands > out ? operands : out;
  static_assert(xl % 32 == 0 && wh % 32 == 0 && wl % 32 == 0,
                "WMMA tiles need 32-byte aligned shared memory");
  static_assert(bytes <= 48 * 1024, "static shared memory limit");
};

template <int BM, typename TOut>
__global__ void __launch_bounds__(kThreads) int4_matmul_kernel(
    const bf16* __restrict__ x,          // [M, ldx]: halves at 0 and K2
    const uint8_t* __restrict__ packed,  // [K2, N]
    const float* __restrict__ scale,     // [N]
    TOut* __restrict__ out,              // [M, N]
    float* __restrict__ partial,         // [splits, M, N] or nullptr
    int M, int N, int K2, int ldx, int steps_per_split) {
  using L = Tile<BM>;
  __shared__ __align__(128) unsigned char smem[L::bytes];
  bf16* xh_s = reinterpret_cast<bf16*>(smem + L::xh);
  bf16* xl_s = reinterpret_cast<bf16*>(smem + L::xl);
  bf16* wh_s = reinterpret_cast<bf16*>(smem + L::wh);
  bf16* wl_s = reinterpret_cast<bf16*>(smem + L::wl);

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int s0 = split * steps_per_split;
  const int s1 = min(K2 / kBK2, s0 + steps_per_split);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp / L::WARPS_N;
  const int wn = warp % L::WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[L::FM][L::FN];
#pragma unroll
  for (int i = 0; i < L::FM; ++i)
#pragma unroll
    for (int j = 0; j < L::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int s = s0; s < s1; ++s) {
    const int k0 = s * kBK2;
    // the packed tile: 16 bytes a load, unpacked into both nibble planes
    for (int i = tid; i < kBK2 * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16);
      const int c = (i - r * (kBN / 16)) * 16;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          packed + (size_t)(k0 + r) * N + n0 + c);
      const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
      Pack hi, lo;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // bytes 2j and 2j + 1 (little-endian within each word)
        const int p0 = (words[j / 2] >> (16 * (j % 2))) & 0xFF;
        const int p1 = (words[j / 2] >> (16 * (j % 2) + 8)) & 0xFF;
        hi.h[j] = __floats2bfloat162_rn((float)((p0 >> 4) - 8),
                                        (float)((p1 >> 4) - 8));
        lo.h[j] = __floats2bfloat162_rn((float)((p0 & 0xF) - 8),
                                        (float)((p1 & 0xF) - 8));
      }
      uint4* dh = reinterpret_cast<uint4*>(wh_s + r * L::LDW + c);
      uint4* dl = reinterpret_cast<uint4*>(wl_s + r * L::LDW + c);
      dh[0] = hi.v[0];
      dh[1] = hi.v[1];
      dl[0] = lo.v[0];
      dl[1] = lo.v[1];
    }
    // x's two 32-column slices, 8 values a load; rows >= M stage zeros
    for (int i = tid; i < BM * (kBK2 / 8); i += kThreads) {
      const int r = i / (kBK2 / 8);
      const int c = (i - r * (kBK2 / 8)) * 8;
      uint4 vh = make_uint4(0u, 0u, 0u, 0u);
      uint4 vl = vh;
      if (m0 + r < M) {
        const bf16* row = x + (size_t)(m0 + r) * ldx;
        vh = *reinterpret_cast<const uint4*>(row + k0 + c);
        vl = *reinterpret_cast<const uint4*>(row + K2 + k0 + c);
      }
      *reinterpret_cast<uint4*>(xh_s + r * L::LDX + c) = vh;
      *reinterpret_cast<uint4*>(xl_s + r * L::LDX + c) = vl;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK2; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
          ah[L::FM], al[L::FM];
#pragma unroll
      for (int i = 0; i < L::FM; ++i) {
        const int r = wm * L::WM + i * 16;
        wmma::load_matrix_sync(ah[i], xh_s + r * L::LDX + kk, L::LDX);
        wmma::load_matrix_sync(al[i], xl_s + r * L::LDX + kk, L::LDX);
      }
#pragma unroll
      for (int j = 0; j < L::FN; ++j) {
        const int c = wn * L::WN + j * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bh,
            bl;
        wmma::load_matrix_sync(bh, wh_s + kk * L::LDW + c, L::LDW);
        wmma::load_matrix_sync(bl, wl_s + kk * L::LDW + c, L::LDW);
#pragma unroll
        for (int i = 0; i < L::FM; ++i) {
          wmma::mma_sync(acc[i][j], ah[i], bh, acc[i][j]);
          wmma::mma_sync(acc[i][j], al[i], bl, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: fragments -> shared fp32 tile -> coalesced stores
  float* c_s = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < L::FM; ++i)
#pragma unroll
    for (int j = 0; j < L::FN; ++j)
      wmma::store_matrix_sync(
          c_s + (wm * L::WM + i * 16) * L::LDC + wn * L::WN + j * 16,
          acc[i][j], L::LDC, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < BM * kBN; i += kThreads) {
    const int r = i / kBN;
    const int c = i - r * kBN;
    if (m0 + r >= M) continue;
    const float v = c_s[r * L::LDC + c];
    const size_t o = (size_t)(m0 + r) * N + n0 + c;
    if (partial != nullptr)
      partial[(size_t)split * M * N + o] = v;
    else
      out[o] = from_f<TOut>(v * scale[n0 + c]);
  }
}

// out = (sum over splits of the partial sums, in split order) * scale
template <typename TOut>
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     const float* __restrict__ scale,
                                     TOut* __restrict__ out, int M, int N,
                                     int splits) {
  const size_t mn = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mn) return;
  float s = 0.f;
  for (int z = 0; z < splits; ++z) s += partial[(size_t)z * mn + i];
  out[i] = from_f<TOut>(s * scale[i % N]);
}

template <int BM, typename TOut>
cudaError_t launch(const bf16* x, const uint8_t* packed, const float* scale,
                   TOut* out, float* work, int M, int N, int K2, int ldx,
                   int splits, cudaStream_t stream) {
  const int steps = K2 / kBK2;
  const int per = (steps + splits - 1) / splits;
  const int used = (steps + per - 1) / per;   // no empty split
  dim3 grid(N / kBN, (M + BM - 1) / BM, used);
  int4_matmul_kernel<BM, TOut><<<grid, kThreads, 0, stream>>>(
      x, packed, scale, out, used > 1 ? work : nullptr, M, N, K2, ldx, per);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || used == 1) return e;
  const size_t mn = (size_t)M * N;
  reduce_splits_kernel<TOut><<<(unsigned)((mn + 255) / 256), 256, 0,
                               stream>>>(work, scale, out, M, N, used);
  return cudaGetLastError();
}

template <typename TOut>
cudaError_t dispatch(const bf16* x, const uint8_t* packed,
                     const float* scale, void* out, float* work, int M,
                     int N, int K2, int ldx, int splits,
                     cudaStream_t stream) {
  TOut* o = static_cast<TOut*>(out);
  if (M <= 16)
    return launch<16, TOut>(x, packed, scale, o, work, M, N, K2, ldx, splits,
                            stream);
  return launch<64, TOut>(x, packed, scale, o, work, M, N, K2, ldx, splits,
                          stream);
}

}  // namespace

// x [M, ldx] bf16 (halves at columns 0 and K2), packed [K2, N] uint8,
// scale [N] fp32, out [M, N] (out_dtype 0 = float32, 1 = bfloat16), work
// [splits, M, N] fp32 when splits > 1. Needs K2 % 32 == 0, N % 128 == 0,
// ldx % 8 == 0 and 16-byte aligned x and packed. Returns
// cudaGetLastError() after the launches.
extern "C" int int4_matmul(const void* x, const void* packed,
                           const void* scale, void* out, void* work, int M,
                           int N, int K2, int ldx, int splits, int out_dtype,
                           void* stream) {
  if (M <= 0 || N % kBN || K2 % kBK2 || ldx % 8 || splits < 1)
    return (int)cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const uint8_t* pk = static_cast<const uint8_t*>(packed);
  const float* sc = static_cast<const float*>(scale);
  float* w = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_dtype == 1)
    return (int)dispatch<bf16>(xb, pk, sc, out, w, M, N, K2, ldx, splits, s);
  if (out_dtype == 0)
    return (int)dispatch<float>(xb, pk, sc, out, w, M, N, K2, ldx, splits, s);
  return (int)cudaErrorInvalidValue;
}
