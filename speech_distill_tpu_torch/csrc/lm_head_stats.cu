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
// is rounded to bf16 before the product, as the TPU kernels round it. The
// [N, V] logits never reach device memory in either direction.
//
// What bounds them on the card: tensor-core operations. At N 16,380,
// V 159,488, D 1024 the statistics are 2 N V D = 5.35 TFLOP and dh and dW
// 4 N V D each (the tile is recomputed), against ~0.4 GB of operands. Every
// product is a 16x16x16 bf16 WMMA with fp32 accumulation; the TPU design's
// [1024, 1024] fp32 VMEM tile does not fit an SM, so the tiling differs:
//   * stats: a block owns 128 rows and sweeps its share of the vocab in
//     128-column tiles; h and W stream through a two-stage cp.async ring of
//     32-deep slices. Taller rows halve the re-reads of W against 64-row
//     tiles, and the vocab is split over gridDim.y so that the whole grid is
//     one wave of two blocks an SM: blocks of one split sweep the same W
//     columns together and share them in L2. Each thread keeps the running
//     (max, sum) at T = 1 and at T and the label logit for half of one row;
//     the halves merge by a warp shuffle and the splits in a small combine
//     pass (lm_head_combine_kernel).
//   * dh and dW are one kernel with the roles of h and W swapped: a block
//     keeps 32 rows of one operand resident in shared memory and streams
//     32-row tiles of the other through a two-stage ring. Per tile: the
//     32 x 32 logits (8 warps: 4 fragments x 2 halves of D), then dl in
//     bf16, then acc += dl x tile. The [32, D] fp32 accumulator lives in
//     WMMA fragments in registers (128 a thread at D 1024), so D is never
//     split over blocks and each logit is computed once a kernel. dh sweeps
//     W (V/32 tiles for each of N/32 blocks); dW sweeps h, which stays in
//     L2. dW covers all V rows; the caller masks rows it does not train.
// Masking: columns >= V and rows >= N get no contribution (the TPU kernels
// mask padded columns with -1e30 and pad rows with label -1 and zero
// cotangents; the results are the same). Shared memory: stats ~106 KB a
// block (two an SM), dh/dW ~205 KB at D 1024 (one an SM). wgmma, TMA and a
// deeper pipeline are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol =
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragAcc = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 16 bytes global -> shared, asynchronously; zero-filled when !pred
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// K2-stats
// ---------------------------------------------------------------------------

constexpr int kSM = 128;       // rows of h a block
constexpr int kSN = 128;       // vocab columns a tile
constexpr int kSK = 32;        // depth of a staged slice
constexpr int kLDK = kSK + 8;  // bf16 row of a staged slice
constexpr int kLDZ = kSN + 4;  // fp32 row of the logits tile

struct StatsLayout {
  static constexpr size_t stage = (size_t)kSM * kLDK * 2;  // one operand
  static constexpr size_t a = 0;                // h slices, 2 stages
  static constexpr size_t b = a + 2 * stage;    // W slices, 2 stages
  static constexpr size_t z = b + 2 * stage;    // fp32 logits tile
  static constexpr size_t bytes = z + (size_t)kSM * kLDZ * 4;
  static_assert(stage % 32 == 0 && z % 32 == 0, "WMMA needs 32-byte tiles");
};

// stage the [128, 32] slices at depth k0 of h rows row0.. and W rows col0..
__device__ __forceinline__ void stats_stage(bf16* a_s, bf16* b_s,
                                            const bf16* h, const bf16* w,
                                            int row0, int col0, int k0,
                                            int N, int V, int D, int tid) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int i = tid + j * kThreads;   // 512 vectors of 8 per operand
    const int r = i >> 2;
    const int c = (i & 3) * 8;
    const bool ok_h = row0 + r < N;
    const bool ok_w = col0 + r < V;
    cp_async16(a_s + r * kLDK + c,
               ok_h ? h + (size_t)(row0 + r) * D + k0 + c : h, ok_h);
    cp_async16(b_s + r * kLDK + c,
               ok_w ? w + (size_t)(col0 + r) * D + k0 + c : w, ok_w);
  }
}

// one online-softmax update of (m, s) with the values x[0:n] / t
__device__ __forceinline__ void online(float& m, float& s, const float* x,
                                       int n, float cm, float t) {
  const float m_new = fmaxf(m, cm / t);
  float acc = 0.f;
  for (int c = 0; c < n; ++c) acc += expf(x[c] / t - m_new);
  s = s * expf(m - m_new) + acc;
  m = m_new;
}

__global__ void __launch_bounds__(kThreads, 2) lm_head_stats_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w,
    const int* __restrict__ labels, float* __restrict__ part, int N, int V,
    int D, float t) {
  using L = StatsLayout;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem + L::a);
  bf16* b_s = reinterpret_cast<bf16*>(smem + L::b);
  float* z_s = reinterpret_cast<float*>(smem + L::z);
  constexpr int kStage = kSM * kLDK;   // elements of one stage

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp & 3;     // this warp's 32 rows of the logits tile
  const int wn = warp >> 2;    // and its 64 columns
  const int row0 = blockIdx.x * kSM;
  const int split = blockIdx.y;
  const int n_vt = (V + kSN - 1) / kSN;
  const int per = (n_vt + gridDim.y - 1) / gridDim.y;
  const int vt0 = split * per;
  const int vt1 = min(n_vt, vt0 + per);
  const int nk = D / kSK;

  // running statistics of row r_loc over columns half*64 .. of each tile
  const int r_loc = tid >> 1;
  const int half = tid & 1;
  const int row = row0 + r_loc;
  const int label = row < N ? labels[row] : -1;
  float m1 = kNegInf, s1 = 0.f, mt = kNegInf, st = 0.f, lab = kNegInf;

  if (vt0 < vt1) {
    stats_stage(a_s, b_s, h, w, row0, vt0 * kSN, 0, N, V, D, tid);
    cp_async_commit();
  }
  for (int vt = vt0; vt < vt1; ++vt) {
    const int col0 = vt * kSN;
    FragAcc acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int kc = 0; kc < nk; ++kc) {
      const int cur = kc & 1;
      if (kc + 1 < nk) {
        const int nxt = cur ^ 1;
        stats_stage(a_s + nxt * kStage, b_s + nxt * kStage, h, w, row0, col0,
                    (kc + 1) * kSK, N, V, D, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bf16* a = a_s + cur * kStage;
      const bf16* b = b_s + cur * kStage;
#pragma unroll
      for (int kk = 0; kk < kSK / 16; ++kk) {
        FragA fa[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a + (wm * 32 + i * 16) * kLDK + kk * 16,
                                 kLDK);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          FragBCol fb;
          wmma::load_matrix_sync(fb, b + (wn * 64 + j * 16) * kLDK + kk * 16,
                                 kLDK);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb,
                                                     acc[i][j]);
        }
      }
      __syncthreads();   // this stage is refilled two slices later
    }
    // the next tile's first slice loads while this tile is reduced
    if (vt + 1 < vt1) {
      stats_stage(a_s, b_s, h, w, row0, col0 + kSN, 0, N, V, D, tid);
      cp_async_commit();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(
            z_s + (wm * 32 + i * 16) * kLDZ + wn * 64 + j * 16, acc[i][j],
            kLDZ, wmma::mem_row_major);
    __syncthreads();

    const int c0 = col0 + half * 64;
    const int n = min(64, V - c0);   // valid columns of this thread's half
    if (n > 0) {
      const float* x = z_s + r_loc * kLDZ + half * 64;
      float cm = kNegInf;
      for (int c = 0; c < n; ++c) cm = fmaxf(cm, x[c]);
      online(m1, s1, x, n, cm, 1.f);
      online(mt, st, x, n, cm, t);
      const int lc = label - c0;
      if (lc >= 0 && lc < n) lab = fmaxf(lab, x[lc]);
    }
    __syncthreads();   // z_s is rewritten by the next tile
  }

  // merge the two halves of each row (neighbouring lanes)
  const float pm1 = __shfl_xor_sync(0xffffffffu, m1, 1);
  const float ps1 = __shfl_xor_sync(0xffffffffu, s1, 1);
  const float pmt = __shfl_xor_sync(0xffffffffu, mt, 1);
  const float pst = __shfl_xor_sync(0xffffffffu, st, 1);
  const float plab = __shfl_xor_sync(0xffffffffu, lab, 1);
  if (half == 0 && row < N) {
    const float m = fmaxf(m1, pm1);
    const float mm = fmaxf(mt, pmt);
    float* p = part + (size_t)split * 5 * N + row;
    p[0] = m;
    p[(size_t)N] = s1 * expf(m1 - m) + ps1 * expf(pm1 - m);
    p[(size_t)2 * N] = mm;
    p[(size_t)3 * N] = st * expf(mt - mm) + pst * expf(pmt - mm);
    p[(size_t)4 * N] = fmaxf(lab, plab);
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

// ---------------------------------------------------------------------------
// K2-dh and K2-dW
// ---------------------------------------------------------------------------

constexpr int kRows = 32;        // resident rows a block, streamed rows a tile
constexpr int kLDZB = kRows + 4;  // fp32 row of a logits half
constexpr int kLDP = kRows + 8;   // bf16 row of dl

template <int D>
struct BwdLayout {
  static constexpr int LD = D + 8;                    // bf16 operand row
  static constexpr size_t tile = (size_t)kRows * LD * 2;
  static constexpr size_t r = 0;                      // resident rows
  static constexpr size_t s = r + tile;               // streamed, 2 stages
  static constexpr size_t z = s + 2 * tile;           // 2 halves of logits
  static constexpr size_t p = z + 2 * (size_t)kRows * kLDZB * 4;
  static constexpr size_t bytes = p + (size_t)kRows * kLDP * 2;
  static_assert(tile % 32 == 0 && z % 32 == 0 && p % 32 == 0,
                "WMMA needs 32-byte tiles");
  static_assert((size_t)kRows * (D + 4) * 4 <= 2 * tile,
                "the epilogue staging reuses the streamed stages");
};

// rows row0 .. row0 + 31 of a [nrows, D] bf16 matrix into shared memory
template <int D>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src,
                                           int row0, int nrows, int tid) {
  constexpr int kVec = D / 8;
  constexpr int LD = BwdLayout<D>::LD;
  for (int i = tid; i < kRows * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i - r * kVec) * 8;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * LD + c, ok ? src + (size_t)(row0 + r) * D + c : src,
               ok);
  }
}

// kTokRes: the resident operand is h (dh: rows are tokens, tiles sweep the
// vocab); else W (dW: rows are vocab entries, tiles sweep the tokens)
template <int D, bool kTokRes>
__global__ void __launch_bounds__(kThreads, 1) lm_head_bwd_kernel(
    const bf16* __restrict__ h, const bf16* __restrict__ w,
    const int* __restrict__ labels, const float* __restrict__ lse1,
    const float* __restrict__ lset, const float* __restrict__ a1,
    const float* __restrict__ at, const float* __restrict__ b,
    bf16* __restrict__ out, int N, int V, float t) {
  using L = BwdLayout<D>;
  constexpr int LD = L::LD;
  constexpr int FR = D / 64;   // accumulator fragments a warp
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* r_s = reinterpret_cast<bf16*>(smem + L::r);
  bf16* s_s = reinterpret_cast<bf16*>(smem + L::s);
  float* z_s = reinterpret_cast<float*>(smem + L::z);
  bf16* p_s = reinterpret_cast<bf16*>(smem + L::p);
  constexpr int kStage = kRows * LD;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int zf = warp & 3;     // logits fragment: rows (zf>>1)*16, cols (zf&1)*16
  const int zk = warp >> 2;    // and half of D
  const int ar = warp & 1;     // accumulator rows ar*16 ..
  const int ac = (warp >> 1) * FR;   // and column fragments ac .. ac + FR
  const int r0 = blockIdx.x * kRows;
  const int res_rows = kTokRes ? N : V;
  const int str_rows = kTokRes ? V : N;
  const bf16* res = kTokRes ? h : w;
  const bf16* str = kTokRes ? w : h;
  const int n_tiles = (str_rows + kRows - 1) / kRows;

  stage_rows<D>(r_s, res, r0, res_rows, tid);
  cp_async_commit();
  stage_rows<D>(s_s, str, 0, str_rows, tid);
  cp_async_commit();

  FragAcc acc[FR];
#pragma unroll
  for (int f = 0; f < FR; ++f) wmma::fill_fragment(acc[f], 0.f);

  for (int ti = 0; ti < n_tiles; ++ti) {
    const bf16* cur = s_s + (ti & 1) * kStage;
    if (ti + 1 < n_tiles) {
      stage_rows<D>(s_s + ((ti + 1) & 1) * kStage, str, (ti + 1) * kRows,
                    str_rows, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    {   // z[zk] = resident x tile^T over this warp's half of D
      FragAcc zacc;
      wmma::fill_fragment(zacc, 0.f);
      const bf16* a = r_s + (zf >> 1) * 16 * LD + zk * (D / 2);
      const bf16* bb = cur + (zf & 1) * 16 * LD + zk * (D / 2);
#pragma unroll 8
      for (int kk = 0; kk < D / 32; ++kk) {
        FragA fa;
        FragBCol fb;
        wmma::load_matrix_sync(fa, a + kk * 16, LD);
        wmma::load_matrix_sync(fb, bb + kk * 16, LD);
        wmma::mma_sync(zacc, fa, fb, zacc);
      }
      wmma::store_matrix_sync(
          z_s + zk * kRows * kLDZB + (zf >> 1) * 16 * kLDZB + (zf & 1) * 16,
          zacc, kLDZB, wmma::mem_row_major);
    }
    __syncthreads();

    // dl in bf16: element (i, j) pairs resident row i with streamed row j
    for (int e = tid; e < kRows * kRows; e += kThreads) {
      const int i = e >> 5;
      const int j = e & 31;
      const int tok = kTokRes ? r0 + i : ti * kRows + j;
      const int col = kTokRes ? ti * kRows + j : r0 + i;
      float dl = 0.f;
      if (tok < N && col < V) {
        const float z = z_s[i * kLDZB + j] + z_s[kRows * kLDZB + i * kLDZB + j];
        dl = a1[tok] * expf(z - lse1[tok]) +
             (at[tok] / t) * expf(z / t - lset[tok]);
        if (col == labels[tok]) dl += b[tok];
      }
      p_s[i * kLDP + j] = __float2bfloat16(dl);
    }
    __syncthreads();

    // acc += dl x tile
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      FragA fa;
      wmma::load_matrix_sync(fa, p_s + ar * 16 * kLDP + kk * 16, kLDP);
#pragma unroll
      for (int f = 0; f < FR; ++f) {
        FragBRow fb;
        wmma::load_matrix_sync(fb, cur + kk * 16 * LD + (ac + f) * 16, LD);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
    __syncthreads();   // this stage is refilled by the next iteration
  }

  // fp32 accumulators -> staging (the free stream stages) -> bf16 rows
  constexpr int LDO = D + 4;
  float* stg = reinterpret_cast<float*>(smem + L::s);
#pragma unroll
  for (int f = 0; f < FR; ++f)
    wmma::store_matrix_sync(stg + ar * 16 * LDO + (ac + f) * 16, acc[f], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  __nv_bfloat162* out2 = reinterpret_cast<__nv_bfloat162*>(out);
  for (int e = tid; e < kRows * D / 2; e += kThreads) {
    const int r = e / (D / 2);
    const int c = (e - r * (D / 2)) * 2;
    if (r0 + r < res_rows)
      out2[((size_t)(r0 + r) * D + c) / 2] = __floats2bfloat162_rn(
          stg[r * LDO + c], stg[r * LDO + c + 1]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int D, bool kTokRes>
cudaError_t launch_bwd(const void* h, const void* w, const void* labels,
                       const void* lse1, const void* lset, const void* a1,
                       const void* at, const void* b, void* out, int N, int V,
                       float t, cudaStream_t stream) {
  const size_t smem = BwdLayout<D>::bytes;
  auto kernel = lm_head_bwd_kernel<D, kTokRes>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const int rows = kTokRes ? N : V;
  kernel<<<(rows + kRows - 1) / kRows, kThreads, smem, stream>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<const float*>(lse1),
      static_cast<const float*>(lset), static_cast<const float*>(a1),
      static_cast<const float*>(at), static_cast<const float*>(b),
      static_cast<bf16*>(out), N, V, t);
  return cudaGetLastError();
}

template <bool kTokRes>
int bwd_entry(const void* h, const void* w, const void* labels,
              const void* lse1, const void* lset, const void* a1,
              const void* at, const void* b, void* out, int N, int V, int D,
              float t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LM_HEAD_BWD(DIM)                                                      \
  if (D == DIM)                                                               \
    return (int)launch_bwd<DIM, kTokRes>(h, w, labels, lse1, lset, a1, at, b, \
                                         out, N, V, t, s);
  LM_HEAD_BWD(1024)
  LM_HEAD_BWD(512)
  LM_HEAD_BWD(256)
  LM_HEAD_BWD(128)
  LM_HEAD_BWD(64)
#undef LM_HEAD_BWD
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// bf16 h [N, D], W [V, D], int32 labels [N]; D % 32 == 0. `part` is fp32
// scratch [splits, 5, N]; writes fp32 lse1, lseT and label_logit [N].
// Returns cudaGetLastError() after the launches.
extern "C" int lm_head_stats(const void* h, const void* w, const void* labels,
                             void* part, void* lse1, void* lset, void* lab,
                             int N, int V, int D, int splits, float t,
                             void* stream) {
  if (D % kSK != 0 || splits < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = StatsLayout::bytes;
  cudaError_t e = allow_smem(lm_head_stats_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((N + kSM - 1) / kSM, splits);
  lm_head_stats_kernel<<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(h), static_cast<const bf16*>(w),
      static_cast<const int*>(labels), static_cast<float*>(part), N, V, D, t);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  lm_head_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(lse1),
      static_cast<float*>(lset), static_cast<float*>(lab), N, splits);
  return (int)cudaGetLastError();
}

// dh [N, D] bf16 from the cotangents a1, aT, b (fp32 [N]) of lse1, lseT
// and label_logit; D in {64, 128, 256, 512, 1024}.
extern "C" int lm_head_dh(const void* h, const void* w, const void* labels,
                          const void* lse1, const void* lset, const void* a1,
                          const void* at, const void* b, void* dh, int N,
                          int V, int D, float t, void* stream) {
  return bwd_entry<true>(h, w, labels, lse1, lset, a1, at, b, dh, N, V, D, t,
                         stream);
}

// dW [V, D] bf16, every row; as lm_head_dh otherwise.
extern "C" int lm_head_dw(const void* h, const void* w, const void* labels,
                          const void* lse1, const void* lset, const void* a1,
                          const void* at, const void* b, void* dw, int N,
                          int V, int D, float t, void* stream) {
  return bwd_entry<false>(h, w, labels, lse1, lset, a1, at, b, dw, N, V, D, t,
                          stream);
}
