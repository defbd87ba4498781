// One-pass elementwise kernels of the decoder layer for Hopper, sm_90a:
// RMSNorm, q/k RMSNorm + NeoX RoPE, and SwiGLU, each forward and backward.
//
// Replaces no Pallas kernel: the JAX package leaves these chains to XLA,
// which fuses them. Eager PyTorch runs every upcast, square, mean, rsqrt,
// product, half-slice, cat, silu and downcast as a kernel of its own that
// writes its result to device memory (~455 KB a token and layer at the
// 0.6B's widths). ops/fused_norm.py keeps those chains as the plain
// versions. Each kernel here reads its bf16 inputs once, computes in fp32
// registers, rounds to bf16 exactly where the plain versions round, and
// writes its bf16 outputs once (~50 KB a token and layer).
//
// What bounds them on the card: bytes. A few flops an element against 4-8
// bytes an element, far below the ~295 flop/byte where the tensor cores
// would bind. So:
//   * a row lives in registers: D values over kLanes lanes (8, 16 or 32),
//     each lane holding kLoads 16-byte pieces (8 bf16), neighbouring lanes
//     on neighbouring addresses; a row's sums are warp shuffles, and
//     nothing is staged in shared memory;
//   * a persistent grid (fused_norm_grid: at most kBlocksPerSM blocks of
//     kThreads an SM; the wrapper asks it, so the launch geometry lives
//     here alone) walks the rows, each warp taking 32 / kLanes rows at a
//     time;
//     the q/k kernel gives a warp one token (its H + KV heads, two head
//     rows of each lane group in flight), so the token's cos/sin are read
//     once;
//   * the backward passes recompute rstd and the normed value from the
//     saved bf16 input: no fp32 activation is kept between the passes;
//   * a scale's gradient (only where the scale trains) is summed in
//     registers a lane, across a block's warps in a fixed order in shared
//     memory, into one fp32 partial row a block that the wrapper sums: no
//     atomics, so every result is bitwise repeatable.
// Rounding (the plain versions' points): RMSNorm y = bf16((x rstd) w);
// the q/k kernel rounds the normed value to bf16 before the rotation and
// the rotation's gradient to bf16 before the norm's backward; SwiGLU
// h = bf16(bf16(silu(gate)) up). Products and sums that the plain versions
// round one by one use __fmul_rn / __fadd_rn, so the compiler fuses none.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 8;
// the widest RMSNorm row a warp holds in registers (32 lanes x 8 pieces of
// 8; the 1.7B's hidden 2,048)
constexpr int kMaxWidth = 2048;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]),
                    pack2(f[6], f[7]));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint4 ld16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void st16(bf16* p, const uint4& v) {
  *reinterpret_cast<uint4*>(p) = v;
}

// 8 fp32 values at p (32-byte aligned)
__device__ __forceinline__ void ld8f(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// the sum over a row's kLanes lanes, in every one of them
template <int kLanes>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// a bf16 row piece from the lane `o` away (the rotation's partner)
__device__ __forceinline__ uint4 shfl_xor16(uint4 v, int o) {
  v.x = __shfl_xor_sync(kFull, v.x, o);
  v.y = __shfl_xor_sync(kFull, v.y, o);
  v.z = __shfl_xor_sync(kFull, v.z, o);
  v.w = __shfl_xor_sync(kFull, v.w, o);
  return v;
}

// The block's fp32 partial of a scale gradient: acc holds each lane's sums
// for its columns (c = (i kLanes + lane % kLanes) 8 + j); summed over the
// warp's row groups by shuffles, then over the warps in warp order in
// shared memory (smem: D floats), and written to out[0, D). Every thread
// of the block calls it.
template <int kLanes, int kLoads>
__device__ void block_partial(float (&acc)[kLoads][8], float* smem,
                              float* out, int D) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane % kLanes;
#pragma unroll
  for (int i = 0; i < kLoads; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int o = kLanes; o < 32; o <<= 1)
        acc[i][j] += __shfl_xor_sync(kFull, acc[i][j], o);
  __syncthreads();   // smem may still be read by an earlier call
  for (int c = threadIdx.x; c < D; c += kThreads) smem[c] = 0.f;
  for (int w = 0; w < kWarps; ++w) {
    __syncthreads();
    if (warp == w && lane < kLanes) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int c = (i * kLanes + l) * 8;
        if (c < D) {
#pragma unroll
          for (int j = 0; j < 8; ++j) smem[c + j] += acc[i][j];
        }
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < D; c += kThreads) out[c] = smem[c];
}

// ---------------------------------------------------------------------------
// RMSNorm over rows of D (D % 8 == 0, D <= kLanes kLoads 8)
// ---------------------------------------------------------------------------

template <int kLanes, int kLoads>
__global__ void __launch_bounds__(kThreads) rms_norm_fwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    bf16* __restrict__ y, int rows, int D, float eps) {
  constexpr int kGroups = 32 / kLanes;
  const int lane = threadIdx.x & 31, l = lane % kLanes;
  const long long gw = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const long long nw = (long long)gridDim.x * kWarps;
  const float inv_d = 1.f / D;
  uint4 wv[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = (i * kLanes + l) * 8;
    wv[i] = c < D ? ld16(w + c) : make_uint4(0, 0, 0, 0);
  }
  for (long long r0 = gw * kGroups; r0 < rows; r0 += nw * kGroups) {
    const long long r = r0 + lane / kLanes;
    const bool ok = r < rows;
    uint4 xv[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = (i * kLanes + l) * 8;
      xv[i] = ok && c < D ? ld16(x + r * D + c) : make_uint4(0, 0, 0, 0);
    }
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float f[8];
      unpack(xv[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
    }
    const float rstd = rsqrtf(row_sum<kLanes>(ss) * inv_d + eps);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = (i * kLanes + l) * 8;
      if (ok && c < D) {
        float f[8], s[8];
        unpack(xv[i], f);
        unpack(wv[i], s);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          f[j] = __fmul_rn(__fmul_rn(f[j], rstd), s[j]);
        st16(y + r * D + c, pack(f));
      }
    }
  }
}

// dx = rstd (dy w) - x rstd^3 mean((dy w) x); with kDw, the block's partial
// of dw = sum over rows of dy (x rstd) into dw_part[blockIdx.x, :D]
template <int kLanes, int kLoads, bool kDw>
__global__ void __launch_bounds__(kThreads) rms_norm_bwd_kernel(
    const bf16* __restrict__ x, const bf16* __restrict__ w,
    const bf16* __restrict__ dy, bf16* __restrict__ dx,
    float* __restrict__ dw_part, int rows, int D, float eps) {
  extern __shared__ float smem[];
  constexpr int kGroups = 32 / kLanes;
  const int lane = threadIdx.x & 31, l = lane % kLanes;
  const long long gw = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const long long nw = (long long)gridDim.x * kWarps;
  const float inv_d = 1.f / D;
  uint4 wv[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int c = (i * kLanes + l) * 8;
    wv[i] = c < D ? ld16(w + c) : make_uint4(0, 0, 0, 0);
  }
  float acc[kLoads][8];
#pragma unroll
  for (int i = 0; i < kLoads; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (long long r0 = gw * kGroups; r0 < rows; r0 += nw * kGroups) {
    const long long r = r0 + lane / kLanes;
    const bool ok = r < rows;
    uint4 xv[kLoads], gv[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = (i * kLanes + l) * 8;
      const bool in = ok && c < D;
      xv[i] = in ? ld16(x + r * D + c) : make_uint4(0, 0, 0, 0);
      gv[i] = in ? ld16(dy + r * D + c) : make_uint4(0, 0, 0, 0);
    }
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      float f[8], g[8], s[8];
      unpack(xv[i], f);
      unpack(gv[i], g);
      unpack(wv[i], s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s1 += f[j] * f[j];
        s2 += __fmul_rn(g[j], s[j]) * f[j];
      }
    }
    const float rstd = rsqrtf(row_sum<kLanes>(s1) * inv_d + eps);
    const float cc = row_sum<kLanes>(s2) * rstd * rstd * rstd * inv_d;
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int c = (i * kLanes + l) * 8;
      float f[8], g[8], s[8], o[8];
      unpack(xv[i], f);
      unpack(gv[i], g);
      unpack(wv[i], s);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[j] = __fmul_rn(g[j], s[j]) * rstd - f[j] * cc;
        if (kDw) acc[i][j] += g[j] * __fmul_rn(f[j], rstd);
      }
      if (ok && c < D) st16(dx + r * D + c, pack(o));
    }
  }
  if constexpr (kDw)
    block_partial<kLanes, kLoads>(acc, smem,
                                  dw_part + (long long)blockIdx.x * D, D);
}

// ---------------------------------------------------------------------------
// q/k RMSNorm (kNorm) + NeoX RoPE over heads of kDh
// ---------------------------------------------------------------------------
// q [tokens, H, kDh], k [tokens, KV, kDh]; cos/sin fp32 [cos_rows, kDh],
// token t reading row t % cos_rows ([T, Dh] tables: cos_rows T; [B, T, Dh]:
// B T). A lane group of kDh / 8 lanes holds one head row; the partner of
// column i (i +- kDh / 2) sits kDh / 16 lanes away in the same group.

template <int kDh>
struct HeadLanes {
  static constexpr int kLanes = kDh / 8;
  static constexpr int kGroups = 32 / kLanes;
  static constexpr int kHalf = kLanes / 2;
};

// forward of one head row piece f (8 values, bf16-exact): normed and
// rounded (kNorm), then rotated with the partner's piece
template <int kDh, bool kNorm>
__device__ __forceinline__ uint4 norm_rope_piece(
    const uint4& xv, const uint4& wv, const float (&c)[8],
    const float (&s)[8], bool lower, float eps) {
  float f[8];
  unpack(xv, f);
  if (kNorm) {
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) ss += f[j] * f[j];
    const float rstd =
        rsqrtf(row_sum<HeadLanes<kDh>::kLanes>(ss) * (1.f / kDh) + eps);
    float sc[8];
    unpack(wv, sc);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      f[j] = round_bf16(__fmul_rn(__fmul_rn(f[j], rstd), sc[j]));
  }
  float p[8];
  unpack(shfl_xor16(pack(f), HeadLanes<kDh>::kHalf), p);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = __fmul_rn(f[j], c[j]), b = __fmul_rn(p[j], s[j]);
    f[j] = lower ? __fsub_rn(a, b) : __fadd_rn(a, b);
  }
  return pack(f);
}

template <int kDh, bool kNorm>
__global__ void __launch_bounds__(kThreads) qk_norm_rope_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    const bf16* __restrict__ wq, const bf16* __restrict__ wk,
    bf16* __restrict__ qo, bf16* __restrict__ ko, int tokens, int H, int KV,
    int cos_rows, float eps) {
  using HL = HeadLanes<kDh>;
  const int lane = threadIdx.x & 31, l = lane % HL::kLanes;
  const int grp = lane / HL::kLanes;
  const bool lower = l < HL::kHalf;
  const long long gw = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const long long nw = (long long)gridDim.x * kWarps;
  const int heads = H + KV;
  uint4 wqv = make_uint4(0, 0, 0, 0), wkv = wqv;
  if (kNorm) {
    wqv = ld16(wq + l * 8);
    wkv = ld16(wk + l * 8);
  }
  for (long long t = gw; t < tokens; t += nw) {
    float c[8], s[8];
    ld8f(cosv + (t % cos_rows) * kDh + l * 8, c);
    ld8f(sinv + (t % cos_rows) * kDh + l * 8, s);
    // two head rows of the group in flight: h and h + kGroups
    for (int h0 = 0; h0 < heads; h0 += 2 * HL::kGroups) {
      const int ha = h0 + grp, hb = ha + HL::kGroups;
      const bool oka = ha < heads, okb = hb < heads;
      const long long oa = ha < H ? (t * H + ha) * kDh
                                  : (t * KV + ha - H) * kDh;
      const long long ob = hb < H ? (t * H + hb) * kDh
                                  : (t * KV + hb - H) * kDh;
      const uint4 za = make_uint4(0, 0, 0, 0);
      const uint4 xa = oka ? ld16((ha < H ? q : k) + oa + l * 8) : za;
      const uint4 xb = okb ? ld16((hb < H ? q : k) + ob + l * 8) : za;
      const uint4 ya = norm_rope_piece<kDh, kNorm>(xa, ha < H ? wqv : wkv, c,
                                                   s, lower, eps);
      const uint4 yb = norm_rope_piece<kDh, kNorm>(xb, hb < H ? wqv : wkv, c,
                                                   s, lower, eps);
      if (oka) st16((ha < H ? qo : ko) + oa + l * 8, ya);
      if (okb) st16((hb < H ? qo : ko) + ob + l * 8, yb);
    }
  }
}

// backward of one head row piece: the rotation's gradient
// d[i] = g[i] c[i] +- g[i +- h] s[i +- h] rounded to bf16 (the plain
// rope's bf16 input), then (kNorm) the norm's backward from the bf16 input
// x; with kDw the scale's gradient d (x rstd) is added to accq (a q head,
// isq) or acck
template <int kDh, bool kNorm, bool kDw>
__device__ __forceinline__ uint4 norm_rope_piece_bwd(
    const uint4& xv, const uint4& gv, const uint4& wv, const float (&c)[8],
    const float (&sp)[8], bool lower, float eps, bool isq,
    float (&accq)[1][8], float (&acck)[1][8]) {
  float g[8], gp[8], d[8];
  unpack(gv, g);
  unpack(shfl_xor16(gv, HeadLanes<kDh>::kHalf), gp);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float a = __fmul_rn(g[j], c[j]), b = __fmul_rn(gp[j], sp[j]);
    d[j] = round_bf16(lower ? __fadd_rn(a, b) : __fsub_rn(a, b));
  }
  if (!kNorm) return pack(d);
  float f[8], sc[8];
  unpack(xv, f);
  unpack(wv, sc);
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    s1 += f[j] * f[j];
    s2 += __fmul_rn(d[j], sc[j]) * f[j];
  }
  constexpr float inv_d = 1.f / kDh;
  const float rstd =
      rsqrtf(row_sum<HeadLanes<kDh>::kLanes>(s1) * inv_d + eps);
  const float cc =
      row_sum<HeadLanes<kDh>::kLanes>(s2) * rstd * rstd * rstd * inv_d;
  float o[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[j] = __fmul_rn(d[j], sc[j]) * rstd - f[j] * cc;
    if (kDw) {
      const float v = d[j] * __fmul_rn(f[j], rstd);
      accq[0][j] += isq ? v : 0.f;
      acck[0][j] += isq ? 0.f : v;
    }
  }
  return pack(o);
}

// dq, dk from q, k (the bf16 inputs) and dqo, dko; with kDw the block's
// partials of dwq and dwk into dw_part[blockIdx.x, 0 / 1, :kDh]
template <int kDh, bool kNorm, bool kDw>
__global__ void __launch_bounds__(kThreads) qk_norm_rope_bwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ dqo, const bf16* __restrict__ dko,
    const float* __restrict__ cosv, const float* __restrict__ sinv,
    const bf16* __restrict__ wq, const bf16* __restrict__ wk,
    bf16* __restrict__ dq, bf16* __restrict__ dk,
    float* __restrict__ dw_part, int tokens, int H, int KV, int cos_rows,
    float eps) {
  __shared__ float smem[kDh];
  using HL = HeadLanes<kDh>;
  const int lane = threadIdx.x & 31, l = lane % HL::kLanes;
  const int grp = lane / HL::kLanes;
  const bool lower = l < HL::kHalf;
  const long long gw = (blockIdx.x * (long long)kThreads + threadIdx.x) >> 5;
  const long long nw = (long long)gridDim.x * kWarps;
  const int heads = H + KV;
  uint4 wqv = make_uint4(0, 0, 0, 0), wkv = wqv;
  if (kNorm) {
    wqv = ld16(wq + l * 8);
    wkv = ld16(wk + l * 8);
  }
  float accq[1][8], acck[1][8];
#pragma unroll
  for (int j = 0; j < 8; ++j) accq[0][j] = acck[0][j] = 0.f;
  for (long long t = gw; t < tokens; t += nw) {
    float c[8], s[8], sp[8];
    ld8f(cosv + (t % cos_rows) * kDh + l * 8, c);
    ld8f(sinv + (t % cos_rows) * kDh + l * 8, s);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      sp[j] = __shfl_xor_sync(kFull, s[j], HL::kHalf);
    for (int h0 = 0; h0 < heads; h0 += 2 * HL::kGroups) {
      const int ha = h0 + grp, hb = ha + HL::kGroups;
      const bool oka = ha < heads, okb = hb < heads;
      const long long oa = ha < H ? (t * H + ha) * kDh
                                  : (t * KV + ha - H) * kDh;
      const long long ob = hb < H ? (t * H + hb) * kDh
                                  : (t * KV + hb - H) * kDh;
      const uint4 za = make_uint4(0, 0, 0, 0);
      const uint4 xa = kNorm && oka ? ld16((ha < H ? q : k) + oa + l * 8) : za;
      const uint4 xb = kNorm && okb ? ld16((hb < H ? q : k) + ob + l * 8) : za;
      const uint4 ga = oka ? ld16((ha < H ? dqo : dko) + oa + l * 8) : za;
      const uint4 gb = okb ? ld16((hb < H ? dqo : dko) + ob + l * 8) : za;
      // a row past the heads reads zeros and adds nothing to the partials
      const uint4 ya = norm_rope_piece_bwd<kDh, kNorm, kDw>(
          xa, ga, ha < H ? wqv : wkv, c, sp, lower, eps, ha < H, accq, acck);
      const uint4 yb = norm_rope_piece_bwd<kDh, kNorm, kDw>(
          xb, gb, hb < H ? wqv : wkv, c, sp, lower, eps, hb < H, accq, acck);
      if (oka) st16((ha < H ? dq : dk) + oa + l * 8, ya);
      if (okb) st16((hb < H ? dq : dk) + ob + l * 8, yb);
    }
  }
  if constexpr (kDw) {
    float* out = dw_part + (long long)blockIdx.x * 2 * kDh;
    block_partial<HL::kLanes, 1>(accq, smem, out, kDh);
    block_partial<HL::kLanes, 1>(acck, smem, out + kDh, kDh);
  }
}

// ---------------------------------------------------------------------------
// SwiGLU: h = bf16(bf16(silu(gate)) up), over n8 pieces of 8 values
// ---------------------------------------------------------------------------

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

__global__ void __launch_bounds__(kThreads) swiglu_fwd_kernel(
    const bf16* __restrict__ gate, const bf16* __restrict__ up,
    bf16* __restrict__ h, long long n8) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n8;
       i += 2 * stride) {
    const bool two = i + stride < n8;
    const uint4 za = make_uint4(0, 0, 0, 0);
    const uint4 ga = ld16(gate + i * 8), ua = ld16(up + i * 8);
    const uint4 gb = two ? ld16(gate + (i + stride) * 8) : za;
    const uint4 ub = two ? ld16(up + (i + stride) * 8) : za;
    float g[8], u[8];
    unpack(ga, g);
    unpack(ua, u);
#pragma unroll
    for (int j = 0; j < 8; ++j) g[j] = __fmul_rn(round_bf16(silu(g[j])), u[j]);
    st16(h + i * 8, pack(g));
    if (two) {
      unpack(gb, g);
      unpack(ub, u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        g[j] = __fmul_rn(round_bf16(silu(g[j])), u[j]);
      st16(h + (i + stride) * 8, pack(g));
    }
  }
}

// dup = bf16(dh bf16(silu(gate))), dg = bf16(dh up),
// dgate = bf16(dg sigmoid(gate) (1 + gate (1 - sigmoid(gate))))
__device__ __forceinline__ void swiglu_bwd_piece(const uint4& gv,
                                                 const uint4& uv,
                                                 const uint4& hv, uint4& dgv,
                                                 uint4& duv) {
  float g[8], u[8], d[8], dg[8], du[8];
  unpack(gv, g);
  unpack(uv, u);
  unpack(hv, d);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float sg = sigmoid(g[j]);
    du[j] = __fmul_rn(d[j], round_bf16(silu(g[j])));
    const float dgj = round_bf16(__fmul_rn(d[j], u[j]));
    dg[j] = __fmul_rn(__fmul_rn(dgj, sg),
                      __fadd_rn(1.f, __fmul_rn(g[j], __fsub_rn(1.f, sg))));
  }
  dgv = pack(dg);
  duv = pack(du);
}

__global__ void __launch_bounds__(kThreads) swiglu_bwd_kernel(
    const bf16* __restrict__ gate, const bf16* __restrict__ up,
    const bf16* __restrict__ dh, bf16* __restrict__ dgate,
    bf16* __restrict__ dup, long long n8) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = blockIdx.x * (long long)kThreads + threadIdx.x; i < n8;
       i += stride) {
    uint4 dgv, duv;
    swiglu_bwd_piece(ld16(gate + i * 8), ld16(up + i * 8), ld16(dh + i * 8),
                     dgv, duv);
    st16(dgate + i * 8, dgv);
    st16(dup + i * 8, duv);
  }
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// the lanes a RMSNorm row of width D takes (8, 16 or 32); 0 for a width the
// kernels do not take
int row_lanes(int D) {
  if (D <= 0 || D % 8 || D > kMaxWidth) return 0;
  return D <= 64 ? 8 : D <= 128 ? 16 : 32;
}

// the row layout of a width: kLanes lanes a row, kLoads pieces a lane
template <typename F>
cudaError_t by_width(int D, F&& f) {
  const int lanes = row_lanes(D);
  if (lanes == 0) return cudaErrorInvalidValue;
  if (lanes == 8) return f.template go<8, 1>();
  if (lanes == 16) return f.template go<16, 1>();
  if (D <= 256) return f.template go<32, 1>();
  if (D <= 512) return f.template go<32, 2>();
  if (D <= 1024) return f.template go<32, 4>();
  return f.template go<32, 8>();
}

struct RmsFwd {
  const bf16 *x, *w;
  bf16* y;
  int rows, D;
  float eps;
  int blocks;
  cudaStream_t s;
  template <int kLanes, int kLoads>
  cudaError_t go() {
    rms_norm_fwd_kernel<kLanes, kLoads><<<blocks, kThreads, 0, s>>>(
        x, w, y, rows, D, eps);
    return cudaGetLastError();
  }
};

struct RmsBwd {
  const bf16 *x, *w, *dy;
  bf16* dx;
  float* dw_part;
  int rows, D;
  float eps;
  int blocks;
  cudaStream_t s;
  template <int kLanes, int kLoads>
  cudaError_t go() {
    if (dw_part != nullptr)
      rms_norm_bwd_kernel<kLanes, kLoads, true>
          <<<blocks, kThreads, D * sizeof(float), s>>>(x, w, dy, dx, dw_part,
                                                       rows, D, eps);
    else
      rms_norm_bwd_kernel<kLanes, kLoads, false><<<blocks, kThreads, 0, s>>>(
          x, w, dy, dx, nullptr, rows, D, eps);
    return cudaGetLastError();
  }
};

}  // namespace

// The persistent grid of a launch: blocks of kThreads enough for `units`,
// at most kBlocksPerSM an SM of `sms`. op 0: RMSNorm (units rows of width
// D; a warp takes 32 / lanes rows); 1: the q/k kernel (units tokens, a
// warp each; D the head size, 64 or 128); 2 and 3: SwiGLU's forward and
// backward (units values, D their last axis; a thread takes 2 pieces of 8
// forward, 1 backward). 0 where the op does not take D: the wrappers route
// and refuse on it.
extern "C" int fused_norm_grid(int op, long long units, int D, int sms) {
  long long per;
  if (op == 0) {
    const int lanes = row_lanes(D);
    if (lanes == 0) return 0;
    per = (long long)kWarps * (32 / lanes);
  } else if (op == 1) {
    if (D != 64 && D != 128) return 0;
    per = kWarps;
  } else if (op == 2 || op == 3) {
    if (D <= 0 || D % 8) return 0;
    units /= 8;
    per = (long long)kThreads * (op == 2 ? 2 : 1);
  } else {
    return 0;
  }
  const long long blocks = (units + per - 1) / per;
  const long long most = (long long)sms * kBlocksPerSM;
  return (int)(blocks < 1 ? 1 : blocks < most ? blocks : most);
}

// y [rows, D] = RMSNorm(x) w, all bf16; blocks from fused_norm_grid
extern "C" int rms_norm_fwd(const void* x, const void* w, void* y, int rows,
                            int D, float eps, int blocks, void* stream) {
  if (rows <= 0 || blocks < 1 || !aligned(x) || !aligned(w) || !aligned(y))
    return (int)cudaErrorInvalidValue;
  RmsFwd f{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
           static_cast<bf16*>(y), rows, D, eps, blocks,
           static_cast<cudaStream_t>(stream)};
  return (int)by_width(D, f);
}

// dx [rows, D] bf16; dw_part [blocks, D] fp32 partials of dw, or null for
// none
extern "C" int rms_norm_bwd(const void* x, const void* w, const void* dy,
                            void* dx, void* dw_part, int rows, int D,
                            float eps, int blocks, void* stream) {
  if (rows <= 0 || blocks < 1 || !aligned(x) || !aligned(w) ||
      !aligned(dy) || !aligned(dx))
    return (int)cudaErrorInvalidValue;
  RmsBwd f{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
           static_cast<const bf16*>(dy), static_cast<bf16*>(dx),
           static_cast<float*>(dw_part), rows, D, eps, blocks,
           static_cast<cudaStream_t>(stream)};
  return (int)by_width(D, f);
}

// qo, ko = RoPE(RMSNorm(q) wq), RoPE(RMSNorm(k) wk); wq and wk null: RoPE
// alone. q [tokens, H, Dh], k [tokens, KV, Dh] bf16, cos/sin fp32
// [cos_rows, Dh], Dh 64 or 128
extern "C" int qk_norm_rope_fwd(const void* q, const void* k, const void* cs,
                                const void* sn, const void* wq,
                                const void* wk, void* qo, void* ko,
                                int tokens, int H, int KV, int Dh,
                                int cos_rows, float eps, int blocks,
                                void* stream) {
  const bool norm = wq != nullptr;
  if (tokens <= 0 || H <= 0 || KV <= 0 || cos_rows <= 0 || blocks < 1 ||
      (Dh != 64 && Dh != 128) || norm != (wk != nullptr) || !aligned(q) ||
      !aligned(k) || !aligned(cs) || !aligned(sn) || !aligned(qo) ||
      !aligned(ko) || (norm && (!aligned(wq) || !aligned(wk))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const bf16*>(q), k_ = static_cast<const bf16*>(k);
  auto c_ = static_cast<const float*>(cs), s_ = static_cast<const float*>(sn);
  auto wq_ = static_cast<const bf16*>(wq), wk_ = static_cast<const bf16*>(wk);
  auto qo_ = static_cast<bf16*>(qo), ko_ = static_cast<bf16*>(ko);
#define SDT_QK_FWD(DH, NORM)                                                 \
  qk_norm_rope_fwd_kernel<DH, NORM><<<blocks, kThreads, 0, s>>>(             \
      q_, k_, c_, s_, wq_, wk_, qo_, ko_, tokens, H, KV, cos_rows, eps)
  if (Dh == 128) {
    if (norm) SDT_QK_FWD(128, true); else SDT_QK_FWD(128, false);
  } else {
    if (norm) SDT_QK_FWD(64, true); else SDT_QK_FWD(64, false);
  }
#undef SDT_QK_FWD
  return (int)cudaGetLastError();
}

// dq, dk from q, k, dqo, dko (wq / wk null: RoPE alone); dw_part
// [blocks, 2, Dh] fp32 partials of dwq and dwk, or null for none
extern "C" int qk_norm_rope_bwd(const void* q, const void* k, const void* dqo,
                                const void* dko, const void* cs,
                                const void* sn, const void* wq,
                                const void* wk, void* dq, void* dk,
                                void* dw_part, int tokens, int H, int KV,
                                int Dh, int cos_rows, float eps, int blocks,
                                void* stream) {
  const bool norm = wq != nullptr, dw = dw_part != nullptr;
  if (tokens <= 0 || H <= 0 || KV <= 0 || cos_rows <= 0 || blocks < 1 ||
      (Dh != 64 && Dh != 128) || norm != (wk != nullptr) || (dw && !norm) ||
      !aligned(dqo) || !aligned(dko) || !aligned(cs) || !aligned(sn) ||
      !aligned(dq) || !aligned(dk) ||
      (norm && (!aligned(q) || !aligned(k) || !aligned(wq) || !aligned(wk))))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto q_ = static_cast<const bf16*>(q), k_ = static_cast<const bf16*>(k);
  auto gq = static_cast<const bf16*>(dqo), gk = static_cast<const bf16*>(dko);
  auto c_ = static_cast<const float*>(cs), s_ = static_cast<const float*>(sn);
  auto wq_ = static_cast<const bf16*>(wq), wk_ = static_cast<const bf16*>(wk);
  auto dq_ = static_cast<bf16*>(dq), dk_ = static_cast<bf16*>(dk);
  auto p_ = static_cast<float*>(dw_part);
#define SDT_QK_BWD(DH, NORM, DW)                                             \
  qk_norm_rope_bwd_kernel<DH, NORM, DW><<<blocks, kThreads, 0, s>>>(         \
      q_, k_, gq, gk, c_, s_, wq_, wk_, dq_, dk_, p_, tokens, H, KV,         \
      cos_rows, eps)
  if (Dh == 128) {
    if (dw) SDT_QK_BWD(128, true, true);
    else if (norm) SDT_QK_BWD(128, true, false);
    else SDT_QK_BWD(128, false, false);
  } else {
    if (dw) SDT_QK_BWD(64, true, true);
    else if (norm) SDT_QK_BWD(64, true, false);
    else SDT_QK_BWD(64, false, false);
  }
#undef SDT_QK_BWD
  return (int)cudaGetLastError();
}

// h = bf16(bf16(silu(gate)) up) over n values (n % 8 == 0), all bf16
extern "C" int swiglu_fwd(const void* gate, const void* up, void* h, int n,
                          int blocks, void* stream) {
  if (n <= 0 || n % 8 || blocks < 1 || !aligned(gate) || !aligned(up) ||
      !aligned(h))
    return (int)cudaErrorInvalidValue;
  swiglu_fwd_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up),
      static_cast<bf16*>(h), n / 8);
  return (int)cudaGetLastError();
}

// dgate, dup from gate, up and dh, all bf16 over n values (n % 8 == 0)
extern "C" int swiglu_bwd(const void* gate, const void* up, const void* dh,
                          void* dgate, void* dup, int n, int blocks,
                          void* stream) {
  if (n <= 0 || n % 8 || blocks < 1 || !aligned(gate) || !aligned(up) ||
      !aligned(dh) || !aligned(dgate) || !aligned(dup))
    return (int)cudaErrorInvalidValue;
  swiglu_bwd_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(gate), static_cast<const bf16*>(up),
      static_cast<const bf16*>(dh), static_cast<bf16*>(dgate),
      static_cast<bf16*>(dup), n / 8);
  return (int)cudaGetLastError();
}
