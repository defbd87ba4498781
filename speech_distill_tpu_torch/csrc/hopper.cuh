// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// csrc/flash_fwd.cu and csrc/flash_bwd.cu, the lm-head kernels in
// csrc/lm_head_stats.cu and the int4 prefill in csrc/int4_matmul.cu:
// mbarriers, TMA loads through tensor maps, wgmma descriptors and
// products with fp32 accumulators in registers (B K-major or MN-major, up
// to 256 columns), the setmaxnreg split of a producer and
// consumer warpgroups, a ring of TMA stages and the k16 products of one
// stage, the query-tile walk of a block of two 64-row consumer
// warpgroups, and the epilogue that stores an accumulator as bf16 rows.
// Inline PTX only: no CUTLASS, nothing linked beyond the CUDA runtime
// (libcuda's cuTensorMapEncodeTiled is found through the runtime).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;          // rows of one consumer warpgroup
constexpr int kConsumers = 2;    // consumer warpgroups a block
constexpr int kBK = 128;         // rows of a K/V tile
constexpr int kBox = 64;         // bf16 columns of one 128-byte swizzle box
constexpr float kLog2e = 1.4426950408889634f;

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

// one box of a 2-D tensor map (T, rows) into shared memory
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
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

// a block of two consumer warpgroups and one producer warpgroup; ptxas
// budgets wgmma kernels by whole warpgroups, so a producer warp alone would
// leave 168 registers a thread. setmaxnreg moves the producer's to the
// consumers: 128 x 24 + 256 x 240 = 64,512 of the SM's 65,536.
constexpr int kThreadsWs = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
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
// (row + 8). _ss: A and B in shared memory, each K-major (TA, TB 0) or
// MN-major (1, the transpose bits); _rs: A from registers (the same layout
// as two k8 halves of the accumulator), B MN-major (n64: K-major at TB 0),
// always accumulating.
template <int TA = 0, int TB = 0>
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
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
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
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a,
                                             uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA = 0, int TB = 0>
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[128], uint64_t a,
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
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
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
      "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
      "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
      "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
      "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
      "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}

// D[64 x BN] (+)= A B from shared memory, BN in {64, 128, 256}
template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  if constexpr (BN == 256)
    wgmma_ss_n256<TA, TB>(d, a, b, scale_d);
  else if constexpr (BN == 128)
    wgmma_ss_n128<TA, TB>(d, a, b, scale_d);
  else
    wgmma_ss_n64<TA, TB>(d, a, b, scale_d);
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

template <int TB = 1>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
      "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
      "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TB));
}

// S[64 x N] = A B^T over DH in k16 steps, A [64][DH] and B [N][DH] both
// K-major in boxes of 64 columns (one 128-byte swizzle atom wide) that lie
// `a_box` / `b_box` bytes apart: a step moves 32 bytes inside a box, 8-row
// groups are 1024 bytes apart.
template <int DH, int N>
__device__ __forceinline__ void qk(float (&sc)[N / 2], uint32_t a_s,
                                   uint32_t a_box, uint32_t b_s,
                                   uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    const uint64_t a = smem_desc(a_s + (kk / 4) * a_box + off, 16, 1024);
    const uint64_t b = smem_desc(b_s + (kk / 4) * b_box + off, 16, 1024);
    if constexpr (N == 128)
      wgmma_ss_n128(sc, a, b, kk > 0);
    else
      wgmma_ss_n64(sc, a, b, kk > 0);
  }
}

// O[64 x DH] += P V over the ROWS rows of V in k16 steps, P in registers.
// V [ROWS][DH] is MN-major for this product (the transpose bit): a step is
// two 8-row swizzle atoms (2048 bytes), the next 64 columns of DH the next
// box (ROWS * 128 bytes on: the leading offset).
template <int DH, int ROWS>
__device__ __forceinline__ void pv(float (&acc)[DH / 2],
                                   const uint32_t (&p)[ROWS / 16][4],
                                   uint32_t v_s) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk) {
    const uint64_t b = smem_desc(v_s + kk * 2048, ROWS * 128, 1024);
    if constexpr (DH == 128)
      wgmma_rs_n128(acc, p[kk], b);
    else
      wgmma_rs_n64(acc, p[kk], b);
  }
}

// an fp32 accumulator [64 x N] in bf16 as the A fragments of the k16 steps
// over its N columns: the accumulator's registers 8 kk .. 8 kk + 7,
// pair-wise
template <int N>
__device__ __forceinline__ void to_bf16(const float (&sc)[N / 2],
                                        uint32_t (&p)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      p[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

// A ring of `stages` stages of `bytes` bytes from `data` (1024-aligned),
// each filled by TMA on its `full` barrier and handed back by the eight
// consumer warps on its `empty` barrier. Producer and consumers walk the
// same sequence of stages `it` = 0, 1, ...; round r of a stage waits for
// phase parity r & 1.
struct Ring {
  uint32_t data, bytes, full, empty;
  int stages;

  __device__ uint32_t stage(uint32_t it) const {
    return data + (it % stages) * bytes;
  }
  __device__ uint32_t parity(uint32_t it) const {
    return (it / stages) & 1;
  }
  // thread 0, before the block's __syncthreads; `warps` consumer warps
  // read each stage (each arrives once to free it)
  __device__ void init(uint32_t warps = kConsumers * 4) const {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // producer: waits until stage `it` is free (round 0 passes), announces
  // `tx` bytes on its full barrier and returns that barrier
  __device__ uint32_t acquire(uint32_t it, uint32_t tx) const {
    const uint32_t s = it % stages;
    mbar_wait(empty + 8 * s, parity(it) ^ 1);
    mbar_expect_tx(full + 8 * s, tx);
    return full + 8 * s;
  }
  __device__ void wait(uint32_t it) const {
    mbar_wait(full + 8 * (it % stages), parity(it));
  }
  __device__ void release(uint32_t it, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * (it % stages));
  }
};

// acc[64 x BN] (+)= A B over one 64-deep stage in k16 steps (the first
// step overwrites when `first`), each operand in 128-byte swizzled rows.
// K-major: 64 (A) or BN (B) rows of the stage's 64 k values, a k16 step
// 32 bytes on. MN-major (kAMN, kBMN): 64 k rows of 64 (A) or BN (B)
// values in boxes of 64 8192 bytes apart (the leading offset), a k16 step
// two 8-row swizzle atoms on.
template <int BN, bool kAMN, bool kBMN>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint32_t a_s,
                                          uint32_t b_s, bool first) {
#pragma unroll
  for (int kk = 0; kk < kBox / 16; ++kk) {
    const uint64_t a = kAMN ? smem_desc(a_s + kk * 2048, kBox * 128, 1024)
                            : smem_desc(a_s + kk * 32, 16, 1024);
    const uint64_t b = kBMN ? smem_desc(b_s + kk * 2048, kBox * 128, 1024)
                            : smem_desc(b_s + kk * 32, 16, 1024);
    wgmma_ss<BN, kAMN ? 1 : 0, kBMN ? 1 : 0>(acc, a, b,
                                             !(first && kk == 0));
  }
}

// acc = the product over `n_k` stages of `ring` from `it` on (advanced):
// A is the warpgroup's rows at `a_off` into each stage, B at `b_off`. No
// wgmma is in flight while the warpgroup waits on a barrier (a spin
// there makes ptxas serialize every wgmma).
template <int BN, bool kAMN, bool kBMN>
__device__ __forceinline__ void mainloop(float (&acc)[BN / 2],
                                         const Ring& ring, uint32_t& it,
                                         int n_k, uint32_t a_off,
                                         uint32_t b_off, int lane) {
  for (int ks = 0; ks < n_k; ++ks, ++it) {
    const uint32_t s = ring.stage(it);
    ring.wait(it);
    fence_regs(acc);
    wgmma_fence();
    mma_stage<BN, kAMN, kBMN>(acc, s + a_off, s + b_off, ks == 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    ring.release(it, lane);
  }
}

// the warpgroup's 64 x DH fp32 accumulator, each row times mult (rows r_a
// and r_a + 8 of thread t), as bf16 into rows row0 .. row0 + 63 of a
// 128-byte-swizzled tile in shared memory whose 64-column boxes lie
// `box` bytes apart (TMA's layout), then rows 0 .. n_rows - 1 of it stored
// whole, with 16-byte writes, to `out` (rows `stride` elements apart).
// `wg` names the warpgroup's named barrier.
template <int DH>
__device__ __forceinline__ void store_rows(const float (&acc)[DH / 2],
                                           const float (&mult)[2],
                                           unsigned char* tile, uint32_t box,
                                           int row0, bf16* out, size_t stride,
                                           int n_rows, int t, int wg) {
  const int lane = t % 32;
  const int r_a = (t / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + r_a + 8 * r;
      const int col = 8 * j + 2 * (lane % 4);
      const uint32_t off = (col / kBox) * box + row * 128 +
                           ((((col % kBox) / 8) ^ (row & 7)) * 16) +
                           (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(tile + off) =
          pack_bf16(acc[4 * j + 2 * r] * mult[r],
                    acc[4 * j + 2 * r + 1] * mult[r]);
    }
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  constexpr int kUnits = DH / 8;  // 16-byte units in a row
  for (int idx = t; idx < kBQ * kUnits; idx += 128) {
    const int row = idx / kUnits;
    const int u = idx % kUnits;
    if (row < n_rows) {
      const int srow = row0 + row;
      const uint32_t off =
          (u / 8) * box + srow * 128 + (((u % 8) ^ (srow & 7)) * 16);
      *reinterpret_cast<uint4*>(out + (size_t)row * stride + u * 8) =
          *reinterpret_cast<const uint4*>(tile + off);
    }
  }
}

// the query rows a block of the forward or the dq kernel works on:
// consumer c takes head h0 + c * dh, rows from r0 + c * dr, against n_k
// key tiles of KV head kvh of batch row b
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

// shapes the flash kernels take: whole 64-row tiles, KV dividing H
inline bool shapes_ok(int T, int H, int KV) {
  return T > 0 && T % kBQ == 0 && KV > 0 && H % KV == 0;
}

// blocks of the grid that block_work walks
inline int query_blocks(int B, int T, int H, int KV) {
  const int G = H / KV;
  return G % 2 == 0 ? (T / kBQ) * B * KV * (G / 2)
                    : (T + 2 * kBQ - 1) / (2 * kBQ) * B * H;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that
// nothing links against libcuda
inline EncodeTiled encode_tiled() {
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
inline bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
                     int Dh, int heads, int T, int B, int rows) {
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

// bf16 [rows, cols] with rows `ld` elements apart as the 2-D map
// (cols, rows): boxes of 64 columns x `box_rows` rows, 128-byte swizzle,
// zeros past cols and rows
inline bool make_bf16_map(EncodeTiled encode, CUtensorMap* map,
                          const void* ptr, int cols, int rows, int ld,
                          int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kBox, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// fp32 [rows, T] as the 2-D map (T, rows): boxes of `cols` values of one
// row, no swizzle
inline bool make_rows_map(EncodeTiled encode, CUtensorMap* map,
                          const void* ptr, int T, int rows, int cols) {
  const cuuint64_t dims[2] = {(cuuint64_t)T, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)T * 4};
  const cuuint32_t box[2] = {(cuuint32_t)cols, 1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
