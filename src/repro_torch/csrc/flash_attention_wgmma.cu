// K5, bf16 route: forward flash attention on the Hopper tensor cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:81
// `flash_attention` (body `_kernel`) for bf16 q (BH, Sq, dh), k (BH, Sk, dh)
// and v (BH, Sk, dv) whose head widths are multiples of 8 up to 256;
// kernels/flash_attention.py routes every other CUDA call to
// csrc/flash_attention.cu.  It computes what the Pallas body does:
// o = softmax((q k^T) scale) v with an fp32 online softmax, masked scores
// -1e30 (with `causal`, key col is seen by query row only where col <= row,
// top-left aligned), o = acc / max(l, 1e-37) rounded once to bf16.
//
// Design.  One CTA per (bh, 128-row q-tile), the q-tiles with the most
// k-tiles first; 384 threads in three warpgroups.
// - Warpgroup 2 produces: it drops to 40 registers (setmaxnreg), and one of
//   its threads loads Q once and streams K and V tiles through a 2-stage
//   ring with TMA, behind full / empty mbarriers.  The tensor maps are 3-D,
//   (d, S, BH) innermost first, so a ragged last tile is zero-filled within
//   its own head; they use the 128-byte swizzle that the wgmma descriptors
//   name.  Under `causal` the k loop stops at the last tile touching the
//   diagonal.
// - Warpgroups 0 and 1 consume, 64 q-rows each (wgmma's M), at 232
//   registers.  Per k-tile of BK keys:
//     S = Q K^T   wgmma m64nBKk16, both operands in shared memory, K-major,
//                 dh / 16 k-steps;
//     softmax     in registers: a thread owns 2 rows of S; the row max goes
//                 over the 4 threads of a quad by shuffles; exp2 with
//                 scale * log2(e) folded into one multiply; the mask (causal,
//                 and keys >= sk, whose zero-filled rows would score 0) only
//                 on tiles that cross the diagonal or sk; l sums the f32 p;
//     O += P V    the accumulator is rescaled by exp2(m_prev - m_new), then
//                 wgmma m64n(dv)k16 takes P from registers (the f32 layout
//                 of S is the bf16 A-fragment layout, two adjacent columns
//                 to one bf16x2 register) and V from shared memory MN-major
//                 (the transposed-B form).
// - The epilogue divides by max(l, 1e-37), rounds once to bf16 and stores
//   the rows < sq.
// Key tiles are 128 where two stages fit in shared memory and dv <= 192,
// else 64 (dv = 256 keeps its 128-float accumulator in registers).
//
// Precision.  P is carried as hi = bf16(p) and lo = bf16(p - hi), and both
// go through the tensor cores into one f32 accumulator, so p enters P V
// with about 16 significant bits instead of bf16's 8.  Rounding p to bf16
// alone, as FA2 / FA3 and cuDNN do, misses the full-width check of
// chip_smoke.py (one bf16 step of the output, the Pallas kernel's own
// contract with p in f32): in the first causal rows a query sees a few
// keys, the weighted V terms cancel, and bf16's 2^-9 relative error on p
// is large against the small |o|.  tests/test_torch_flash.py emulates
// this kernel's arithmetic and holds that contrast: the check passes with
// hi + lo and fails with p rounded to bf16.
//
// Bound on an H100: 2 live(row, col) (dh + dv) flop per head at 989 TFLOP/s
// bf16, against q, k, v read and o written once: 1.11 ms at qwen3-32b
// (BH 64, S 8192, 128/128, causal) and 0.695 ms at deepseek-v2 (BH 128,
// S 4096, 192/128).  P V costs two products, so this design's own floor is
// the bound x (dh + 2 dv) / (dh + dv): 1.67 and 0.97 ms.
#include <climits>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flash_wgmma {

constexpr int kThreads = 384;         // consumer warpgroups 0, 1; producer 2
constexpr int kBQ = 128;              // q-rows per CTA, 64 per consumer
constexpr int kStages = 2;            // depth of the K / V ring
constexpr int kRow = 128;             // bytes of one swizzled row: 64 bf16
constexpr int kMaxD = 256;
constexpr int kSmemLimit = 232448;    // shared memory a block may use
constexpr float kNegInf = -1.0e30f;   // flash_attention.py:27
constexpr float kMinL = 1e-37f;       // flash_attention.py:77
constexpr float kLog2e = 1.4426950408889634f;

// Q, then kStages x (K, V) tiles of `bk` keys, in 64-column blocks of
// rows x 128 bytes; 1024 bytes of slack to align the swizzle atoms; the
// mbarriers last
__host__ __device__ constexpr int smem_bytes(int dhb, int dvb, int bk) {
  return 1024 + dhb * kBQ * kRow + kStages * (dhb + dvb) * bk * kRow + 8 * (1 + 3 * kStages);
}
__host__ __device__ constexpr int key_tile(int dhb, int dvb) {
  return (dvb <= 3 && smem_bytes(dhb, dvb, 128) <= kSmemLimit) ? 128 : 64;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// wait until the phase with this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// box (64, rows, 1) of a (d, S, BH) tensor map at (c0, c1, c2) into dst
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], "
      "[%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, each >> 4
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving reads or writes of an accumulator across
// the wgmma fence / wait instructions
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) { return *reinterpret_cast<uint32_t*>(&x); }

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16.  _ss: A and B from shared
// memory, both K-major; _ss_zero overwrites d (its old value is no input,
// so S holds no registers between k-tiles); _rs: A from registers
// (4 x bf16x2), B MN-major (the transposed form).  Inline PTX names every
// accumulator register, so each N is written out.
__device__ __forceinline__ void wgmma_ss_zero_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_zero_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int N, bool ACC>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 64) {
    if constexpr (ACC) wgmma_ss_n64(d, da, db);
    else wgmma_ss_zero_n64(d, da, db);
  } else {
    if constexpr (ACC) wgmma_ss_n128(d, da, db);
    else wgmma_ss_zero_n128(d, da, db);
  }
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t db) {
  if constexpr (N == 64) wgmma_rs_n64(d, a, db);
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 192) wgmma_rs_n192(d, a, db);
  else wgmma_rs_n256(d, a, db);
}

// DHB, DVB: 64-column blocks of dh and dv (TMA zero-fills past dh and dv)
template <int DHB, int DVB>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int bh, int sq,
                   int sk, int dv, float scale_log2, int causal) {
  constexpr int BK = key_tile(DHB, DVB);
  constexpr int NV = 64 * DVB;                 // O's width in the tensor cores
  constexpr uint32_t Q_BYTES = DHB * kBQ * kRow;
  constexpr uint32_t K_BYTES = DHB * BK * kRow;
  constexpr uint32_t V_BYTES = DVB * BK * kRow;

  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t q_s = (smem_addr(smem) + 1023) & ~1023u;  // swizzle atoms are 1024 bytes
  const uint32_t k_s = q_s + Q_BYTES;                      // + stage * K_BYTES
  const uint32_t v_s = k_s + kStages * K_BYTES;            // + stage * V_BYTES
  const uint32_t q_full = v_s + kStages * V_BYTES;
  const uint32_t k_full = q_full + 8;                      // + 8 stage
  const uint32_t v_full = k_full + 8 * kStages;
  const uint32_t empty = v_full + 8 * kStages;

  // the last q-tiles (the most k-tiles under `causal`) are scheduled first
  const int nq = (sq + kBQ - 1) / kBQ;
  const int b = blockIdx.x % bh;
  const int q0 = (nq - 1 - (int)(blockIdx.x / bh)) * kBQ;
  int nk = (sk + BK - 1) / BK;
  if (causal) nk = min(nk, (min(q0 + kBQ, sq) - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(empty + 8 * s, 2 * 128);  // every consumer thread releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int d = 0; d < DHB; ++d) tma_load(q_s + d * kBQ * kRow, &tq, 64 * d, q0, b, q_full);
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        if (it >= kStages) mbar_wait(empty + 8 * s, (it / kStages - 1) & 1);
        mbar_expect_tx(k_full + 8 * s, K_BYTES);
        for (int d = 0; d < DHB; ++d)
          tma_load(k_s + s * K_BYTES + d * BK * kRow, &tk, 64 * d, it * BK, b, k_full + 8 * s);
        mbar_expect_tx(v_full + 8 * s, V_BYTES);
        for (int d = 0; d < DVB; ++d)
          tma_load(v_s + s * V_BYTES + d * BK * kRow, &tv, 64 * d, it * BK, b, v_full + 8 * s);
      }
    }
  } else {
    // consumers: 64 q-rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    const int rows0 = q0 + 64 * wg;                     // this warpgroup's first row
    const int row0 = rows0 + 16 * warp + lane / 4;      // this thread's rows: row0, row0 + 8
    const int colq = 2 * (lane % 4);                    // and columns 8 g + colq + {0, 1}
    const uint32_t q_wg = q_s + 64 * wg * kRow;

    // accumulator element j: row row0 + 8 ((j / 2) % 2), column 8 (j / 4) + colq + j % 2
    float o_acc[NV / 2];
#pragma unroll
    for (int j = 0; j < NV / 2; ++j) o_acc[j] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only

    mbar_wait(q_full, 0);
    for (int it = 0; it < nk; ++it) {
      const int s = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int k0 = it * BK;
      const uint32_t ks = k_s + s * K_BYTES, vs = v_s + s * V_BYTES;

      // S = Q K^T: 16 dims per step; a step moves 32 bytes within a
      // swizzled row, a 64-column block moves to the next block
      float s_acc[BK / 2];
      uint32_t p_hi[BK / 4], p_lo[BK / 4];
      mbar_wait(k_full + 8 * s, parity);
      wgmma_fence();
      wgmma_ss<BK, false>(s_acc, sw128_desc(q_wg, 16, 1024), sw128_desc(ks, 16, 1024));
#pragma unroll
      for (int t = 1; t < 4 * DHB; ++t)
        wgmma_ss<BK, true>(s_acc, sw128_desc(q_wg + (t / 4) * kBQ * kRow + (t % 4) * 32, 16, 1024),
                           sw128_desc(ks + (t / 4) * BK * kRow + (t % 4) * 32, 16, 1024));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s_acc);

      // online softmax in log2 units
      const bool edge = k0 + BK > sk || (causal && k0 + BK - 1 > rows0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BK / 2; ++j) {
        float x = s_acc[j] * scale_log2;
        if (edge) {
          const int col = k0 + 8 * (j / 4) + colq + j % 2;
          if (col >= sk || (causal && col > row0 + 8 * ((j / 2) % 2))) x = kNegInf;
        }
        s_acc[j] = x;
        mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], x);
      }
      float corr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        corr[h] = ex2(m[h] - mx[h]);
        m[h] = mx[h];
        l[h] *= corr[h];
      }
      // p as bf16 hi + lo; pair j / 2 is bf16x2 register j / 2 % 4 of k-step j / 8
#pragma unroll
      for (int j = 0; j < BK / 2; j += 2) {
        const int h = (j / 2) % 2;
        const float p0 = ex2(s_acc[j] - m[h]), p1 = ex2(s_acc[j + 1] - m[h]);
        l[h] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[j / 2] = bits(hi);
        p_lo[j / 2] = bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
#pragma unroll
      for (int j = 0; j < NV / 2; ++j) o_acc[j] *= corr[(j / 2) % 2];

      // O += P_hi V + P_lo V: 16 keys per step, 2048 bytes of V; the
      // leading byte offset steps over dv's 64-column blocks
      mbar_wait(v_full + 8 * s, parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dvk = sw128_desc(vs + kk * 16 * kRow, BK * kRow, 8 * kRow);
        wgmma_rs<NV>(o_acc, p_hi + 4 * kk, dvk);
        wgmma_rs<NV>(o_acc, p_lo + 4 * kk, dvk);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o_acc);
      mbar_arrive(empty + 8 * s);
    }

    // l over the quad, then o = acc / max(l, 1e-37) for rows < sq, cols < dv
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= sq) continue;
      const float denom = fmaxf(l[h], kMinL);
      __nv_bfloat16* orow = o + ((size_t)b * sq + row) * dv;
#pragma unroll
      for (int g = 0; g < NV / 8; ++g) {
        const int col = 8 * g + colq;
        if (col < dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o_acc[4 * g + 2 * h] / denom, o_acc[4 * g + 2 * h + 1] / denom);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

constexpr int kNoEncoder = -1;         // libcuda offers no cuTensorMapEncodeTiled
constexpr int kEncodeRefused = -1000;  // - CUresult of a refused encode

// libcuda's encoder, looked up through the runtime (this library does not link libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a contiguous (bh, rows, d) bf16 tensor as a (d, rows, bh) map of
// (64, box_rows, 1) boxes, 128-byte swizzle, zero fill out of bounds
int encode(CUtensorMap* map, const void* ptr, int d, int rows, int bh, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kNoEncoder;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)d * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeRefused - (int)r;
}

template <int DHB, int DVB>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int dh, int dv,
           float scale, int causal, cudaStream_t stream) {
  constexpr int BK = key_tile(DHB, DVB);
  constexpr int smem = smem_bytes(DHB, DVB, BK);
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, dh, sq, bh, kBQ);
  if (err == 0) err = encode(&tk, k, dh, sk, bh, BK);
  if (err == 0) err = encode(&tv, v, dv, sk, bh, BK);
  if (err != 0) return err;
  const cudaError_t attr =
      cudaFuncSetAttribute(flash_wgmma_kernel<DHB, DVB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const long long blocks = (long long)((sq + kBQ - 1) / kBQ) * bh;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_wgmma_kernel<DHB, DVB><<<(unsigned)blocks, kThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), bh, sq, sk, dv, scale * kLog2e, causal);
  return (int)cudaGetLastError();
}

template <int DHB>
int launch_dv(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk, int dh, int dv,
              float scale, int causal, cudaStream_t stream) {
  switch ((dv + 63) / 64) {
    case 1: return launch<DHB, 1>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, stream);
    case 2: return launch<DHB, 2>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, stream);
    case 3: return launch<DHB, 3>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, stream);
    default: return launch<DHB, 4>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, stream);
  }
}

}  // namespace flash_wgmma

// Launch on `stream` for contiguous bf16 q, k, v, o with 16-byte aligned
// data, dh and dv multiples of 8 in 8..256.  Returns 0 on success, a
// cudaError_t, -1 when libcuda offers no tensor-map encoder, or
// -1000 - CUresult when it refuses a tensor map.
extern "C" int flash_attention_wgmma_fwd(const void* q, const void* k, const void* v, void* o, int bh, int sq,
                                         int sk, int dh, int dv, float scale, int causal, void* stream) {
  using namespace flash_wgmma;
  if (bh < 1 || sq < 1 || sk < 1 || dh < 8 || dv < 8 || dh > kMaxD || dv > kMaxD || dh % 8 || dv % 8)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((dh + 63) / 64) {
    case 1: return launch_dv<1>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, st);
    case 2: return launch_dv<2>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, st);
    case 3: return launch_dv<3>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, st);
    default: return launch_dv<4>(q, k, v, o, bh, sq, sk, dh, dv, scale, causal, st);
  }
}
