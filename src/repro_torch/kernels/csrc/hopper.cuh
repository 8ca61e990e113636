// Hopper (sm_90a) building blocks for the warp-specialised kernels
// (flash_prefill.cu, etap_prefill.cu, etap_decode.cuh): shared-memory
// mbarriers, TMA tile loads through a tensor map, the wgmma shared-memory
// descriptor of a 128-byte-swizzled tile, wgmma products with their
// fences, stmatrix, named barriers, setmaxnreg, and the widening of a box
// of int8 / e4m3 codes in place to a bf16 box.
//
// Tiles.  A TMA box is 64 bf16 columns (128 bytes) by `rows` rows, laid
// out row after row with the 128-byte swizzle; a wider operand is several
// boxes, one after another.  A box of 1-byte codes is 64 codes (64 bytes)
// a row, unswizzled (code_rows_map): threads widen it into a bf16 box.  Every box starts on 1024 bytes (8 rows, the
// swizzle's period), so the descriptors' base offset is 0:
//   K-major (the k axis along the 128-byte row: Q, K): SBO = 1024 B from
//     one 8-row group to the next, LBO unused (1); the k16 step kk of a
//     box starts 32 kk bytes into it, and a 192-wide operand steps to the
//     next box after 4 of them.
//   MN-major (the n axis along the row: V, read transposed for P V):
//     SBO = 1024 B from one 8-row (k) group to the next, LBO = one box
//     (rows x 128 B) from one 64-column n block to the next; the k16 step
//     kk starts 16 kk rows (2048 kk bytes) in.  An A operand read MN-major
//     (V^T, the transpose-A bit set) takes the same descriptor: its 64 m
//     rows are one box's 64 columns.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers (shared::cta; one 8-byte word each)
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Make the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more to land through TMA.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: a wait on parity 1 passes at once).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n"
      :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---- TMA: one box of a 4-D tensor map at coordinates (c0, c1, c2, c3)
//      into dst (1024-byte aligned), completing on bar
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- wgmma
// The descriptor of a 128-byte-swizzled tile at p (see the header).
__device__ __forceinline__ uint64_t desc_sw128(const void* p,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// The same for a tile at shared-memory address addr (smem_u32).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr,
                                               uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         static_cast<uint64_t>((lbo_bytes >> 4) & 0x3fff) << 16 |
         static_cast<uint64_t>((sbo_bytes >> 4) & 0x3fff) << 32 |
         static_cast<uint64_t>(1) << 62;
}

// Order this warpgroup's register and shared-memory writes before the
// wgmma that follow (needed before a wgmma reads registers that ordinary
// code wrote, or accumulates into them).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of r across this point,
// and r's registers live up to it: an asynchronous product reads its
// register operands and writes its accumulator until wgmma_wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Move this warpgroup's register budget to R a thread (all its warps
// execute it together).
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(R));
}

// D[64 x 128] += A[64 x 16] B[128 x 16]^T: A and B K-major in shared
// memory (descriptors da, db).
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64],
                                                  uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] = A[64 x 16] B[128 x 16]^T, the first k16 step of a product
// (scale-d false: D's old values are not read, so they are dead here).
__device__ __forceinline__ void wgmma_ss_m64n128k16_first(float (&d)[64],
                                                        uint64_t da,
                                                        uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (each warp's
// 16 rows as the m16n8k16 A fragment), B MN-major in shared memory
// (descriptor db, the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (each warp's
// 16 rows as the m16n8k16 A fragment), B MN-major in shared memory
// (descriptor db, the transpose bit set).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 32] (+)= A[64 x 16] B[32 x 16]^T, A and B in shared memory
// (descriptors da, db): B K-major; A K-major, or MN-major with TA (the
// transpose-A bit).  FIRST: the first k16 step of a product (scale-d
// false: D's old values are not read, so they are dead here).
template <bool FIRST, bool TA>
__device__ __forceinline__ void wgmma_ss_m64n32k16(float (&d)[16],
                                                  uint64_t da, uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, %16, %17, p, 1, 1, %19, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15])
        : "l"(da), "l"(db), "r"(0), "n"(TA ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, %16, %17, p, 1, 1, %19, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(1), "n"(TA ? 1 : 0));
  }
}

// The same at N = 16.
template <bool FIRST, bool TA>
__device__ __forceinline__ void wgmma_ss_m64n16k16(float (&d)[8],
                                                  uint64_t da, uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7])
        : "l"(da), "l"(db), "r"(0), "n"(TA ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(1), "n"(TA ? 1 : 0));
  }
}

// The same at N = 64.
template <bool FIRST, bool TA>
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32],
                                                  uint64_t da, uint64_t db) {
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, "
        "0;\n}\n"
        : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
          "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
          "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
          "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
          "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
          "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
          "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
          "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
        : "l"(da), "l"(db), "r"(0), "n"(TA ? 1 : 0));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, "
        "0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1), "n"(TA ? 1 : 0));
  }
}

// Store four 8 x 8 bf16 matrices, transposed: r[i] is matrix i's mma
// fragment (lane l: row l / 4, columns 2 (l % 4) and + 1), and lane
// 8 i + j gives the shared-memory address of the 16 bytes that receive
// column j of matrix i (its 8 rows in order).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr,
                                                  const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], "
      "{%1, %2, %3, %4};\n"
      :: "r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3]) : "memory");
}

// Make this thread's shared-memory writes visible to the async proxy
// (wgmma's operand reads, TMA) once a barrier orders them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads) over `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- codes: a TMA box of 1-byte codes widened in place to a bf16 box
// Four codes (byte i of w is code i) as two bf16x2 words (codes 0, 1 and
// 2, 3), exactly, on the integer and fp32 / bf16 pipes: the SM's
// conversion units (I2F, F2F, cvt from e4m3) take 16 operations a clock,
// too few for the 36,864 codes of a latent page a unit (PERF.md).
//   int8 x: the fp32 number 2^23 + (x + 128) (its byte under an exponent),
//     minus 2^23 + 128, is x exactly; |x| <= 128 has at most 8
//     significant bits, so its top 16 bits are bf16(x).
//   e4m3 s.eeee.mmm: s << 15 | eeeemmm << 4 read as bf16 is the code times
//     2^-120 (a bf16 subnormal for e = 0, as the code is an e4m3 one), so
//     one bf16 product with 2^120 gives the code exactly.  The NaN codes
//     (0x7f, 0xff) are never written (quantize_rows clamps).
template <bool E4M3>
__device__ __forceinline__ void widen4(uint32_t w, uint32_t& lo,
                                       uint32_t& hi) {
  if constexpr (!E4M3) {
    const uint32_t u = w ^ 0x80808080u;    // x + 128, byte by byte
    uint32_t f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      f[i] = __float_as_uint(
          __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) -
          8388736.f);                      // 2^23 + 128
    lo = __byte_perm(f[0], f[1], 0x7632);
    hi = __byte_perm(f[2], f[3], 0x7632);
  } else {
    const __nv_bfloat162 two120 = __floats2bfloat162_rn(0x1p120f, 0x1p120f);
    auto half2 = [&](uint32_t v) {         // bytes in halves' low bytes
      uint32_t bits = ((v << 8) & 0x80008000u) | ((v << 4) & 0x07f007f0u);
      __nv_bfloat162 x = __hmul2(
          *reinterpret_cast<const __nv_bfloat162*>(&bits), two120);
      return *reinterpret_cast<uint32_t*>(&x);
    };
    lo = half2(__byte_perm(w, 0, 0x4140));
    hi = half2(__byte_perm(w, 0, 0x4342));
  }
}

// Widen a ring slot's code box in place, one warp: the slot's upper 4 KB
// hold its codes [64][64] (dense bytes, as TMA landed them through a
// code_rows_map) and become the slot's 128-byte-swizzled bf16 box [64][64]
// (the layout a TMA box of bf16 rows has).  Lane l takes 16 codes (one
// 16-byte load, two 16-byte stores) of rows 8 k + l / 4, k = 0..7.  Rows
// 0-31 land below the codes; rows 32-47 over code rows 0-31, rows 48-55
// over code rows 32-47 and rows 56-63 over code rows 48-63, each once the
// whole warp has read the codes it covers (one 16-byte load in flight a
// lane: the converters have 40 registers).
template <bool E4M3>
__device__ __forceinline__ void widen_box(void* box, int lane) {
  constexpr int ROW = 64;                  // codes a row (bytes)
  const uint8_t* src = static_cast<const uint8_t*>(box) + 64 * ROW;
  const int h = lane & 3;
  auto load = [&](int k) {
    return *reinterpret_cast<const uint4*>(src + (8 * k + (lane >> 2)) * ROW +
                                           h * 16);
  };
  auto store = [&](int k, uint4 v) {
    const int r = 8 * k + (lane >> 2);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    uint32_t o[8];
#pragma unroll
    for (int x = 0; x < 4; ++x) widen4<E4M3>(w[x], o[2 * x], o[2 * x + 1]);
    char* row = static_cast<char*>(box) + r * 128;
    *reinterpret_cast<uint4*>(row + (((2 * h) ^ (r & 7)) << 4)) =
        make_uint4(o[0], o[1], o[2], o[3]);
    *reinterpret_cast<uint4*>(row + (((2 * h + 1) ^ (r & 7)) << 4)) =
        make_uint4(o[4], o[5], o[6], o[7]);
  };
  // not unrolled: the addresses of 8 rows at once would not fit
#pragma unroll 1
  for (int k = 0; k < 4; ++k) store(k, load(k));
  __syncwarp();                            // code rows 0-31 read
#pragma unroll 1
  for (int k = 4; k < 6; ++k) store(k, load(k));
#pragma unroll 1
  for (int k = 6; k < 8; ++k) {
    const uint4 v = load(k);
    __syncwarp();                          // code rows up to 8 k + 7 read
    store(k, v);
  }
}

// Element d of row r of a K-major tile of ROWS rows (one box of ROWS x 64
// bf16 per 64 of the width, 128-byte swizzled): its offset in elements.
template <int ROWS>
__device__ __forceinline__ int q_at(int r, int d) {
  return (d >> 6) * ROWS * 64 + r * 64 + ((((d & 63) >> 3) ^ (r & 7)) << 3) +
         (d & 7);
}

// ---- host: the device and its SM count
constexpr int MAX_DEVICES = 64;

// The current device, or -1.
inline int current_device() {
  int dev = 0;
  return cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < MAX_DEVICES
             ? dev
             : -1;
}

// The SM count of device dev, asked once a device.
inline int sm_count(int dev) {
  static std::atomic<int> cached[MAX_DEVICES];
  int n = cached[dev].load(std::memory_order_relaxed);
  if (n > 0) return n;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  cached[dev].store(n, std::memory_order_relaxed);
  return n;
}

// ---- host: tensor maps
// cuTensorMapEncodeTiled is a driver-API call: reached through the
// runtime's entry-point query, so the library links no libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// An operand [batch, rows, heads, width] of `type` (elements of `elem`
// bytes) at base, with element strides (head, row, batch) and unit column
// stride, as a 4-D map (width, heads, rows, batch) whose box is box_cols
// columns x 1 head x box_rows rows x 1, laid out row after row with
// `swizzle`.  Rows past `rows` (and columns past `width`) read as zero.
// Returns a cudaError_t.
inline int rows_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                    CUtensorMapSwizzle swizzle, const void* base, int width,
                    int heads, int rows, int batch, long long head_stride,
                    long long row_stride, long long batch_stride,
                    int box_cols, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  // a dimension of extent 1 is never stepped: any 16-byte stride will do
  auto bytes = [elem](long long stride, int extent) {
    return static_cast<cuuint64_t>(extent == 1 ? 16 : stride * elem);
  };
  const cuuint64_t strides[3] = {bytes(head_stride, heads),
                                 bytes(row_stride, rows),
                                 bytes(batch_stride, batch)};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, type, 4, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// A bf16 operand as rows_map gives it, boxes of 64 columns (128 bytes)
// with the 128-byte swizzle: the [box_rows][64] tile of the header.
inline int bf16_rows_map(CUtensorMap* map, const void* base, int width,
                         int heads, int rows, int batch, long long head_stride,
                         long long row_stride, long long batch_stride,
                         int box_rows) {
  return rows_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                  CU_TENSOR_MAP_SWIZZLE_128B, base, width, heads, rows, batch,
                  head_stride, row_stride, batch_stride, 64, box_rows);
}

// An operand of 1-byte codes (int8 or e4m3, moved as bytes) as rows_map
// gives it, boxes of 64 codes (64 bytes) a row, unswizzled: a dense
// [box_rows][64] byte tile, which threads widen to bf16.
inline int code_rows_map(CUtensorMap* map, const void* base, int width,
                         int heads, int rows, int batch, long long head_stride,
                         long long row_stride, long long batch_stride,
                         int box_rows) {
  return rows_map(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1,
                  CU_TENSOR_MAP_SWIZZLE_NONE, base, width, heads, rows, batch,
                  head_stride, row_stride, batch_stride, 64, box_rows);
}

}  // namespace hopper
