// Hopper (sm_90a) building blocks shared by the wgmma/TMA kernels K2
// (flash_fwd.cu), K3 and K4 (flash_bwd.cu) and the bulk-copy kernel K1
// (paged_decode.cu), as raw PTX in the style of common.cuh:
//   - mbarrier init / arrive.expect_tx / try_wait.parity (the arrivals
//     also predicated, for code a warpgroup runs between a wgmma and its
//     wait), with a clock guard that traps a wait which never
//     completes (a wrong parity or byte count), so a deadlock ends the
//     launch with an error instead of hanging the card; named barriers
//     (bar.sync / bar.arrive) that order the warpgroups of one block (a
//     wait on one has no such guard);
//   - cp.async.bulk.tensor (TMA) loads of 4-d boxes into shared memory,
//     and the 1-d bulk copy of a contiguous range (no tensor map);
//   - wgmma.mma_async m64nNk16, f32 += bf16 * bf16, with A from shared
//     memory (wgmma_ss, N 64) or from registers (wgmma_rs, N 16, 32, 64,
//     96, 128 and 256: N / 2 accumulators a thread, B MN-major;
//     wgmma_rs_kb64, B K-major), and wgmma.fence / commit_group /
//     wait_group; one warp's mma.sync m16n8k16 (mma_bf16);
//   - the shared-memory matrix descriptor of a tile loaded by TMA, moved
//     by constant offsets (desc_advance), and an A fragment read from
//     such a tile into registers (load_afrag);
//   - host-side tensor maps (cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint so the library needs no -lcuda).
//
// Tile layout. Every bf16 tile is [rows][D] as TMA writes it, in boxes of
// BC = SW / 2 columns with a swizzle of SW bytes: the widest of 128, 64 or
// 32 bytes that divides a row's 2 * D bytes (swizzle_bytes). D 16 takes
// the 32-byte swizzle in one box; D 32 the 64-byte one in one box; D 64
// the 128-byte one in one box; D 96 (192 bytes a row, which 128 does not
// divide) the 64-byte one in three boxes of 32 columns; D 128 and 256 the
// 128-byte one in two and four boxes of 64. Box c holds columns
// [BC c, BC c + BC) as its own [rows][BC] block, and a tile is always a
// whole number of boxes (a static_assert in tma_load_tile, a check in
// make_map), so no head dim loads part of its row. In the descriptor's
// terms (units of 16 bytes, CUTLASS's canonical layouts):
//   K-major (the tile's columns are the product's depth): 8-row groups
//     SBO = 8 * SW apart; a k16 step moves 32 bytes inside a box row, and
//     to the next box every SW / 32 steps;
//   MN-major (the tile's rows are the product's depth, through the
//     transpose bit): 8-row groups SBO = 8 * SW apart along the depth, a
//     k16 step moves 16 * SW bytes, and column boxes are LBO = rows * SW
//     apart.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

// ---------------------------------------------------------------- barriers

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// make the barriers' initialisation visible to the async (TMA) proxy
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// mbar_expect_tx issued only where `on`, and an arrival on `bar` once
// every cp.async copy this thread issued before has landed (one of the
// count the barrier was initialised with: .noinc), likewise: each as a
// predicated instruction, not a branch, so that code a warpgroup runs
// between a wgmma and its wait holds no path some of its threads skip
// (ptxas serialises every wgmma of a function that has one)
__device__ __forceinline__ void mbar_expect_tx_if(bool on, uint64_t* bar,
                                                  uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes), "r"((int)on)
      : "memory");
}
__device__ __forceinline__ void cp_async_mbar_arrive_if(bool on,
                                                        uint64_t* bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n"
      "@p cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n}\n" ::"r"(
          smem_addr(bar)),
      "r"((int)on)
      : "memory");
}
// cp.async of 4 bytes (zero-filled past src_bytes) where `on`, predicated
__device__ __forceinline__ void cp_async4_if(bool on, void* dst,
                                             const void* src, int src_bytes) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\n"
      "@p cp.async.ca.shared.global [%0], [%1], 4, %2;\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(src_bytes), "r"((int)on)
      : "memory");
}

// a wait that has not completed after this many SM cycles (seconds at the
// H100's clock, where a tile's load takes microseconds) is a deadlock
constexpr long long kMbarTimeoutCycles = 1ll << 33;

// Wait until the phase of `bar` with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity)) {
    if (clock64() - start > kMbarTimeoutCycles) __trap();
  }
}

// Named barriers 1..15 (0 is __syncthreads'), for ordering two warpgroups
// between themselves: `count` threads (a multiple of 32) take part; a
// sync waits until they all arrived, an arrive does not wait. Both order
// the caller's earlier shared-memory accesses before the barrier.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------- TMA

// Load the box at coordinates (c0, c1, c2, c3) (innermost first) of the
// 4-d tensor map into shared memory at dst; completion is counted on bar.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy `bytes` contiguous bytes (a multiple of 16, both addresses 16-byte
// aligned) from device memory to shared memory at dst; completion is
// counted on bar. The 1-d bulk copy needs no tensor map.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// tma_load_4d issued only where `on` (predicated, as mbar_expect_tx_if)
__device__ __forceinline__ void tma_load_4d_if(bool on, void* dst,
                                               const CUtensorMap* map,
                                               uint64_t* bar, int c0, int c1,
                                               int c2, int c3) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"((int)on)
      : "memory");
}

// The swizzle of a row of d bf16 values: the widest of 128, 64 or 32
// bytes that divides its 2 * d bytes (d a multiple of 16)
__host__ __device__ constexpr int swizzle_bytes(int d) {
  return (2 * d) % 128 == 0 ? 128 : (2 * d) % 64 == 0 ? 64 : 32;
}

// The bf16 [B, S, H, D] view a tensor map describes (see make_map): load
// rows [s0, s0 + rows) of head h, batch b as D / BC boxes of BC = SW / 2
// columns, box c at dst + c * rows * SW bytes.
template <int D, int rows>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int s0, int h,
                                              int b) {
  constexpr int BC = swizzle_bytes(D) / 2;  // columns per box
  static_assert(D % 16 == 0 && D % BC == 0,
                "a tile must be a whole number of swizzle boxes");
#pragma unroll
  for (int c = 0; c < D / BC; ++c)
    tma_load_4d(static_cast<char*>(dst) + c * rows * BC * 2, map, bar, c * BC,
                h, s0, b);
}

// tma_load_tile issued only where `on` (predicated)
template <int D, int rows>
__device__ __forceinline__ void tma_load_tile_if(bool on, void* dst,
                                                 const CUtensorMap* map,
                                                 uint64_t* bar, int s0, int h,
                                                 int b) {
  constexpr int BC = swizzle_bytes(D) / 2;  // columns per box
  static_assert(D % 16 == 0 && D % BC == 0,
                "a tile must be a whole number of swizzle boxes");
#pragma unroll
  for (int c = 0; c < D / BC; ++c)
    tma_load_4d_if(on, static_cast<char*>(dst) + c * rows * BC * 2, map, bar,
                   c * BC, h, s0, b);
}

// ----------------------------------------------------------------- wgmma

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int D>
struct Swizzle {
  static constexpr int bytes = swizzle_bytes(D);  // SW
  // descriptor layout code: 1 = 128B, 2 = 64B, 3 = 32B
  static constexpr uint64_t code = bytes == 128 ? 1 : bytes == 64 ? 2 : 3;
};

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t code) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (code << 62);
}

// Descriptor of k16 step `kk` of a [rows][D] tile (D the product's depth).
template <int D, int rows>
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  constexpr int SW = Swizzle<D>::bytes;
  constexpr int per_box = SW / 32;  // k16 steps per box row
  const uint32_t addr = smem_addr(tile) + (kk / per_box) * rows * SW +
                        (kk % per_box) * 32;
  return make_desc(addr, 16, 8 * SW, Swizzle<D>::code);
}

// Descriptor of k16 step `kk` of a [rows][D] tile whose rows are the
// product's depth and whose columns [col0, col0 + N) are its N (col0 a
// multiple of the box's SW / 2 columns).
template <int D, int rows>
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile, int kk,
                                                 int col0 = 0) {
  constexpr int SW = Swizzle<D>::bytes;
  return make_desc(smem_addr(tile) + (col0 / (SW / 2)) * rows * SW +
                       kk * 16 * SW,
                   rows * SW, 8 * SW, Swizzle<D>::code);
}

// Byte offsets, from a tile's start, of the descriptors above: a loop
// that moves one descriptor by these (desc_advance) spends one add per
// wgmma where desc_kmajor and desc_mnmajor spend about ten instructions,
// which the compiler cannot fold (the mask and shift hide the sum).
template <int D, int rows>
__host__ __device__ constexpr uint32_t kmajor_off(int kk) {
  constexpr int SW = Swizzle<D>::bytes;
  return (kk / (SW / 32)) * rows * SW + (kk % (SW / 32)) * 32;
}
template <int D, int rows>
__host__ __device__ constexpr uint32_t mnmajor_off(int kk) {
  return kk * 16 * Swizzle<D>::bytes;
}
// `desc` moved by `bytes` (a multiple of 16) in shared memory: the start
// address is its low 14 bits in units of 16 bytes, which an address below
// 256 KB never carries out of.
__device__ __forceinline__ uint64_t desc_advance(uint64_t desc,
                                                 uint32_t bytes) {
  return desc + (bytes >> 4);
}

// D(64 x N) (+)= A(64 x 16) * B(16 x N), A and B K-major in shared memory.
template <int N>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db,
                                         int scale_d);
// D(64 x N) (+)= A(64 x 16) * B(16 x N), A in registers (the accumulator
// layout of a previous product, rounded to bf16 pairs), B MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float* d, uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// D(64 x 64) (+)= A(64 x 16) * B(16 x 64), A in registers (a fragment as
// wg_frag or load_afrag lay it out) and B K-major in shared memory: the
// product of wgmma_ss<64> with A read from registers instead.
__device__ __forceinline__ void wgmma_rs_kb64(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(scale_d));
}

// exp(x) = exp2(x * kLog2e): the kernels run their softmax in base 2
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// mma.sync m16n8k16, f32 c += bf16 a (row) * bf16 b (col): one warp's
// product, for the kernels whose narrow tiles do not fill a warpgroup's
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo: low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 step t of a 64 x 64 accumulator x, rounded to bf16
// pairs. wgmma's accumulator layout (warp w of the warpgroup, lane
// 4g + q): x[4j], x[4j + 1] hold row 16w + g, columns 8j + 2q and
// 8j + 2q + 1; x[4j + 2], x[4j + 3] the same columns of row 16w + g + 8.
// That is mma.sync's, so a row's values sit in the 4 lanes of a quad.
__device__ __forceinline__ void wg_frag(uint32_t* a, const float* x, int t) {
  a[0] = pack_bf16(x[8 * t + 0], x[8 * t + 1]);
  a[1] = pack_bf16(x[8 * t + 2], x[8 * t + 3]);
  a[2] = pack_bf16(x[8 * t + 4], x[8 * t + 5]);
  a[3] = pack_bf16(x[8 * t + 6], x[8 * t + 7]);
}

// This thread's A fragment (wg_frag's layout) of k16 step kk of a [rows][D]
// bf16 tile that TMA loaded (its boxes and swizzle, above), for the
// warpgroup's warp `warp` and rows 16 warp .. 16 warp + 15: the swizzle
// moves 16-byte chunk k of row r to chunk k ^ ((r SW / 128) mod (SW / 16)).
// Held to wg_frag's layout on the card at the 64-byte swizzle (D 96) only:
// at the 128-byte swizzle (D 64, 128, 256) the kernel that read its
// fragments gave NaN, for a reason not found, so those head dims are
// refused until one is.
template <int D, int rows>
__device__ __forceinline__ void load_afrag(uint32_t* a,
                                           const unsigned char* tile,
                                           int warp, int lane, int kk) {
  constexpr int SW = Swizzle<D>::bytes, BC = SW / 2, CH = SW / 16;
  static_assert(SW == 64, "load_afrag is checked at the 64-byte swizzle only");
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const int r = 16 * warp + g + 8 * (h & 1);
    const int c = 16 * kk + 2 * tq + 8 * (h >> 1);
    const int chunk = ((c % BC) / 8) ^ ((r * SW / 128) % CH);
    a[h] = *reinterpret_cast<const uint32_t*>(
        tile + (c / BC) * rows * SW + r * SW + chunk * 16 + (c % 8) * 2);
  }
}

// Shared memory of a kernel, rounded up to the 1024-byte alignment of the
// 128-byte swizzle (the launch asks for kSmemSlack bytes more).
constexpr int kSmemSlack = 1024;
__device__ __forceinline__ unsigned char* align_smem(unsigned char* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// ------------------------------------------------------------------ host

// A tensor map of a bf16 [B, S, H, D] tensor with element strides
// (sb, ss, sh) and a contiguous last dim, as dims (D, H, S, B) with boxes
// of (swizzle_bytes(D) / 2, 1, rows, 1) and that swizzle; rows past S
// read as zeros. Returns 0 on success, else a CUDA error code.
inline int make_map(CUtensorMap* map, const void* base, int B, int S, int H,
                    int D, long long sb, long long ss, long long sh,
                    int rows) {
  typedef CUresult (*EncodeFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                               void*, const cuuint64_t*, const cuuint64_t*,
                               const cuuint32_t*, const cuuint32_t*,
                               CUtensorMapInterleave, CUtensorMapSwizzle,
                               CUtensorMapL2promotion,
                               CUtensorMapFloatOOBfill);
  static EncodeFn encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr)
      return (int)cudaErrorSymbolNotFound;
    encode = reinterpret_cast<EncodeFn>(fn);
  }
  if (D % 16 != 0) return (int)cudaErrorInvalidValue;  // whole boxes only
  const int sw = swizzle_bytes(D), bc = sw / 2;
  const CUtensorMapSwizzle swizzle =
      sw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                : sw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  // a dim of extent 1 is never stepped along: give it a stride TMA takes
  if (H == 1) sh = D;
  if (B == 1) sb = ss * S;
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)bc, 1, (cuuint32_t)rows, 1};
  const cuuint32_t estrides[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, estrides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
