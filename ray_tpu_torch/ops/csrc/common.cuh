// Shared helpers for the hand-written Hopper kernels of ray_tpu_torch.
//
// Every kernel is templated on its storage type T (float or
// __nv_bfloat16) and computes in float32. Each C entry point takes a
// dtype code (DTYPE_F32 / DTYPE_BF16), raw device pointers and the CUDA
// stream, and returns cudaGetLastError() so the Python wrapper can raise
// on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_INF_F (-1e30f)  // finite sentinel: lse merges take exp(lse - max)

enum { DTYPE_F32 = 0, DTYPE_BF16 = 1 };

// The head dims every kernel is built for, as a switch's cases returning
// L(D): the wrappers' KERNEL_HEAD_DIMS and DECODE_HEAD_DIMS_BF16
#define HEAD_DIM_CASES(L) \
  case 16: return L(16);  \
  case 32: return L(32);  \
  case 64: return L(64);  \
  case 96: return L(96);  \
  case 128: return L(128); \
  case 256: return L(256);

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Reductions over the `width` lanes of a lane group (width a power of two
// dividing 32); every lane of the group gets the result.
template <int width>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int width>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = width / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// cp.async: BYTES (16 or 4) from global to shared memory without a trip
// through registers, of which the first src_bytes are read and the rest
// zero-filled (src_bytes 0: a row past the end becomes zeros and its
// source is not read). Completes per commit group: cp_async_wait<N>()
// waits until at most N of this thread's groups are pending; a
// __syncthreads after it makes every thread's copies visible.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether rows of elem_bytes elements at base, base + stride, ... can be
// copied in 16-byte pieces: a 16-byte aligned base and strides that keep
// every row so
inline bool rows_16b(const void* base, int elem_bytes, long long s0,
                     long long s1, long long s2) {
  const long long v = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && s0 % v == 0 &&
         s1 % v == 0 && s2 % v == 0;
}

// float32 register tiles (K2, K3 and K4 in float32): a dot product of 4
// head dims, a 16-byte shared load, and rows of an operand staged by
// cp.async
__device__ __forceinline__ float dot4(float4 a, float4 b, float c) {
  c = fmaf(a.x, b.x, c);
  c = fmaf(a.y, b.y, c);
  c = fmaf(a.z, b.z, c);
  return fmaf(a.w, b.w, c);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the widest piece (4, 2 or 1 floats) that divides a thread's n head dims
__host__ __device__ constexpr int piece_width(int n) {
  return n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
}

// VW consecutive floats of shared memory (VW 4, 2 or 1) in one load
template <int VW>
__device__ __forceinline__ void lds_piece(const float* p, float* x) {
  if constexpr (VW == 4) {
    const float4 t = lds4(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

// rows [r0, r0 + rows) of a float32 [*, D] operand with row stride ss
// into dst (row stride RS) by cp.async, NT threads: rows at or past n are
// zeros
template <int D, int RS, int NT>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ss, int r0, int rows,
                                           int n, bool vec16) {
  if (vec16) {
    for (int i = threadIdx.x; i < rows * (D / 4); i += NT) {
      const int r = i / (D / 4), e = i % (D / 4) * 4, row = r0 + r;
      cp_async<16>(dst + r * RS + e, src + min(row, n - 1) * ss + e,
                   row < n ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * D; i += NT) {
      const int r = i / D, e = i % D, row = r0 + r;
      cp_async<4>(dst + r * RS + e, src + min(row, n - 1) * ss + e,
                  row < n ? 4 : 0);
    }
  }
}
