// The warp-level pieces of the slot grid's gather and scatter kernels (slot_grid.cu's K6 and
// K6v, slot_split.cu's table scatter): lane groups, asynchronous 16-byte copies into shared
// memory and Hopper's vector reductions into device memory.
#pragma once

#include <cuda_runtime.h>

namespace mms {

constexpr unsigned FULL = 0xffffffffu;

// The lanes of the calling lane's group of G (a power of two) consecutive lanes.
template <int G>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (G == 32) return FULL;
  else return ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

// 16 bytes from device memory to shared memory, asynchronously (L2 only).
__device__ __forceinline__ void cp16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem));
}

// Every copy of the lane retired, then the warp's copies visible to the warp.
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncwarp();
}

// Hopper's vector reductions (PTX ISA 8.1, sm_90): no value returned.
__device__ __forceinline__ void red1(float* p, float a) {
  asm volatile("red.global.add.f32 [%0], %1;" ::"l"(p), "f"(a));
}
__device__ __forceinline__ void red2(float* p, float a, float b) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};" ::"l"(p), "f"(a), "f"(b));
}
__device__ __forceinline__ void red4(float* p, float a, float b, float c, float d) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(a), "f"(b), "f"(c),
               "f"(d));
}

// Add 4 consecutive sums at p (16-byte aligned) as one v4 reduction, unless all are zero.
__device__ __forceinline__ void red4_nonzero(float* p, const float* v) {
  if (v[0] != 0.f || v[1] != 0.f || v[2] != 0.f || v[3] != 0.f) red4(p, v[0], v[1], v[2], v[3]);
}

// A run's share of a kernel's work: a lane group per `seg` consecutive samples, `seg` from 1
// to 32, long enough that a call of n samples at k levels gives every SM 64 warps of groups
// of g lanes (fewer where the call is too small to).
inline int group_run(long long n, int k, int g) {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 132;
  }
  const long long want = 64LL * sms * (32 / g);
  const long long per = (n * k + want - 1) / want;
  return (int)(per < 1 ? 1 : per > 32 ? 32 : per);
}

inline bool aligned16(const void* p) { return ((unsigned long long)p & 15) == 0; }

}  // namespace mms
