// The scalar bf16 helpers of the kernels that run no chain of their own: the slot-grid
// lookup (slot_grid.cu), the slot grid's cell geometry (slot.cuh) and the NeRF encoding
// (enc.cuh). The chain kernels' building blocks are k1.cuh's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace mms {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

}  // namespace mms
