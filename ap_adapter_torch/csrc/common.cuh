// Helpers the CUDA sources share: the bf16 type, the block size of the row
// kernels (int8_blocks.cu's quantize rows, train_blocks.cu's LayerNorm
// backward, self_attention.cu's streamed route) and the warp reductions.
// Each TU that includes this header gets its own copy (anonymous namespace).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace
