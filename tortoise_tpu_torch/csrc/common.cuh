// Shared helpers for the hand-written Hopper kernels (sm_90a).
//
// Every C entry point in this directory launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for a shape it does not take); the Python
// wrappers raise on a nonzero code.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define TT_EXPORT extern "C" __attribute__((visibility("default")))

namespace tt {

// bf16 round trip: the value a float takes after a cast to bfloat16
// (the JAX package rounds matmul operands this way on its bf16 plane)
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the whole block (blockDim.x a multiple of 32, at most 1024).
// Every thread returns the same value, summed in the same order, so the
// result is deterministic. `red` holds at least 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read by a previous call
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) t += red[i];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  float t = red[0];
  for (int i = 1; i < (int)(blockDim.x >> 5); ++i) t = fmaxf(t, red[i]);
  return t;
}

}  // namespace tt
