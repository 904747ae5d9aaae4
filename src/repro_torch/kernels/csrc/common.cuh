// Helpers shared by the attention kernels of this directory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace relserve {

// Finite masking sentinel, as in the reference kernels: a row whose first
// visited tile is fully masked computes exp(NEG_INF - NEG_INF) = 1 (never
// NaN), and the correction factor exp(NEG_INF - m) = 0 wipes it once a real
// score arrives.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Unpack one 16-byte chunk (4 floats or 8 bf16 values) into floats.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* out) {
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < int(16 / sizeof(T)); ++e) out[e] = to_float(v[e]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// Opt a kernel into more than 48 KB of dynamic shared memory. `granted` is
// the caller's per-instantiation record (a function-local static, one entry
// per device) of what the attribute already allows, so the driver call is
// made only when a launch needs more than any earlier one on that device.
constexpr int kMaxDevices = 16;

template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, int bytes, int* granted) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev < kMaxDevices;
  if (tracked && bytes <= granted[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && tracked) granted[dev] = bytes;
  return err;
}

}  // namespace relserve
