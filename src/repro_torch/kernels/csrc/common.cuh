// Helpers shared by the attention kernels: element conversion to and from
// f32, vectorised row loads and warp reductions. Only f32 and bf16 elements
// are used; dtype code 0 is f32 and 1 is bf16 in every C entry point.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace repro {

constexpr float kNegInf = -1e30f;   // masked score, as in the TPU kernels

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as a cast in PyTorch
}

template <int BYTES> struct RawVec;
template <> struct RawVec<2> { using type = uint16_t; };
template <> struct RawVec<4> { using type = uint32_t; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<16> { using type = uint4; };

// Load N consecutive elements starting at p (aligned to N * sizeof(T), up to
// 16 bytes) into f32 registers, in chunks of at most 16 bytes.
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kChunk = kBytes >= 16 ? 16 : kBytes;
  constexpr int kChunks = kBytes / kChunk;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(T));
  using V = typename RawVec<kChunk>::type;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    V raw = reinterpret_cast<const V*>(p)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = to_float(e[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

}  // namespace repro
