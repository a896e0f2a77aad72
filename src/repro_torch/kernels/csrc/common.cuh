// Helpers shared by the kernels: element conversion to and from f32,
// vectorised row loads, warp reductions, flash attention's row mask and the
// one-time shared-memory attribute. Only f32 and bf16 elements are used;
// dtype code 0 is f32 and 1 is bf16 in the C entry points that take one.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace repro {

constexpr float kNegInf = -1e30f;   // masked score, as in the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;

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

// Load N consecutive elements starting at p into f32 registers, in chunks of
// the largest power of two that divides N * sizeof(T), at most 16 bytes
// (p aligned to the chunk: 16 bytes for N = 4 f32, 8 for N = 6 f32).
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ p, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  constexpr int kLow = kBytes & -kBytes;   // the lowest set bit
  constexpr int kChunk = kLow >= 16 ? 16 : kLow;
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

// Flash attention's mask for one row, relative to a tile, where a thread
// holds columns 8 j + col + {0, 1} of the row (the wgmma accumulator
// fragment): key k0 + 8 j + col + e is kept when lo <= 8 j + e <= hi.
struct RowKeys {
  int lo, hi;
  __device__ __forceinline__ RowKeys(int qpos, int k0, int col, int Sk, int causal,
                                     int window) {
    const int first = (causal && window > 0) ? qpos - window + 1 : 0;
    const int last = causal ? min(qpos, Sk - 1) : Sk - 1;
    lo = first - k0 - col;
    hi = last - k0 - col;
  }
};

// Whether flash attention keeps the pair (query qpos, key kpos): both in
// range, and with `causal` kpos <= qpos and (with a window) kpos > qpos - window.
__device__ __forceinline__ bool kept(int qpos, int kpos, int Sq, int Sk, int causal, int window) {
  if (qpos >= Sq || kpos >= Sk) return false;
  if (!causal) return true;
  return kpos <= qpos && (window <= 0 || kpos > qpos - window);
}

// The flash backward's P and dS of one score element: raw = the (q . k) sum,
// dp = (dO . v), lse and delta those of its query row. dS carries the scale,
// so dq = dS K and dk = dS^T Q need nothing more.
template <bool kCap>
__device__ __forceinline__ void grad_element(float raw, float dp, float lse, float delta,
                                             bool keep, float scale, float softcap, float& p,
                                             float& ds) {
  float x = raw * scale, chain = 1.f;
  if constexpr (kCap) {
    const float t = tanhf(x / softcap);
    x = softcap * t;
    chain = 1.f - t * t;
  }
  p = keep ? expf(x - lse) : 0.f;
  ds = p * (dp - delta) * chain * scale;
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once per device: the attribute belongs to the device, so a process
// that launches on a second card sets it again there. `done` is the caller's
// per-kernel record of the devices already set (bit d for device d < 64;
// higher devices are set on every call).
template <typename Kernel>
cudaError_t set_smem_once(std::atomic<uint64_t>& done, Kernel* kernel, int bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

}  // namespace repro
