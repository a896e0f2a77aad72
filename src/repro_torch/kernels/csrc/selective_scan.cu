// Selective scan (the Mamba-1 linear recurrence) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/selective_scan.py, `_kernel` / `selective_scan`
// (the Pallas TPU kernel, grid (B, F/block_f, S/chunk) with the chunk axis
// sequential and the carried state in VMEM). The JAX model reaches it from
// `apply_mamba` with `Runtime(scan_impl="pallas")`.
//
// Function: a, b [B,S,F] f32 (F = DI*DS, flattened), optional h0 [B,F] f32
//   -> h [B,S,F] f32 with h_t = a_t * h_{t-1} + b_t and h_{-1} = h0 (0 when
//   h0 is absent, which is the TPU kernel's function). With h0 and S = 1 it
//   is one decode step of the SSM state.
//   Each step is a rounded product then a rounded sum (__fmul_rn, __fadd_rn),
//   never a fused multiply-add: the plain PyTorch loop (`ref.py`) computes
//   `a * h + b` as two rounded operations, and the kernel gives its bits.
//
// What bounds it on the card: bytes. Every element reads a and b once and
// writes h once (12 bytes; 16 with h0 at S = 1) for 2 flops, with no reuse.
// The floor is those bytes over the H100 SXM's 3.35 TB/s (data sheet): 1.92 ms
// at [2, 2048, 8192*16].
//
// What the design does about it:
//   * One thread owns one (b, f) and loops over t with the state in a
//     register; neighbouring threads own neighbouring f, so each t is one
//     coalesced 128-byte row of a and of b per warp. The grid is
//     (ceil(F / 256), B), the ragged edge of F is masked, and S takes any
//     value (no chunk, no divisibility condition).
//   * The loads do not depend on h: the t loop is cut into groups of kUnroll
//     steps whose a and b are all loaded before the first is used, so every
//     thread keeps 2 * kUnroll loads in flight (about 16 MB over the card at
//     the forward shape, far above what 3.35 TB/s needs to hide latency).
//   * Loads and stores are streaming (__ldcs / __stcs): nothing is read
//     twice, so the data need not stay in L2.
//   * The decode step (S = 1, F % 4 == 0, 16-byte aligned operands) has its
//     own kernel: at S = 1 the sequential kernel gives each thread one 4-byte
//     load of a, b and h0, in about two waves of blocks. The step kernel gives
//     each thread 4 consecutive f as one float4 of each operand (16-byte
//     streaming loads and store, 4x the bytes in flight per thread) over a
//     grid of one wave, sized from the SM count, with a grid-stride loop.
//     Same arithmetic, same bits.
#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
selective_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ h0, float* __restrict__ h,
                      int S, long long F) {
  const long long f = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= F) return;
  const long long batch = blockIdx.y;
  const size_t base = static_cast<size_t>(batch) * S * F + f;
  const float* pa = a + base;
  const float* pb = b + base;
  float* ph = h + base;
  float state = h0 != nullptr ? h0[batch * F + f] : 0.f;

  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float ra[kUnroll], rb[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      ra[j] = __ldcs(pa + static_cast<size_t>(t + j) * F);
      rb[j] = __ldcs(pb + static_cast<size_t>(t + j) * F);
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      state = __fadd_rn(__fmul_rn(ra[j], state), rb[j]);
      __stcs(ph + static_cast<size_t>(t + j) * F, state);
    }
  }
  for (; t < S; ++t) {
    const size_t off = static_cast<size_t>(t) * F;
    state = __fadd_rn(__fmul_rn(__ldcs(pa + off), state), __ldcs(pb + off));
    __stcs(ph + off, state);
  }
}

// One step from h0 (or 0) over n4 float4s of a, b, h0 and h, all [B*F].
__global__ void __launch_bounds__(kThreads)
selective_scan_step_kernel(const float4* __restrict__ a, const float4* __restrict__ b,
                           const float4* __restrict__ h0, float4* __restrict__ h,
                           long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < n4;
       i += stride) {
    const float4 ra = __ldcs(a + i), rb = __ldcs(b + i);
    const float4 s = h0 != nullptr ? __ldcs(h0 + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    __stcs(h + i, make_float4(__fadd_rn(__fmul_rn(ra.x, s.x), rb.x),
                              __fadd_rn(__fmul_rn(ra.y, s.y), rb.y),
                              __fadd_rn(__fmul_rn(ra.z, s.z), rb.z),
                              __fadd_rn(__fmul_rn(ra.w, s.w), rb.w)));
  }
}

}  // namespace
}  // namespace repro

// C entry point. a, b, h: [B,S,F] f32 contiguous; h0: [B,F] f32 or null.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_selective_scan(const void* a, const void* b, const void* h0,
                                    void* h, int B, int S, long long F,
                                    void* stream) {
  using namespace repro;
  if (B <= 0 || B > 65535 || S <= 0 || F <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (F + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  selective_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), S, F);
  return static_cast<int>(cudaGetLastError());
}

// C entry point of the decode step: a, b, h: [B,1,F] f32 and h0: [B,F] f32
// or null, all contiguous and 16-byte aligned, with F % 4 == 0; n = B * F.
// The grid is one wave of sms SMs (8 blocks of kThreads each).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_selective_scan_step(const void* a, const void* b, const void* h0,
                                         void* h, long long n, int sms, void* stream) {
  using namespace repro;
  if (n <= 0 || n % 4 != 0 || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = n / 4;
  const long long wave = static_cast<long long>(sms) * (2048 / kThreads);
  const long long need = (n4 + kThreads - 1) / kThreads;
  const unsigned blocks = static_cast<unsigned>(need < wave ? need : wave);
  selective_scan_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(a), static_cast<const float4*>(b),
      static_cast<const float4*>(h0), static_cast<float4*>(h), n4);
  return static_cast<int>(cudaGetLastError());
}
