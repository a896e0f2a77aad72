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
//
// The backward (selective_scan_bwd_kernel) has no Pallas counterpart: the
// JAX package differentiates its XLA scans (`models/layers.py:539-561`), so
// this is the backward of the kernel above, on the train path.
//
// Function: a, h (the forward's output), dh [B,S,F] f32, optional h0 [B,F]
//   -> da, db [B,S,F] and, with h0, dh0 [B,F]: with g the gradient reaching
//   h_t, g_t = dh_t + a_{t+1} * g_{t+1} (g_{S-1} = dh_{S-1}), db_t = g_t,
//   da_t = g_t * h_{t-1} (h_{-1} = h0, or 0), dh0 = a_0 * g_0. Rounded
//   products and sums (__fmul_rn, __fadd_rn), never an FMA: the bits of the
//   plain reverse loop (`ref.selective_scan_backward_ref`), which are those
//   of autograd through the plain forward loop.
//
// What bounds it: bytes. Every element reads a, h and dh once and writes da
// and db once (20 bytes) for 3 flops: 3.21 ms at [2, 2048, 8192*16] at
// 3.35 TB/s.
//
// What the design does about it: the forward's shape run backwards. One
// thread owns one (b, f) and walks t from S-1 down to 0 with g in a
// register; neighbouring threads own neighbouring f, so every row of every
// operand is one coalesced access per warp. The loads (a_{t+1}, dh_t,
// h_{t-1}) do not depend on g: they are issued kUnroll steps ahead, 3 *
// kUnroll loads in flight a thread. Streaming loads and stores. Every output
// element has one owner and no atomics are used: bitwise repeatable.
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

// The reverse scan: da, db [B,S,F] and, with h0, dh0 [B,F] (see the top).
__global__ void __launch_bounds__(kThreads)
selective_scan_bwd_kernel(const float* __restrict__ a, const float* __restrict__ h,
                          const float* __restrict__ h0, const float* __restrict__ dh,
                          float* __restrict__ da, float* __restrict__ db,
                          float* __restrict__ dh0, int S, long long F) {
  const long long f = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (f >= F) return;
  const long long batch = blockIdx.y;
  const size_t base = static_cast<size_t>(batch) * S * F + f;
  const float* pa = a + base;
  const float* ph = h + base;
  const float* pdh = dh + base;
  float* pda = da + base;
  float* pdb = db + base;
  const float first = h0 != nullptr ? h0[batch * F + f] : 0.f;   // h_{-1}

  // t = S - 1: nothing flows back from beyond the end
  size_t off = static_cast<size_t>(S - 1) * F;
  float g = __ldcs(pdh + off);
  __stcs(pdb + off, g);
  __stcs(pda + off, __fmul_rn(g, S > 1 ? __ldcs(ph + off - F) : first));

  int t = S - 2;
  // groups of kUnroll steps t, t-1, ..., t-kUnroll+1, all with t-j >= 1
  for (; t >= kUnroll; t -= kUnroll) {
    float ra[kUnroll], rdh[kUnroll], rh[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const size_t o = static_cast<size_t>(t - j) * F;
      ra[j] = __ldcs(pa + o + F);    // a_{t-j+1}
      rdh[j] = __ldcs(pdh + o);      // dh_{t-j}
      rh[j] = __ldcs(ph + o - F);    // h_{t-j-1}
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const size_t o = static_cast<size_t>(t - j) * F;
      g = __fadd_rn(rdh[j], __fmul_rn(ra[j], g));
      __stcs(pdb + o, g);
      __stcs(pda + o, __fmul_rn(g, rh[j]));
    }
  }
  for (; t >= 0; --t) {
    off = static_cast<size_t>(t) * F;
    g = __fadd_rn(__ldcs(pdh + off), __fmul_rn(__ldcs(pa + off + F), g));
    __stcs(pdb + off, g);
    __stcs(pda + off, __fmul_rn(g, t > 0 ? __ldcs(ph + off - F) : first));
  }
  if (dh0 != nullptr) dh0[batch * F + f] = __fmul_rn(__ldcs(pa), g);
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

// C entry point of the backward. a, h, dh, da, db: [B,S,F] f32 contiguous;
// h0: [B,F] f32 or null; dh0: [B,F] f32, written when h0 is given (null
// otherwise). Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_selective_scan_bwd(const void* a, const void* h, const void* h0,
                                        const void* dh, void* da, void* db, void* dh0,
                                        int B, int S, long long F, void* stream) {
  using namespace repro;
  if (B <= 0 || B > 65535 || S <= 0 || F <= 0 || (h0 == nullptr) != (dh0 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (F + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  selective_scan_bwd_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(h),
      static_cast<const float*>(h0), static_cast<const float*>(dh),
      static_cast<float*>(da), static_cast<float*>(db), static_cast<float*>(dh0), S, F);
  return static_cast<int>(cudaGetLastError());
}
