// The fused selective scan of the Mamba-1 mixer, forward and backward, for
// Hopper (sm_90a): a and b are built, the recurrence runs and y = h.C is
// taken inside the kernel, so no [B,S,DI,DS] tensor ever exists.
//
// Replaces: the chunked branch of `apply_mamba` in the JAX package
// (src/repro/models/layers.py:539, `scan_impl="chunked"`, its default),
// whose `lax.scan` body builds a = exp(dt A) and b = dt u B for a chunk of
// 256 steps, scans it and contracts y = h.C, keeping only [B, chunk, DI, DS]
// working sets. That branch is XLA, not Pallas; its docstring names the
// blocking it shares with the Pallas scan (src/repro/kernels/selective_scan.py:49,
// `_kernel` / `selective_scan`: the carried state in VMEM, the chunk axis
// sequential), which this kernel keeps in registers.
//
// Function (forward): u [B,S,DI] (f32 or bf16), dt [B,S,DI] f32, A [DI,DS]
//   f32, Bc, Cc [B,S,DS] in u's dtype (unit stride over DS; any stride over
//   batch and time, so the x_proj split's views need no copy) -> y [B,S,DI]
//   f32 with h_t = a_t h_{t-1} + b_t from h_{-1} = 0, a_t = exp(dt_t A),
//   b_t = (dt_t u_t) B_t, y_t = sum_n h_t[n] C_t[n]; and, when asked, the
//   state entering every kChunk-th step, states [B, ceil(S/kChunk), DI, DS]
//   f32, for the backward. Every product and sum is rounded on its own
//   (__fmul_rn / __fadd_rn, never a fused multiply-add) and the exponential
//   is the accurate expf: the plain version (`ref.selective_scan_fused_ref`)
//   rounds the same operations, so only the order of the sum over n differs.
//
// What bounds it on the card: at falcon-mamba's train shape [2, 2048, 8192,
// 16] in f32 the bytes are u and dt read, y written and the states written,
// 0.54 GB, 0.16 ms at the H100 SXM's 3.35 TB/s; its 537 M exponentials take
// 0.13 ms on the SFUs (16 a clock an SM, 132 SMs at 1.98 GHz); the rest is
// about 30 instructions an element on the CUDA cores. The trap is
// parallelism: only B * DI = 16,384 channels, each a sequential walk over S.
//
// What the design does about it (lanes over DS):
//   * L = DS rounded up to 8, 16 or 32 lanes own one channel (b, i), one
//     state element h[n] a lane, in a register; a block of 256 threads takes
//     256 / L channels. At the train shape that is 262,144 threads in 1,024
//     blocks, one wave of 8 blocks an SM, so every SM has 64 warps of
//     exponentials and products in flight.
//   * y_t's L products are summed in one fixed butterfly of shuffles
//     (xor L/2 ... 1): every lane gets the same bits, and the sum does not
//     change between calls.
//   * A chunk of kChunk steps of u, dt (the block's channels) and of Bc, Cc
//     is staged in shared memory with coalesced loads (converted to f32
//     there), and y leaves through shared memory as coalesced rows.
//
// The backward (ssf_bwd_kernel, then ssf_reduce_kernel) has no Pallas
// counterpart: JAX differentiates its XLA scan. It walks each chunk in
// reverse from its saved state, each chunk again in sub-chunks of kSub
// steps: pass A runs the chunk forwards once to find the state entering
// each sub-chunk (in shared memory, a thread's own), pass B recomputes a sub-
// chunk's a and h into registers and walks it backwards, with g the
// gradient reaching h_t: g_t = dy_t C_t + a_{t+1} g_{t+1}; dx = (g_t h_{t-1})
// a_t; ddt = sum_n dx A + u sum_n g B; du = dt sum_n g B; dA += dx dt (per
// thread, over t last to first); and per step the block's sums over its
// channels of g (dt u) (dB) and dy h (dC): in a warp by shuffles (xor 16 ...
// L), across the block's 8 warps in order through shared memory, into
// per-block partials [DI / channels a block, B, S, DS]. ssf_reduce_kernel
// then sums the partials over the blocks, and dA's per-batch partials over
// the batch, each in a fixed order. No atomics: every call gives the same
// bits.
//
// What bounds the backward: bytes, u, dt, dy and the states read and du and
// ddt written, 0.81 GB at the train shape (0.24 ms at 3.35 TB/s), beside
// 1.75 exponentials an element (pass A and pass B) and the partials (2 x
// 134 MB written and read again at DS 16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                 // steps between saved states
constexpr int kSub = 16;                   // the backward's register sub-chunk
constexpr int kSubs = kChunk / kSub;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Sum over the L lanes of a channel (xor L/2 ... 1): the same bits in every lane.
template <int L>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Sum over the channels of a warp for each n (xor 16 ... L).
template <int L>
__device__ __forceinline__ float warp_channel_sum(float v) {
#pragma unroll
  for (int off = 16; off >= L; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// The block's chunk of u, dt (and dy) at its channels [len][CH], and of Bc,
// Cc [len][L], in f32, zeros past DI and DS.
template <int L, typename In>
__device__ __forceinline__ void load_chunk(const In* u, const float* dt, const float* dy,
                                           const In* Bc, const In* Cc, float* su, float* sdt,
                                           float* sdy, float* sB, float* sC, int b, int t0,
                                           int len, int i0, int S, int DI, int DS,
                                           long long sb_b, long long sb_t, long long sc_b,
                                           long long sc_t) {
  constexpr int CH = kThreads / L;
  for (int idx = threadIdx.x; idx < len * CH; idx += kThreads) {
    const int tt = idx / CH, cc = idx % CH, ii = i0 + cc;
    const size_t off = (static_cast<size_t>(b) * S + t0 + tt) * DI + ii;
    const bool in = ii < DI;
    su[idx] = in ? to_f32(u[off]) : 0.f;
    sdt[idx] = in ? dt[off] : 0.f;
    if (sdy != nullptr) sdy[idx] = in ? dy[off] : 0.f;
  }
  for (int idx = threadIdx.x; idx < len * L; idx += kThreads) {
    const int tt = idx / L, nn = idx % L;
    const bool in = nn < DS;
    sB[idx] = in ? to_f32(Bc[b * sb_b + (t0 + tt) * sb_t + nn]) : 0.f;
    sC[idx] = in ? to_f32(Cc[b * sc_b + (t0 + tt) * sc_t + nn]) : 0.f;
  }
}

template <int L, typename In>
__global__ void __launch_bounds__(kThreads)
ssf_fwd_kernel(const In* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ A, const In* __restrict__ Bc,
               const In* __restrict__ Cc, float* __restrict__ y,
               float* __restrict__ states, int S, int DI, int DS, long long sb_b,
               long long sb_t, long long sc_b, long long sc_t) {
  constexpr int CH = kThreads / L;
  __shared__ float su[kChunk * CH], sdt[kChunk * CH], sy[kChunk * CH];
  __shared__ float sB[kChunk * L], sC[kChunk * L];
  const int tid = threadIdx.x, n = tid % L, ch = tid / L, b = blockIdx.y;
  const int i0 = blockIdx.x * CH, i = i0 + ch;
  const bool live = i < DI && n < DS;
  const float An = live ? A[static_cast<size_t>(i) * DS + n] : 0.f;
  const int nc = (S + kChunk - 1) / kChunk;
  float h = 0.f;
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    load_chunk<L>(u, dt, static_cast<const float*>(nullptr), Bc, Cc, su, sdt,
                  static_cast<float*>(nullptr), sB, sC, b, t0, len, i0, S, DI, DS, sb_b,
                  sb_t, sc_b, sc_t);
    if (states != nullptr && live)
      states[((static_cast<size_t>(b) * nc + c) * DI + i) * DS + n] = h;
    __syncthreads();
#pragma unroll 4
    for (int tt = 0; tt < len; ++tt) {
      const float d = sdt[tt * CH + ch];
      const float a = expf(__fmul_rn(d, An));
      const float bb = __fmul_rn(__fmul_rn(d, su[tt * CH + ch]), sB[tt * L + n]);
      h = __fadd_rn(__fmul_rn(a, h), bb);
      const float p = lane_sum<L>(__fmul_rn(h, sC[tt * L + n]));
      if (n == 0) sy[tt * CH + ch] = p;
    }
    __syncthreads();
    // the next chunk's loads touch su, sdt, sB, sC only; sy is written
    // again after the next __syncthreads, once every thread is past here
    for (int idx = tid; idx < len * CH; idx += kThreads) {
      const int tt = idx / CH, ii = i0 + idx % CH;
      if (ii < DI) y[(static_cast<size_t>(b) * S + t0 + tt) * DI + ii] = sy[idx];
    }
  }
}

// Floats of the backward's dynamic shared memory at L lanes a channel.
template <int L>
constexpr int bwd_smem_floats() {
  return 3 * kChunk * (kThreads / L) + 2 * kChunk * L + 2 * kSub * kWarps * L
         + kSubs * kThreads;
}

template <int L, typename In>
__global__ void __launch_bounds__(kThreads)
ssf_bwd_kernel(const In* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ A, const In* __restrict__ Bc,
               const In* __restrict__ Cc, const float* __restrict__ states,
               const float* __restrict__ dy, float* __restrict__ du,
               float* __restrict__ ddt, float* __restrict__ part_b,
               float* __restrict__ part_c, float* __restrict__ dA_part, int S, int DI,
               int DS, long long sb_b, long long sb_t, long long sc_b, long long sc_t) {
  constexpr int CH = kThreads / L;
  extern __shared__ float smem[];
  float* su = smem;                          // [kChunk][CH]
  float* sdt = su + kChunk * CH;
  float* sdy = sdt + kChunk * CH;
  float* sB = sdy + kChunk * CH;             // [kChunk][L]
  float* sC = sB + kChunk * L;
  float* red_b = sC + kChunk * L;            // [kSub][kWarps][L]
  float* red_c = red_b + kSub * kWarps * L;
  float* ss = red_c + kSub * kWarps * L;     // [kSubs][kThreads]: sub-chunk states
  const int tid = threadIdx.x, n = tid % L, ch = tid / L, b = blockIdx.y;
  const int warp = tid / 32, lane = tid % 32;
  const int i0 = blockIdx.x * CH, i = i0 + ch;
  const bool live = i < DI && n < DS;
  const float An = live ? A[static_cast<size_t>(i) * DS + n] : 0.f;
  const int nc = (S + kChunk - 1) / kChunk;
  float g = 0.f, a_next = 0.f, dA_acc = 0.f;
  for (int c = nc - 1; c >= 0; --c) {
    const int t0 = c * kChunk, len = min(kChunk, S - t0);
    __syncthreads();   // every read of the previous chunk's tiles is done
    load_chunk<L>(u, dt, dy, Bc, Cc, su, sdt, sdy, sB, sC, b, t0, len, i0, S, DI, DS,
                  sb_b, sb_t, sc_b, sc_t);
    __syncthreads();
    // pass A: the state entering each sub-chunk (all but the last are whole)
    float h = live ? states[((static_cast<size_t>(b) * nc + c) * DI + i) * DS + n] : 0.f;
    const int nsub = (len + kSub - 1) / kSub;
    ss[tid] = h;
    for (int k = 1; k < nsub; ++k) {
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const int tt = (k - 1) * kSub + j;
        const float d = sdt[tt * CH + ch];
        const float a = expf(__fmul_rn(d, An));
        h = __fadd_rn(__fmul_rn(a, h),
                      __fmul_rn(__fmul_rn(d, su[tt * CH + ch]), sB[tt * L + n]));
      }
      ss[k * kThreads + tid] = h;
    }
    // pass B: each sub-chunk, last first, recomputed and walked backwards
    for (int k = nsub - 1; k >= 0; --k) {
      const int base = k * kSub, m = min(kSub, len - base);
      const float h_in = ss[k * kThreads + tid];
      float hs[kSub], as[kSub];
      float hh = h_in;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        if (j < m) {
          const int tt = base + j;
          const float d = sdt[tt * CH + ch];
          const float a = expf(__fmul_rn(d, An));
          hh = __fadd_rn(__fmul_rn(a, hh),
                         __fmul_rn(__fmul_rn(d, su[tt * CH + ch]), sB[tt * L + n]));
          as[j] = a;
          hs[j] = hh;
        }
      }
#pragma unroll
      for (int j = kSub - 1; j >= 0; --j) {
        if (j < m) {
          const int tt = base + j;
          const float d = sdt[tt * CH + ch], uv = su[tt * CH + ch], yv = sdy[tt * CH + ch];
          g = __fadd_rn(__fmul_rn(yv, sC[tt * L + n]), __fmul_rn(a_next, g));
          const float dx = __fmul_rn(__fmul_rn(g, j > 0 ? hs[j > 0 ? j - 1 : 0] : h_in), as[j]);
          dA_acc = __fadd_rn(dA_acc, __fmul_rn(dx, d));
          const float ddt_a = lane_sum<L>(__fmul_rn(dx, An));
          const float dw = lane_sum<L>(__fmul_rn(g, sB[tt * L + n]));
          const float rb = warp_channel_sum<L>(__fmul_rn(g, __fmul_rn(d, uv)));
          const float rc = warp_channel_sum<L>(__fmul_rn(yv, hs[j]));
          if (n == 0 && i < DI) {
            const size_t off = (static_cast<size_t>(b) * S + t0 + tt) * DI + i;
            ddt[off] = __fadd_rn(ddt_a, __fmul_rn(dw, uv));
            du[off] = __fmul_rn(dw, d);
          }
          if (lane < L) {
            red_b[(j * kWarps + warp) * L + n] = rb;
            red_c[(j * kWarps + warp) * L + n] = rc;
          }
          a_next = as[j];
        }
      }
      __syncthreads();
      // the block's partial sums over its channels, its warps in order
      for (int p = tid; p < m * L; p += kThreads) {
        const int j = p / L, nn = p % L;
        if (nn >= DS) continue;
        float sb = red_b[j * kWarps * L + nn], sc = red_c[j * kWarps * L + nn];
        for (int w = 1; w < kWarps; ++w) {
          sb = __fadd_rn(sb, red_b[(j * kWarps + w) * L + nn]);
          sc = __fadd_rn(sc, red_c[(j * kWarps + w) * L + nn]);
        }
        const size_t o = ((static_cast<size_t>(blockIdx.x) * gridDim.y + b) * S + t0 + base + j)
                             * DS + nn;
        part_b[o] = sb;
        part_c[o] = sc;
      }
      __syncthreads();
    }
  }
  if (live) dA_part[(static_cast<size_t>(b) * DI + i) * DS + n] = dA_acc;
}

// dB, dC [B*S*DS] = the blocks' partials summed in block order; dA [DI*DS] =
// the batch's partials summed in batch order.
__global__ void __launch_bounds__(kThreads)
ssf_reduce_kernel(const float* __restrict__ part_b, const float* __restrict__ part_c,
                  const float* __restrict__ dA_part, float* __restrict__ dB,
                  float* __restrict__ dC, float* __restrict__ dA, long long n_bc, int blocks,
                  long long n_a, int B) {
  const long long total = 2 * n_bc + n_a;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; j < total;
       j += stride) {
    if (j < 2 * n_bc) {
      const bool is_b = j < n_bc;
      const long long jj = is_b ? j : j - n_bc;
      const float* part = is_b ? part_b : part_c;
      float s = part[jj];
      for (int k = 1; k < blocks; ++k) s = __fadd_rn(s, part[k * n_bc + jj]);
      (is_b ? dB : dC)[jj] = s;
    } else {
      const long long jj = j - 2 * n_bc;
      float s = dA_part[jj];
      for (int k = 1; k < B; ++k) s = __fadd_rn(s, dA_part[k * n_a + jj]);
      dA[jj] = s;
    }
  }
}

// Lanes a channel for DS (8, 16 or 32), 0 when DS is out of range.
int lanes_for(int DS) {
  return DS < 1 ? 0 : DS <= 8 ? 8 : DS <= 16 ? 16 : DS <= 32 ? 32 : 0;
}

int check_shape(int B, int S, int DI, int DS, int dtype) {
  if (B <= 0 || B > 65535 || S <= 0 || DI <= 0 || lanes_for(DS) == 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int L, typename In>
int launch_fwd(const void* u, const void* dt, const void* A, const void* Bc, const void* Cc,
               void* y, void* states, int B, int S, int DI, int DS, long long sb_b,
               long long sb_t, long long sc_b, long long sc_t, cudaStream_t stream) {
  constexpr int CH = kThreads / L;
  dim3 grid((DI + CH - 1) / CH, B);
  ssf_fwd_kernel<L, In><<<grid, kThreads, 0, stream>>>(
      static_cast<const In*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const In*>(Bc), static_cast<const In*>(Cc),
      static_cast<float*>(y), static_cast<float*>(states), S, DI, DS, sb_b, sb_t, sc_b, sc_t);
  return static_cast<int>(cudaGetLastError());
}

template <int L, typename In>
int launch_bwd(const void* u, const void* dt, const void* A, const void* Bc, const void* Cc,
               const void* states, const void* dy, void* du, void* ddt, void* part_b,
               void* part_c, void* dA_part, int B, int S, int DI, int DS, long long sb_b,
               long long sb_t, long long sc_b, long long sc_t, cudaStream_t stream) {
  constexpr int CH = kThreads / L;
  constexpr int smem = bwd_smem_floats<L>() * 4;
  cudaError_t err = cudaFuncSetAttribute(ssf_bwd_kernel<L, In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((DI + CH - 1) / CH, B);
  ssf_bwd_kernel<L, In><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(u), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const In*>(Bc), static_cast<const In*>(Cc),
      static_cast<const float*>(states), static_cast<const float*>(dy),
      static_cast<float*>(du), static_cast<float*>(ddt), static_cast<float*>(part_b),
      static_cast<float*>(part_c), static_cast<float*>(dA_part), S, DI, DS, sb_b, sb_t, sc_b,
      sc_t);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro

// The channel blocks of the fused kernels at (DI, DS): the first axis of the
// backward's partials of dB and dC. 0 when DS is above 32 or below 1.
extern "C" int repro_selective_scan_fused_blocks(int DI, int DS) {
  const int L = repro::lanes_for(DS);
  if (L == 0 || DI <= 0) return 0;
  const int CH = repro::kThreads / L;
  return (DI + CH - 1) / CH;
}

// C entry point of the forward. u [B,S,DI] (dtype 0: f32, 1: bf16), dt
// [B,S,DI] f32, A [DI,DS] f32 and y [B,S,DI] f32 contiguous; Bc, Cc [B,S,DS]
// in u's dtype with element strides (sb_b, sb_t) and (sc_b, sc_t) over batch
// and time and unit stride over DS; states [B, ceil(S/64), DI, DS] f32 or
// null (not written). Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_selective_scan_fused(const void* u, const void* dt, const void* A,
                                          const void* Bc, const void* Cc, void* y,
                                          void* states, int B, int S, int DI, int DS,
                                          long long sb_b, long long sb_t, long long sc_b,
                                          long long sc_t, int dtype, void* stream) {
  using namespace repro;
  if (int e = check_shape(B, S, DI, DS, dtype)) return e;
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_SSF_FWD(L, T)                                                                \
  return launch_fwd<L, T>(u, dt, A, Bc, Cc, y, states, B, S, DI, DS, sb_b, sb_t, sc_b, \
                          sc_t, st)
  switch (lanes_for(DS) * 2 + dtype) {
    case 16: REPRO_SSF_FWD(8, float);
    case 17: REPRO_SSF_FWD(8, __nv_bfloat16);
    case 32: REPRO_SSF_FWD(16, float);
    case 33: REPRO_SSF_FWD(16, __nv_bfloat16);
    case 64: REPRO_SSF_FWD(32, float);
    default: REPRO_SSF_FWD(32, __nv_bfloat16);
  }
#undef REPRO_SSF_FWD
}

// C entry point of the backward: the forward's operands (as there), its
// states, dy [B,S,DI] f32 -> du, ddt [B,S,DI] f32, dB, dC [B,S,DS] f32 and dA
// [DI,DS] f32, all contiguous, through the scratch part_b, part_c [blocks,
// B, S, DS] f32 (blocks = repro_selective_scan_fused_blocks(DI, DS), checked)
// and dA_part [B, DI, DS] f32. Two launches (the backward, then the reduce).
// Returns cudaGetLastError() after them (0 on success).
extern "C" int repro_selective_scan_fused_bwd(
    const void* u, const void* dt, const void* A, const void* Bc, const void* Cc,
    const void* states, const void* dy, void* du, void* ddt, void* part_b, void* part_c,
    void* dA_part, void* dB, void* dC, void* dA, int blocks, int B, int S, int DI, int DS,
    long long sb_b, long long sb_t, long long sc_b, long long sc_t, int dtype, void* stream) {
  using namespace repro;
  if (int e = check_shape(B, S, DI, DS, dtype)) return e;
  if (blocks != repro_selective_scan_fused_blocks(DI, DS))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  int err;
#define REPRO_SSF_BWD(L, T)                                                                 \
  err = launch_bwd<L, T>(u, dt, A, Bc, Cc, states, dy, du, ddt, part_b, part_c, dA_part, B, \
                         S, DI, DS, sb_b, sb_t, sc_b, sc_t, st);                            \
  break
  switch (lanes_for(DS) * 2 + dtype) {
    case 16: REPRO_SSF_BWD(8, float);
    case 17: REPRO_SSF_BWD(8, __nv_bfloat16);
    case 32: REPRO_SSF_BWD(16, float);
    case 33: REPRO_SSF_BWD(16, __nv_bfloat16);
    case 64: REPRO_SSF_BWD(32, float);
    default: REPRO_SSF_BWD(32, __nv_bfloat16);
  }
#undef REPRO_SSF_BWD
  if (err != 0) return err;
  const long long n_bc = static_cast<long long>(B) * S * DS;
  const long long n_a = static_cast<long long>(DI) * DS;
  const long long need = (2 * n_bc + n_a + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(need < 65535 ? need : 65535);
  ssf_reduce_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(part_b), static_cast<const float*>(part_c),
      static_cast<const float*>(dA_part), static_cast<float*>(dB), static_cast<float*>(dC),
      static_cast<float*>(dA), n_bc, blocks, n_a, B);
  return static_cast<int>(cudaGetLastError());
}
