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
//   state entering every kInterval-th step, states [B, ceil(S/kInterval),
//   DI, DS] f32, for the backward. Every product and sum is rounded on its
//   own (__fmul_rn / __fadd_rn, never a fused multiply-add) and the
//   exponential is the accurate expf: the plain version
//   (`ref.selective_scan_fused_ref`) rounds the same operations, so only the
//   order of the sums over n (and, backward, over the channels) differs.
//
// What bounds it on the card: at falcon-mamba's train shape [2, 2048, 8192,
// 16] in f32 the bytes are u and dt read, y and the states written, 0.54 GB,
// 0.16 ms at the H100 SXM's 3.35 TB/s; its 537 M exponentials take 0.13 ms
// on the SFUs (16 a clock an SM, 132 SMs at 1.98 GHz). The rest is issue
// slots on the CUDA cores, and parallelism: only B * DI = 16,384 channels,
// each a sequential walk over S.
//
// What the design does about it (several states a thread):
//   * A thread owns K state elements h[n] of one channel in registers, and
//     P threads (neighbouring lanes) share the channel: at DS <= 16 K = 4
//     (DS <= 8: K = 2) and P = 4, at DS <= 32 K = 4 and P = 8 (`Layout`).
//     A block of 256 threads holds 256 / P channels (64, or 32 at DS 32),
//     so u, dt and y move as 256-byte rows; at the train shape 65,536
//     threads, one wave of about 15.5 warps an SM, each with K independent
//     h-chains.
//   * Per channel-step a thread reads dt and u once, forms w = dt u once,
//     takes its K values of B and C as one vector load each, and sums y over
//     its K states in registers before log2(P) shuffles (xor P/2 ... 1:
//     every lane of the channel gets the same bits).
//   * The next chunk of kFwdChunk steps is in flight while this one is
//     walked (two stages, by cp.async): f32 operands straight into the
//     stage (16-byte copies where the rows allow), bf16 ones as raw
//     element pairs, converted to f32 in shared memory once they land.
//
// The backward (ssf_bwd_kernel, then ssf_reduce_kernel) has no Pallas
// counterpart: JAX differentiates its XLA scan. The same layout walks each
// kInterval-step interval, last first, from the state the forward saved
// before it: the interval is recomputed forwards once (one exponential an
// element), its a kept in registers and each h_t in shared memory (a
// thread's own slots), then walked backwards with g the gradient reaching
// h_t: g_t = dy_t C_t + a_{t+1} g_{t+1} (that product taken as soon as
// g_{t+1} is known); dx = (g_t h_{t-1}) a_t; ddt = sum_n dx A + u sum_n g B;
// du = dt sum_n g B; dA += dx dt (per thread, over t last to first). The
// sums over n are K - 1 adds in registers and log2(P) shuffles. dB_t =
// sum_i g w and dC_t = sum_i dy h_t are each summed over a warp's channels
// by a shuffle reduce-scatter (a lane ends with the sum of one n), then
// over the block's 8 warps in order through shared memory, into per-block
// partials [ceil(DI / channels a block), B, S, DS]; ssf_reduce_kernel sums
// them over the blocks, and dA's per-batch partials over the batch, each in
// a fixed order. No atomics: every call gives the same bits. Registers hold
// the interval's a but its first step's, which waits in shared memory with
// the thread's A: with them the kernel fits 128 registers, two blocks an SM,
// without spills.
//
// What bounds the backward: bytes, u, dt, dy, the states and the rows read
// and du, ddt written, 0.81 GB at the train shape (0.24 ms at 3.35 TB/s),
// beside one exponential an element (0.13 ms on the SFUs) and the partials
// (2 x 33.5 MB written and read again at DS 16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro {
namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kInterval = 16;              // steps between saved states (ref.FUSED_CHUNK)
constexpr int kFwdChunk = 64;              // steps the forward stages at a time
constexpr unsigned kFull = 0xffffffffu;

// A thread's states (K), the threads of a channel (P) and a block's channels
// (CH) for the lanes L a channel would need at one state a lane.
template <int L>
struct Layout {
  static constexpr int K = L == 8 ? 2 : 4;
  static constexpr int P = L / K;
  static constexpr int CH = kThreads / P;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// cp.async of 4 or 16 bytes; bytes past `src_bytes` are zero-filled (0: the
// source is not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Sum over the P threads of a channel (xor P/2 ... 1): the same bits in each.
template <int P>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// Sum of v[0..M) over the channels of a warp (the lanes that differ in bits
// OFF ... P), as a reduce-scatter: at each bit while M > 1 a lane keeps half
// its values and adds its partner's sums of them, so `first` (the index of
// v[0] among the original M) follows the lane's bits; once one value is
// left the remaining bits are summed outright (both partners then hold it).
template <int M, int OFF, int P>
__device__ __forceinline__ void channel_sum(float* v, int lane, int& first) {
  if constexpr (OFF >= P) {
    if constexpr (M > 1) {
      constexpr int H = M / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int x = 0; x < H; ++x) {
        const float send = up ? v[x] : v[x + H];
        const float keep = up ? v[x + H] : v[x];
        v[x] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, OFF));
      }
      if (up) first += H;
      channel_sum<H, OFF / 2, P>(v, lane, first);
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], OFF));
      channel_sum<1, OFF / 2, P>(v, lane, first);
    }
  }
}

__host__ __device__ constexpr int log2_of(int x) { return x <= 1 ? 0 : 1 + log2_of(x / 2); }

// What `channel_sum<K, 16, P>` leaves: values a lane (R) and the lane bits
// whose partners hold the same sums (Dup).
template <int K, int P>
struct ChannelSumShape {
  static constexpr int C = log2_of(32 / P);         // channel bits of a warp
  static constexpr int H = C < log2_of(K) ? C : log2_of(K);
  static constexpr int R = K >> H;
  static constexpr int Dup = (P << (C - H)) - P;
};

template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x; v[1] = x.y;
  }
}
template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// The block's coordinates read afresh: what the staging code derives from
// them is then computed where it is used, not held in registers across the
// walk.
__device__ __forceinline__ int block_x() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(v));
  return v;
}
__device__ __forceinline__ int block_y() {
  int v;
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(v));
  return v;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}
// 1 where a bf16 row starts between 4-byte words: its pairs then start one
// element before it.
__device__ __forceinline__ int pair_shift(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 1) & 1);
}

// The f32 rows [T][CH] of a [B,S,DI] operand at (b, t0 .. t0 + len, i0 ..
// i0 + CH) by cp.async, zeros past S and DI: 16-byte copies where DI is a
// multiple of 4 and the operand 16-byte aligned (`vec`), else 4-byte ones.
template <int T, int CH>
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int b, int t0, int len,
                                           int i0, int S, int DI, bool vec) {
  if (vec) {
    constexpr int Q = CH / 4;
    for (int idx = threadIdx.x; idx < T * Q; idx += kThreads) {
      const int tt = idx / Q, c4 = (idx % Q) * 4, ii = i0 + c4;
      const bool in = tt < len && ii < DI;
      const float* s = in ? src + (static_cast<size_t>(b) * S + t0 + tt) * DI + ii : src;
      cp_async16(dst + tt * CH + c4, s, in);
    }
  } else {
    for (int idx = threadIdx.x; idx < T * CH; idx += kThreads) {
      const int tt = idx / CH, ii = i0 + idx % CH;
      const bool in = tt < len && ii < DI;
      const float* s = in ? src + (static_cast<size_t>(b) * S + t0 + tt) * DI + ii : src;
      cp_async4(dst + idx, s, in);
    }
  }
}

// Where a stage's rows of u, B and C come from: chunk rows t0 .. t0 + len of
// batch b, the block's channels from i0.
template <typename In>
struct Rows {
  const In *u, *Bc, *Cc;
  int b, t0, len, i0, S, DI, DS;
  long long sb_b, sb_t, sc_b, sc_t;
  __device__ const In* u_row(int tt) const {
    return u + (static_cast<size_t>(b) * S + t0 + tt) * DI + i0;
  }
  __device__ const In* b_row(int tt) const { return Bc + b * sb_b + (t0 + tt) * sb_t; }
  __device__ const In* c_row(int tt) const { return Cc + b * sc_b + (t0 + tt) * sc_t; }
  // pair_shift of those rows in 32-bit arithmetic (only the low bit counts)
  static __device__ int shift_of(const In* base, unsigned off) {
    return static_cast<int>((static_cast<unsigned>(reinterpret_cast<uintptr_t>(base)) / 2 + off)
                            & 1);
  }
  __device__ int u_shift(int tt) const {
    return shift_of(u, (static_cast<unsigned>(b) * S + t0 + tt) * DI + i0);
  }
  __device__ int b_shift(int tt) const {
    return shift_of(Bc, static_cast<unsigned>(b * sb_b + (t0 + tt) * sb_t));
  }
  __device__ int c_shift(int tt) const {
    return shift_of(Cc, static_cast<unsigned>(b * sc_b + (t0 + tt) * sc_t));
  }
};

// f32 rows [T][W] (row tt at row_of(tt), nv elements) by 4-byte cp.async,
// zeros past nv and past len rows.
template <int T, int W, typename F>
__device__ __forceinline__ void copy_rows(float* dst, int len, int nv, F row_of) {
  for (int idx = threadIdx.x; idx < T * W; idx += kThreads) {
    const int tt = idx / W, j = idx % W;
    const bool in = tt < len && j < nv;
    const float* row = row_of(in ? tt : 0);
    cp_async4(dst + idx, in ? row + j : row, in);
  }
}

// bf16 rows [T][W] as raw pairs [T][W + 2] by 4-byte cp.async: pair q of a
// row holds its elements 2q - pair_shift(row) and the next (a row's pairs
// start at its own word boundary); bytes past nv and rows past len are
// zero-filled, never read. (A pair that starts one element before its row
// reads memory inside the same allocation: an allocation starts on a
// word.)
template <int T, int W, typename F>
__device__ __forceinline__ void copy_raw(__nv_bfloat16* raw, int len, int nv, F row_of) {
  constexpr int U = W / 2 + 1;
  for (int idx = threadIdx.x; idx < T * U; idx += kThreads) {
    const int tt = idx / U, q = idx % U;
    const __nv_bfloat16* row = row_of(tt < len ? tt : 0);
    const int e0 = 2 * q - pair_shift(row);
    const int n = tt < len ? min(2, max(0, nv - e0)) : 0;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(raw + tt * (W + 2) + 2 * q)),
                 "l"(row + e0), "r"(2 * n)
                 : "memory");
  }
}

// The f32 rows [T][W] of the pairs this thread copied with `copy_raw` (once
// its copies have landed: no other thread's are read, so no barrier comes
// between); shift_of(tt) is pair_shift of row tt.
template <int T, int W, typename F>
__device__ __forceinline__ void convert_raw(float* dst, const __nv_bfloat16* raw, int len,
                                            F shift_of) {
  constexpr int U = W / 2 + 1;
  for (int idx = threadIdx.x; idx < T * U; idx += kThreads) {
    const int tt = idx / U, q = idx % U;
    const int e0 = 2 * q - shift_of(tt < len ? tt : 0);
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(raw + tt * (W + 2) + 2 * q);
    if (e0 >= 0 && e0 < W) dst[tt * W + e0] = __low2float(v);
    if (e0 + 1 < W) dst[tt * W + e0 + 1] = __high2float(v);
  }
}

// A stage's u [T][CH] (the block's channels) and B, C [T][L] (zero past DS)
// in f32: f32 operands straight into the stage by cp.async (`issue_in`),
// bf16 ones as raw pairs into `raw` (`issue_in`) and converted into the
// stage once they have landed (`convert_in`, by the threads that copied
// them).
template <typename In, int T, int CH, int L>
struct InStage {
  static constexpr bool kF32 = std::is_same<In, float>::value;
  // floats of the raw pairs: u [T][CH + 2], B and C [T][L + 2] bf16
  static constexpr int kRawFloats = kF32 ? 0 : (T * (CH + 2) + 2 * T * (L + 2)) / 2;

  static __device__ __forceinline__ void issue_in(float* su, float* sB, float* sC, float* raw,
                                                  const Rows<In>& r, bool vec) {
    if constexpr (kF32) {
      stage_rows<T, CH>(su, r.u, r.b, r.t0, r.len, r.i0, r.S, r.DI, vec);
      copy_rows<T, L>(sB, r.len, r.DS, [&](int tt) { return r.b_row(tt); });
      copy_rows<T, L>(sC, r.len, r.DS, [&](int tt) { return r.c_row(tt); });
    } else {
      auto* ru = reinterpret_cast<__nv_bfloat16*>(raw);
      copy_raw<T, CH>(ru, r.len, r.DI - r.i0, [&](int tt) { return r.u_row(tt); });
      copy_raw<T, L>(ru + T * (CH + 2), r.len, r.DS, [&](int tt) { return r.b_row(tt); });
      copy_raw<T, L>(ru + T * (CH + 2) + T * (L + 2), r.len, r.DS,
                     [&](int tt) { return r.c_row(tt); });
    }
  }
  static __device__ __forceinline__ void convert_in(float* su, float* sB, float* sC,
                                                    const float* raw, const Rows<In>& r) {
    if constexpr (!kF32) {
      auto* ru = reinterpret_cast<const __nv_bfloat16*>(raw);
      convert_raw<T, CH>(su, ru, r.len, [&](int tt) { return r.u_shift(tt); });
      convert_raw<T, L>(sB, ru + T * (CH + 2), r.len, [&](int tt) { return r.b_shift(tt); });
      convert_raw<T, L>(sC, ru + T * (CH + 2) + T * (L + 2), r.len,
                        [&](int tt) { return r.c_shift(tt); });
    }
  }
};

// Whether the f32 rows of dt, dy and an f32 u can move as 16-byte copies.
template <typename In>
__device__ __forceinline__ bool rows_vec(int DI, const In* u, const float* dt, const float* dy) {
  return DI % 4 == 0 && aligned16(dt) && (dy == nullptr || aligned16(dy)) &&
         (!std::is_same<In, float>::value || aligned16(u));
}

// Floats of the forward's dynamic shared memory: two stages of u, dt [T][CH]
// and B, C [T][L], y [T][CH], then the raw bf16 pairs.
template <int L, typename In>
__host__ __device__ constexpr int fwd_smem_floats() {
  constexpr int CH = Layout<L>::CH;
  return 2 * (2 * kFwdChunk * CH + 2 * kFwdChunk * L) + kFwdChunk * CH
         + InStage<In, kFwdChunk, CH, L>::kRawFloats;
}

template <int L, typename In>
__global__ void __launch_bounds__(kThreads, 2)
ssf_fwd_kernel(const In* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ A, const In* __restrict__ Bc,
               const In* __restrict__ Cc, float* __restrict__ y,
               float* __restrict__ states, int S, int DI, int DS, long long sb_b,
               long long sb_t, long long sc_b, long long sc_t) {
  constexpr int K = Layout<L>::K, P = Layout<L>::P, CH = Layout<L>::CH, T = kFwdChunk;
  constexpr int kStage = 2 * T * CH + 2 * T * L;
  using Stage = InStage<In, T, CH, L>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sy = smem + 2 * kStage;
  float* raw = sy + T * CH;
  const int tid = threadIdx.x, p = tid % P, ch = tid / P, b = blockIdx.y;
  const int i0 = blockIdx.x * CH, i = i0 + ch, n0 = p * K;
  const bool live = i < DI;
  float An[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    An[k] = live && n0 + k < DS ? A[static_cast<size_t>(i) * DS + n0 + k] : 0.f;
    h[k] = 0.f;
  }
  const int nc = (S + T - 1) / T, ni = (S + kInterval - 1) / kInterval;
  auto rows = [&](int c) {
    const int t0 = c * T;
    return Rows<In>{u, Bc, Cc, block_y(), t0, min(T, S - t0), block_x() * CH,
                    S, DI, DS, sb_b, sb_t, sc_b, sc_t};
  };
  // stage c: u [T][CH], dt [T][CH], B [T][L], C [T][L]
  auto issue = [&](int c) {
    float* st = smem + (c & 1) * kStage;
    const Rows<In> r = rows(c);
    const bool vec = rows_vec(DI, u, dt, static_cast<const float*>(nullptr));
    stage_rows<T, CH>(st + T * CH, dt, r.b, r.t0, r.len, r.i0, S, DI, vec);
    Stage::issue_in(st, st + 2 * T * CH, st + 2 * T * CH + T * L, raw, r, vec);
    cp_commit();
  };
  auto convert = [&](int c) {
    float* st = smem + (c & 1) * kStage;
    Stage::convert_in(st, st + 2 * T * CH, st + 2 * T * CH + T * L, raw, rows(c));
  };
  issue(0);
  cp_wait<0>();
  convert(0);
  for (int c = 0; c < nc; ++c) {
    const int t0 = c * T, len = min(T, S - t0);
    // stage c complete; the raw pairs and the other stage free
    __syncthreads();
    if (c + 1 < nc) issue(c + 1);
    const float* st = smem + (c & 1) * kStage;
    const float *su = st, *sdt = st + T * CH, *sB = st + 2 * T * CH, *sC = sB + T * L;
    // whole intervals: a step past S reads zeros (dt 0, so a = 1 and b = 0)
    // and leaves h as it is; its y is not written out
    for (int base = 0; base < len; base += kInterval) {
      if (states != nullptr && live) {
        float* sp = states + ((static_cast<size_t>(b) * ni + (t0 + base) / kInterval) * DI + i)
                                 * DS + n0;
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (n0 + k < DS) sp[k] = h[k];
      }
#pragma unroll
      for (int j = 0; j < kInterval; ++j) {
        const int tt = base + j;
        const float d = sdt[tt * CH + ch];
        const float w = __fmul_rn(d, su[tt * CH + ch]);
        float Bv[K], Cv[K];
        load_k<K>(sB + tt * L + n0, Bv);
        load_k<K>(sC + tt * L + n0, Cv);
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float a = expf(__fmul_rn(d, An[k]));
          h[k] = __fadd_rn(__fmul_rn(a, h[k]), __fmul_rn(w, Bv[k]));
          const float pr = __fmul_rn(h[k], Cv[k]);
          acc = k == 0 ? pr : __fadd_rn(acc, pr);
        }
        acc = lane_sum<P>(acc);
        if (p == 0) sy[tt * CH + ch] = acc;
      }
    }
    cp_wait<0>();   // chunk c + 1's copies landed
    if (c + 1 < nc) convert(c + 1);
    __syncthreads();   // sy and stage c + 1 complete
    for (int idx = tid; idx < len * CH; idx += kThreads) {
      const int tt = idx / CH, ii = i0 + idx % CH;
      if (ii < DI) y[(static_cast<size_t>(b) * S + t0 + tt) * DI + ii] = sy[idx];
    }
  }
}

// Steps of dB / dC warp sums the backward holds before it sums them over
// the warps: half an interval, a quarter beside the raw pairs of bf16
// operands, so that all fits two blocks an SM.
template <typename In>
__host__ __device__ constexpr int red_steps() {
  return std::is_same<In, float>::value ? kInterval / 2 : kInterval / 4;
}

// Floats of the backward's dynamic shared memory: two stages of u, dt, dy
// [T][CH] and B, C [T][L]; each thread's h_{j-1} for j = 0 .. T, [T +
// 1][kThreads][K]; the warp sums of dB and dC [red_steps][kWarps][2L]; the
// raw bf16 pairs; each thread's A and its interval's first a [2][kThreads][K]
// (read where they are used, so that the registers hold the other a).
template <int L>
__host__ __device__ constexpr int bwd_stage_floats() {
  return 3 * kInterval * Layout<L>::CH + 2 * kInterval * L;
}
template <int L, typename In>
__host__ __device__ constexpr int bwd_smem_floats() {
  return 2 * bwd_stage_floats<L>() + (kInterval + 1) * kThreads * Layout<L>::K
         + red_steps<In>() * kWarps * 2 * L
         + InStage<In, kInterval, Layout<L>::CH, L>::kRawFloats + 2 * kThreads * Layout<L>::K;
}

template <int L, typename In>
__global__ void __launch_bounds__(kThreads, 2)
ssf_bwd_kernel(const In* __restrict__ u, const float* __restrict__ dt,
               const float* __restrict__ A, const In* __restrict__ Bc,
               const In* __restrict__ Cc, const float* __restrict__ states,
               const float* __restrict__ dy, float* __restrict__ du,
               float* __restrict__ ddt, float* __restrict__ part_b,
               float* __restrict__ part_c, float* __restrict__ dA_part, int S, int DI,
               int DS, long long sb_b, long long sb_t, long long sc_b, long long sc_t) {
  constexpr int K = Layout<L>::K, P = Layout<L>::P, CH = Layout<L>::CH, T = kInterval;
  constexpr int kStage = bwd_stage_floats<L>(), RS = red_steps<In>();
  using Shape = ChannelSumShape<K, P>;
  using Stage = InStage<In, T, CH, L>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hbuf = smem + 2 * kStage;                 // [T + 1][kThreads][K]
  float* red = hbuf + (T + 1) * kThreads * K;      // [RS][kWarps][2L]
  float* raw = red + RS * kWarps * 2 * L;
  const int tid = threadIdx.x, p = tid % P, ch = tid / P, b = blockIdx.y;
  float* sA = raw + Stage::kRawFloats + tid * K;   // this thread's A
  float* sa0 = sA + kThreads * K;                    // and its a at step 0
  const int warp = tid / 32, lane = tid % 32;
  const int i0 = blockIdx.x * CH, i = i0 + ch, n0 = p * K;
  const bool live = i < DI;
  float gp[K], dA[K];   // gp: a_{t+1} g_{t+1}, what reaches g_t
#pragma unroll
  for (int k = 0; k < K; ++k) {
    sA[k] = live && n0 + k < DS ? A[static_cast<size_t>(i) * DS + n0 + k] : 0.f;
    gp[k] = dA[k] = 0.f;
  }
  const int ni = (S + T - 1) / T;
  auto rows = [&](int k) {
    const int t0 = k * T;
    return Rows<In>{u, Bc, Cc, block_y(), t0, min(T, S - t0), block_x() * CH,
                    S, DI, DS, sb_b, sb_t, sc_b, sc_t};
  };
  // stage k: u, dt, dy [T][CH], B, C [T][L]
  auto issue = [&](int k) {
    float* st = smem + (k & 1) * kStage;
    const Rows<In> r = rows(k);
    const bool vec = rows_vec(DI, u, dt, dy);
    stage_rows<T, CH>(st + T * CH, dt, r.b, r.t0, r.len, r.i0, S, DI, vec);
    stage_rows<T, CH>(st + 2 * T * CH, dy, r.b, r.t0, r.len, r.i0, S, DI, vec);
    Stage::issue_in(st, st + 3 * T * CH, st + 3 * T * CH + T * L, raw, r, vec);
    cp_commit();
  };
  auto convert = [&](int k) {
    float* st = smem + (k & 1) * kStage;
    Stage::convert_in(st, st + 3 * T * CH, st + 3 * T * CH + T * L, raw, rows(k));
  };
  issue(ni - 1);
  cp_wait<0>();
  convert(ni - 1);
  for (int k = ni - 1; k >= 0; --k) {
    const int t0 = k * T, m = min(T, S - t0);
    float h[K];
    {
      const float* sp = states + ((static_cast<size_t>(b) * ni + k) * DI + i) * DS + n0;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) h[kk] = live && n0 + kk < DS ? sp[kk] : 0.f;
    }
    // stage k complete; the raw pairs, the other stage and the sums free
    __syncthreads();
    if (k > 0) issue(k - 1);
    const float* st = smem + (k & 1) * kStage;
    const float *su = st, *sdt = st + T * CH, *sdy = st + 2 * T * CH;
    const float *sB = st + 3 * T * CH, *sC = sB + T * L;
    // the interval forwards from its state: a kept, h_{j-1} in hbuf[j]. A
    // step past S reads zeros: a = 1, b = 0, and backwards g = 0, so it
    // changes nothing, and neither its du, ddt nor its sums are written.
    float as[T][K];
    store_k<K>(hbuf + tid * K, h);
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float d = sdt[j * CH + ch];
      const float w = __fmul_rn(d, su[j * CH + ch]);
      float Bv[K], An[K];
      load_k<K>(sB + j * L + n0, Bv);
      load_k<K>(sA, An);
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        as[j][kk] = expf(__fmul_rn(d, An[kk]));
        h[kk] = __fadd_rn(__fmul_rn(as[j][kk], h[kk]), __fmul_rn(w, Bv[kk]));
      }
      if (j == 0) store_k<K>(sa0, as[0]);
      store_k<K>(hbuf + ((j + 1) * kThreads + tid) * K, h);
    }
    // then backwards: hbuf[j + 1] gives h_j, hbuf[j] h_{j-1}
#pragma unroll
    for (int j = T - 1; j >= 0; --j) {
      const float d = sdt[j * CH + ch], uv = su[j * CH + ch], yv = sdy[j * CH + ch];
      const float w = __fmul_rn(d, uv);
      float Bv[K], Cv[K], hp[K], hc[K], vb[K], vc[K], An[K];
      load_k<K>(sA, An);
      load_k<K>(sB + j * L + n0, Bv);
      load_k<K>(sC + j * L + n0, Cv);
      load_k<K>(hbuf + (j * kThreads + tid) * K, hp);
      load_k<K>(hbuf + ((j + 1) * kThreads + tid) * K, hc);
      float sa = 0.f, sw = 0.f, aj[K];
      if (j == 0) {
        load_k<K>(sa0, aj);
      } else {
#pragma unroll
        for (int kk = 0; kk < K; ++kk) aj[kk] = as[j][kk];
      }
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const float g = __fadd_rn(__fmul_rn(yv, Cv[kk]), gp[kk]);
        const float dx = __fmul_rn(__fmul_rn(g, hp[kk]), aj[kk]);
        dA[kk] = __fadd_rn(dA[kk], __fmul_rn(dx, d));
        const float xa = __fmul_rn(dx, An[kk]), gb = __fmul_rn(g, Bv[kk]);
        sa = kk == 0 ? xa : __fadd_rn(sa, xa);
        sw = kk == 0 ? gb : __fadd_rn(sw, gb);
        vb[kk] = __fmul_rn(g, w);
        vc[kk] = __fmul_rn(yv, hc[kk]);
        gp[kk] = __fmul_rn(aj[kk], g);
      }
      sa = lane_sum<P>(sa);
      sw = lane_sum<P>(sw);
      if (p == 0 && live && j < m) {
        const size_t off = (static_cast<size_t>(b) * S + t0 + j) * DI + i;
        ddt[off] = __fadd_rn(sa, __fmul_rn(sw, uv));
        du[off] = __fmul_rn(sw, d);
      }
      // dB's and dC's sums over the warp's channels, each into the lanes
      // that `Shape` names (of lanes holding the same sums, one writes dB,
      // another dC)
      float* rw = red + ((j % RS) * kWarps + warp) * 2 * L + n0;
      int fb = 0, fc = 0;
      channel_sum<K, 16, P>(vb, lane, fb);
      channel_sum<K, 16, P>(vc, lane, fc);
#pragma unroll
      for (int r = 0; r < Shape::R; ++r) {
        if ((lane & Shape::Dup) == 0) rw[fb + r] = vb[r];
        if ((lane & Shape::Dup) == (Shape::Dup & -Shape::Dup)) rw[L + fc + r] = vc[r];
      }
      if (j % RS == 0) {
        if (j == 0) cp_wait<0>();   // interval k - 1's copies landed
        __syncthreads();   // the sums complete
        // steps j .. j + RS - 1 of the block's partial sums, its warps in order
        for (int idx = tid; idx < RS * 2 * L; idx += kThreads) {
          const int jr = idx / (2 * L), slot = idx % (2 * L), nn = slot % L;
          if (j + jr >= m || nn >= DS) continue;
          const float* rp = red + jr * kWarps * 2 * L + slot;
          float s = rp[0];
#pragma unroll
          for (int wp = 1; wp < kWarps; ++wp) s = __fadd_rn(s, rp[wp * 2 * L]);
          const size_t o =
              ((static_cast<size_t>(blockIdx.x) * gridDim.y + b) * S + t0 + j + jr) * DS + nn;
          (slot < L ? part_b : part_c)[o] = s;
        }
        if (j != 0) __syncthreads();
        else if (k > 0) convert(k - 1);   // before the next barrier
      }
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (n0 + k < DS) dA_part[(static_cast<size_t>(b) * DI + i) * DS + n0 + k] = dA[k];
  }
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

// The lanes a channel would take at one state a lane (8, 16 or 32: the
// instance of DS), 0 when DS is out of range.
int lanes_for(int DS) {
  return DS < 1 ? 0 : DS <= 8 ? 8 : DS <= 16 ? 16 : DS <= 32 ? 32 : 0;
}

int channels_for(int DS) {
  switch (lanes_for(DS)) {
    case 8: return Layout<8>::CH;
    case 16: return Layout<16>::CH;
    case 32: return Layout<32>::CH;
    default: return 0;
  }
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
  constexpr int CH = Layout<L>::CH;
  constexpr int smem = fwd_smem_floats<L, In>() * 4;
  cudaError_t err = cudaFuncSetAttribute(ssf_fwd_kernel<L, In>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((DI + CH - 1) / CH, B);
  ssf_fwd_kernel<L, In><<<grid, kThreads, smem, stream>>>(
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
  constexpr int CH = Layout<L>::CH;
  constexpr int smem = bwd_smem_floats<L, In>() * 4;
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
  const int CH = repro::channels_for(DS);
  if (CH == 0 || DI <= 0) return 0;
  return (DI + CH - 1) / CH;
}

// Bytes of dynamic shared memory a block of the forward (backward = 0) or
// the backward (1) takes at DS and dtype (0: f32, 1: bf16); 0 when DS is
// out of range. A query, not a launch.
extern "C" int repro_selective_scan_fused_smem(int DS, int dtype, int backward) {
  using namespace repro;
  const bool bf = dtype == 1;
#define REPRO_SSF_SMEM(L)                                                              \
  return 4 * (backward ? (bf ? bwd_smem_floats<L, __nv_bfloat16>() : bwd_smem_floats<L, float>()) \
                       : (bf ? fwd_smem_floats<L, __nv_bfloat16>() : fwd_smem_floats<L, float>()))
  switch (lanes_for(DS)) {
    case 8: REPRO_SSF_SMEM(8);
    case 16: REPRO_SSF_SMEM(16);
    case 32: REPRO_SSF_SMEM(32);
    default: return 0;
  }
#undef REPRO_SSF_SMEM
}

// C entry point of the forward. u [B,S,DI] (dtype 0: f32, 1: bf16), dt
// [B,S,DI] f32, A [DI,DS] f32 and y [B,S,DI] f32 contiguous (4-byte
// aligned); Bc, Cc [B,S,DS] in u's dtype with element strides (sb_b, sb_t)
// and (sc_b, sc_t) over batch and time and unit stride over DS; states [B,
// ceil(S/16), DI, DS] f32 or null (not written). Returns cudaGetLastError()
// after the launch (0 on success).
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
