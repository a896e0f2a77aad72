// Decode attention for Hopper (sm_90a): one query token per (slot, head)
// against a KV cache held at kv heads.
//
// Replaces: src/repro/kernels/decode_attention.py, `_kernel` / `decode_attention`
// (the Pallas TPU kernel, grid (B, H, S/block_k) with the KV axis sequential).
// The JAX model path computes the same function with einsums
// (src/repro/models/layers.py `apply_attention_decode`); the port sends it here.
//
// Function: q [B,H,D], k/v [B,S,KV,D], lengths [B] int32 -> out [B,H,D].
//   q head h reads kv head h / (H/KV). Keys are valid where kpos < length and,
//   with a window, kpos >= length - window. Scores are (q.k)/sqrt(D) in f32,
//   optionally soft-capped (softcap * tanh(s / softcap)). If no key is valid
//   every score is the same masked value, so the softmax is uniform over all S
//   keys: the kernel then averages V over S, which is what the XLA path
//   (softmax over scores that are all -1e30) gives.
//
// What bounds it on the card: bytes. Each valid key costs 2*D*sizeof(T) bytes
// of K and V and about 4*D flops per query head in its group, far below the
// H100's 295 flops per byte. The floor is the K+V bytes of the valid prefix
// over 3.35 TB/s.
//
// What the design does about it:
//   * K/V are read once per kv head: the G = H/KV query heads of a group live
//     in the same warp's registers, so the cache is never expanded to H heads.
//   * Flash-decoding: the valid key range is cut into n_split pieces along S,
//     and each block (split, kv head, slot) runs 4 warps over its piece, so
//     B*KV*n_split blocks fill the 132 SMs even at small batch. Keys outside
//     [lo, hi) are never read.
//   * A warp reads whole 2*D-element K/V rows with 2- to 16-byte loads per
//     lane and keeps its running max, sum and accumulator in registers; every
//     warp writes its own (m, l, acc) partial.
//   * A second kernel combines the partials of a (slot, head) in a fixed order.
//     There are no atomics, so the result is bit-identical from run to run.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kWarps = 4;

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kWarps * 32)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int S, int H, int KV, int window, float softcap, float scale,
                    int n_split) {
  constexpr int EPL = D / 32;                                  // dims per lane
  constexpr int KEYS = GMAX <= 2 ? 4 : (GMAX == 4 ? 2 : 1);   // keys per step
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int G = H / KV;

  const int length = lengths[b];
  int hi = min(length, S);
  int lo = window > 0 ? max(length - window, 0) : 0;
  const bool uniform = hi <= lo;      // no valid key: softmax is uniform over S
  if (uniform) { lo = 0; hi = S; }
  const int chunk = (hi - lo + n_split - 1) / n_split;
  const int s0 = lo + split * chunk;
  const int s1 = min(hi, s0 + chunk);

  float qr[GMAX][EPL];
  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) { acc[g][e] = 0.f; qr[g][e] = 0.f; }
    if (g < G) load_row<T, EPL>(q + ((size_t)b * H + kvh * G + g) * D + lane * EPL, qr[g]);
  }

  const size_t row = (size_t)KV * D;
  const T* kb = k + ((size_t)b * S * KV + kvh) * D + lane * EPL;
  const T* vb = v + ((size_t)b * S * KV + kvh) * D + lane * EPL;
  for (int s = s0 + warp * KEYS; s < s1; s += kWarps * KEYS) {
    float kr[KEYS][EPL], vr[KEYS][EPL];
    bool ok[KEYS];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      ok[j] = s + j < s1;
#pragma unroll
      for (int e = 0; e < EPL; ++e) { kr[j][e] = 0.f; vr[j][e] = 0.f; }
      if (ok[j]) {
        load_row<T, EPL>(kb + (size_t)(s + j) * row, kr[j]);
        load_row<T, EPL>(vb + (size_t)(s + j) * row, vr[j]);
      }
    }
    float sc[KEYS][GMAX];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kr[j][e], part);
        sc[j][g] = part;
      }
    }
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float x = warp_sum(sc[j][g]) * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (uniform) x = 0.f;
        sc[j][g] = ok[j] ? x : -INFINITY;
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      float mx = sc[0][g];
#pragma unroll
      for (int j = 1; j < KEYS; ++j) mx = fmaxf(mx, sc[j][g]);
      const float m_new = fmaxf(m[g], mx);      // finite: key s is always valid
      const float alpha = expf(m[g] - m_new);   // exp(-inf) = 0 on the first key
      float p[KEYS];
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        p[j] = ok[j] ? expf(sc[j][g] - m_new) : 0.f;
        psum += p[j];
      }
      l[g] = l[g] * alpha + psum;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = acc[g][e] * alpha;
#pragma unroll
        for (int j = 0; j < KEYS; ++j) a = fmaf(p[j], vr[j][e], a);
        acc[g][e] = a;
      }
      m[g] = m_new;
    }
  }

  const int n_parts = n_split * kWarps;
  const int part = split * kWarps + warp;
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) continue;
    const size_t idx = ((size_t)b * H + kvh * G + g) * n_parts + part;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part_acc[idx * D + lane * EPL + e] = acc[g][e];
    if (lane == 0) {
      part_ml[idx * 2] = m[g];
      part_ml[idx * 2 + 1] = l[g];
    }
  }
}

// One block per (slot, head), one thread per dim: merge the n_parts partials
// in index order. A partial with l == 0 saw no key and weighs nothing.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part_acc,
                                      const float* __restrict__ part_ml,
                                      T* __restrict__ out, int D, int n_parts) {
  const size_t bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * n_parts * 2;
  float M = -INFINITY;
  for (int p = 0; p < n_parts; ++p)
    if (ml[2 * p + 1] > 0.f) M = fmaxf(M, ml[2 * p]);
  float L = 0.f, o = 0.f;
  for (int p = 0; p < n_parts; ++p) {
    const float lp = ml[2 * p + 1];
    if (lp > 0.f) {
      const float w = expf(ml[2 * p] - M);
      L = fmaf(w, lp, L);
      o = fmaf(w, part_acc[(bh * n_parts + p) * D + d], o);
    }
  }
  out[bh * D + d] = from_float<T>(L > 0.f ? o / L : 0.f);
}

template <typename T, int D, int GMAX>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         const int* lengths, float* part_acc, float* part_ml,
                         int B, int S, int H, int KV, int window, float softcap,
                         int n_split, cudaStream_t stream) {
  dim3 grid(n_split, KV, B);
  decode_split_kernel<T, D, GMAX><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, part_acc, part_ml, S, H, KV, window, softcap,
      1.0f / sqrtf(static_cast<float>(D)), n_split);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dispatch_group(int G, const void* q, const void* k, const void* v,
                           const int* lengths, float* part_acc, float* part_ml,
                           int B, int S, int H, int KV, int window, float softcap,
                           int n_split, cudaStream_t stream) {
#define REPRO_SPLIT(GM)                                                        \
  return launch_split<T, D, GM>(q, k, v, lengths, part_acc, part_ml, B, S, H, \
                                KV, window, softcap, n_split, stream)
  if (G <= 1) REPRO_SPLIT(1);
  if (G <= 2) REPRO_SPLIT(2);
  if (G <= 4) REPRO_SPLIT(4);
  if (G <= 8) REPRO_SPLIT(8);
  if (G <= 16) REPRO_SPLIT(16);
#undef REPRO_SPLIT
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dim(int D, int G, const void* q, const void* k,
                         const void* v, const int* lengths, float* part_acc,
                         float* part_ml, int B, int S, int H, int KV, int window,
                         float softcap, int n_split, cudaStream_t stream) {
  switch (D) {
    case 32:
      return dispatch_group<T, 32>(G, q, k, v, lengths, part_acc, part_ml, B, S,
                                   H, KV, window, softcap, n_split, stream);
    case 64:
      return dispatch_group<T, 64>(G, q, k, v, lengths, part_acc, part_ml, B, S,
                                   H, KV, window, softcap, n_split, stream);
    case 128:
      return dispatch_group<T, 128>(G, q, k, v, lengths, part_acc, part_ml, B, S,
                                    H, KV, window, softcap, n_split, stream);
    case 256:
      return dispatch_group<T, 256>(G, q, k, v, lengths, part_acc, part_ml, B, S,
                                    H, KV, window, softcap, n_split, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// C entry point. dtype: 0 = f32, 1 = bf16 (q, k, v and out share it).
// window <= 0 means no window; softcap <= 0 means no softcap. part_acc holds
// B*H*n_split*4*D floats and part_ml B*H*n_split*4*2 floats of scratch.
// Returns cudaGetLastError() after the two launches (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out,
                                      void* part_acc, void* part_ml, int B, int S,
                                      int H, int KV, int D, int dtype, int window,
                                      float softcap, int n_split, void* stream) {
  using namespace repro;
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || n_split <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / KV;
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  cudaError_t err = dtype == 0
      ? dispatch_dim<float>(D, G, q, k, v, len, pa, pm, B, S, H, KV, window,
                            softcap, n_split, st)
      : dispatch_dim<__nv_bfloat16>(D, G, q, k, v, len, pa, pm, B, S, H, KV,
                                    window, softcap, n_split, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_parts = n_split * kWarps;
  if (dtype == 0)
    decode_combine_kernel<float><<<B * H, D, 0, st>>>(
        pa, pm, static_cast<float*>(out), D, n_parts);
  else
    decode_combine_kernel<__nv_bfloat16><<<B * H, D, 0, st>>>(
        pa, pm, static_cast<__nv_bfloat16*>(out), D, n_parts);
  return static_cast<int>(cudaGetLastError());
}

// Number of warps, each of which writes one partial, in a block of the split
// kernel: the wrapper sizes the scratch with it.
extern "C" int repro_decode_attention_warps() { return repro::kWarps; }
