// Flash attention backward for Hopper (sm_90a), f32 on the CUDA cores.
//
// Replaces: nothing on the TPU side. The Pallas kernel of
// src/repro/kernels/flash_attention.py (`_kernel` / `flash_attention`) has no
// backward; the JAX train path differentiates query-chunked XLA attention
// (the attn_impl="xla" branch of `apply_attention` in
// src/repro/models/layers.py). The port trains through the f32 flash kernel of
// flash_attention.cu, so its gradient is this file.
//
// Function: the gradient of flash_attention.cu's forward. Inputs q [B,Sq,H,D],
// k/v [B,Sk,KV,D], the forward's out [B,Sq,H,D] and row log-sum-exp lse
// [B,H,Sq], and dout [B,Sq,H,D], all f32; outputs dq [B,Sq,H,D] and dk/dv
// [B,Sk,KV,D] f32 (delta [B,H,Sq] is scratch). With x = (q.k) / sqrt(D),
// s = softcap * tanh(x / softcap) (or x), P = exp(s - lse) on kept pairs and 0
// elsewhere (causal: kpos <= qpos, window: kpos > qpos - window, only when
// causal), delta = rowsum(dout * out):
//   dP = dout V^T,  dS = P * (dP - delta) * (1 - tanh^2) / sqrt(D),
//   dq = dS K,  dk = sum over the group's q heads of dS^T q,  dv = sum of P^T dout.
// q head h reads kv head h / (H/KV), as in the forward. Any Sq and Sk.
//
// What bounds it on the card: operations. Five products of the kept (q, k)
// pairs (S recomputed, dP, dq, dk, dv), 2.5 times the forward's flops, over
// the f32 peak off the tensor cores (67 TFLOP/s); TF32 could not meet 2e-5.
//
// What the design does about it (simple and deterministic first):
//   * No atomics anywhere, so the gradients are the same bits on every run
//     (the trainer's resume check compares losses with ==). Three launches:
//     delta (a warp per row); dk/dv, a block per (k tile, kv head, batch)
//     that loops over the group's q heads and over the q tiles in a fixed
//     order, the GQA sum inside the block; dq, a block per (q tile, head,
//     batch) that loops over the k tiles. Both recompute S and dP; P comes
//     from the saved lse, so nothing of size Sq x Sk touches device memory.
//   * Tiles in shared memory as f32 (rows padded by one word), 256 threads as
//     16 x 16, each with a register tile of the products, as in the forward.
//   * Tiles that causality or the window mask entirely are skipped.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kThreads = 256;  // 16 x 16 threads

__device__ __forceinline__ bool kept(int qpos, int kpos, int Sq, int Sk,
                                     int causal, int window) {
  if (qpos >= Sq || kpos >= Sk) return false;
  if (!causal) return true;
  if (kpos > qpos) return false;
  return window <= 0 || kpos > qpos - window;
}

// dst[r][d] (row stride D + 1) <- src[b, row0 + r, head, d]; zeros past S
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          int b, int row0, int S, int heads, int head) {
  for (int e = threadIdx.x; e < ROWS * D; e += kThreads) {
    const int r = e / D, d = e % D, pos = row0 + r;
    dst[r * (D + 1) + d] =
        pos < S ? src[(((size_t)b * S + pos) * heads + head) * D + d] : 0.f;
  }
}

// lse and delta of rows q0 .. q0 + BQ - 1 of head h (0 past Sq: masked anyway)
template <int BQ>
__device__ __forceinline__ void load_rows(float* sL, float* sD, const float* __restrict__ lse,
                                          const float* __restrict__ delta, int b, int h,
                                          int H, int q0, int Sq) {
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    const size_t g = ((size_t)b * H + h) * Sq + q0 + r;
    sL[r] = q0 + r < Sq ? lse[g] : 0.f;
    sD[r] = q0 + r < Sq ? delta[g] : 0.f;
  }
}

// The score tile of rows ty + 16 i (q) and columns tx + 16 j (k):
// P = exp(s - lse) and dS = P (dP - delta) (1 - tanh^2) scale, from the q, dO,
// K and V tiles in shared memory.
template <int D, int RQ, int CK>
__device__ __forceinline__ void score_tile(const float* sQ, const float* sO, const float* sK,
                                           const float* sV, const float* sL, const float* sD,
                                           int q0, int k0, int Sq, int Sk, int causal,
                                           int window, float softcap, float scale,
                                           float (&p)[RQ][CK], float (&ds)[RQ][CK]) {
  constexpr int LD = D + 1;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float s[RQ][CK], dp[RQ][CK];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < CK; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[RQ], o[RQ], c[CK], w[CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      a[i] = sQ[(ty + 16 * i) * LD + d];
      o[i] = sO[(ty + 16 * i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      c[j] = sK[(tx + 16 * j) * LD + d];
      w[j] = sV[(tx + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        s[i][j] = fmaf(a[i], c[j], s[i][j]);
        dp[i][j] = fmaf(o[i], w[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < CK; ++j) {
      float x = s[i][j] * scale, f = 1.f;
      if (softcap > 0.f) {
        const float t = tanhf(x / softcap);
        x = softcap * t;
        f = 1.f - t * t;
      }
      const float pr = kept(q0 + r, k0 + tx + 16 * j, Sq, Sk, causal, window)
                           ? expf(x - sL[r]) : 0.f;
      p[i][j] = pr;
      ds[i][j] = pr * (dp[i][j] - sD[r]) * f * scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
flash_bwd_delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                       float* __restrict__ delta, int Sq, int H, int D, int rows) {
  const int row = (blockIdx.x * kThreads + threadIdx.x) / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;   // row = (b * Sq + i) * H + h; whole warps leave
  const float* po = o + (size_t)row * D;
  const float* pd = dout + (size_t)row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s = fmaf(po[d], pd[d], s);
  s = warp_sum(s);
  if (lane == 0) {
    const int h = row % H, i = (row / H) % Sq, b = row / H / Sq;
    delta[((size_t)b * H + h) * Sq + i] = s;
  }
}

template <int D, int BQ, int BK>
constexpr int dkdv_smem_floats() {
  return 2 * BK * (D + 1) + 2 * BQ * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ;
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk,
                      int H, int KV, int causal, int window, float softcap, float scale) {
  constexpr int LD = D + 1, LDP = BK + 1;
  constexpr int RQ = BQ / 16;   // score rows per thread: ty + 16 i
  constexpr int CK = BK / 16;   // score columns per thread: tx + 16 j
  constexpr int RK = BK / 16;   // dk/dv rows per thread: ty + 16 i
  constexpr int DJ = D / 16;    // dims per thread: tx + 16 j
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;
  float* sP = sO + BQ * LD;
  float* sS = sP + BQ * LDP;
  float* sL = sS + BQ * LDP;
  float* sD = sL + BQ;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BK, G = H / KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  load_tile<D, BK>(sK, k, b, k0, Sk, KV, kvh);
  load_tile<D, BK>(sV, v, b, k0, Sk, KV, kvh);

  float acc_k[RK][DJ], acc_v[RK][DJ];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  // q tiles that hold a kept pair with some key of this tile
  const int k_last = min(k0 + BK, Sk) - 1;
  const int q_begin = causal ? k0 : 0;
  const int q_end = (causal && window > 0) ? min(Sq, k_last + window) : Sq;

  for (int g = 0; g < G; ++g) {   // fixed order: the GQA sum stays in the block
    const int h = kvh * G + g;
    for (int q0 = q_begin / BQ * BQ; q0 < q_end; q0 += BQ) {
      __syncthreads();   // the previous tile's readers are done (and K, V are in)
      load_tile<D, BQ>(sQ, q, b, q0, Sq, H, h);
      load_tile<D, BQ>(sO, dout, b, q0, Sq, H, h);
      load_rows<BQ>(sL, sD, lse, delta, b, h, H, q0, Sq);
      __syncthreads();
      float p[RQ][CK], ds[RQ][CK];
      score_tile<D, RQ, CK>(sQ, sO, sK, sV, sL, sD, q0, k0, Sq, Sk, causal, window,
                            softcap, scale, p, ds);
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          sP[(ty + 16 * i) * LDP + tx + 16 * j] = p[i][j];
          sS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
        }
      __syncthreads();
      // dv += P^T dO and dk += dS^T q, over the tile's q rows in order
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pk[RK], sk[RK], o[DJ], a[DJ];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          pk[i] = sP[r * LDP + ty + 16 * i];
          sk[i] = sS[r * LDP + ty + 16 * i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          o[j] = sO[r * LD + tx + 16 * j];
          a[j] = sQ[r * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            acc_v[i][j] = fmaf(pk[i], o[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sk[i], a[j], acc_k[i][j]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int kpos = k0 + ty + 16 * i;
    if (kpos >= Sk) continue;
    const size_t base = (((size_t)b * Sk + kpos) * KV + kvh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[base + tx + 16 * j] = acc_k[i][j];
      dv[base + tx + 16 * j] = acc_v[i][j];
    }
  }
}

template <int D, int BQ, int BK>
constexpr int dq_smem_floats() {
  return 2 * BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1) + 2 * BQ;
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, int H, int KV, int causal,
                    int window, float softcap, float scale) {
  constexpr int LD = D + 1, LDP = BK + 1;
  constexpr int RQ = BQ / 16;   // rows per thread: ty + 16 i
  constexpr int CK = BK / 16;   // score columns per thread: tx + 16 j
  constexpr int DJ = D / 16;    // dims per thread: tx + 16 j
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LD;
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  float* sL = sS + BQ * LDP;
  float* sD = sL + BQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  load_tile<D, BQ>(sQ, q, b, q0, Sq, H, h);
  load_tile<D, BQ>(sO, dout, b, q0, Sq, H, h);
  load_rows<BQ>(sL, sD, lse, delta, b, h, H, q0, Sq);

  float acc[RQ][DJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // k tiles that hold a kept key for some row of this q tile (as the forward)
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;

  for (int k0 = k_begin / BK * BK; k0 < k_end; k0 += BK) {
    __syncthreads();   // the previous tile's readers are done (and q, dO are in)
    load_tile<D, BK>(sK, k, b, k0, Sk, KV, kvh);
    load_tile<D, BK>(sV, v, b, k0, Sk, KV, kvh);
    __syncthreads();
    float p[RQ][CK], ds[RQ][CK];
    score_tile<D, RQ, CK>(sQ, sO, sK, sV, sL, sD, q0, k0, Sq, Sk, causal, window,
                          softcap, scale, p, ds);
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sS[(ty + 16 * i) * LDP + tx + 16 * j] = ds[i][j];
    __syncthreads();
    // dq += dS K, over the tile's keys in order
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sr[RQ], kk[DJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sr[i] = sS[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kk[j] = sK[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(sr[i], kk[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    float* dst = dq + (((size_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = acc[i][j];
  }
}

struct BwdArgs {
  const float *q, *k, *v, *out, *dout, *lse;
  float *delta, *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, causal, window;
  float softcap;
};

template <int D, int BQ, int BK>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr int dkdv_bytes = dkdv_smem_floats<D, BQ, BK>() * static_cast<int>(sizeof(float));
  constexpr int dq_bytes = dq_smem_floats<D, BQ, BK>() * static_cast<int>(sizeof(float));
  static std::atomic<uint64_t> dkdv_set{0}, dq_set{0};
  cudaError_t err = set_smem_once(dkdv_set, flash_bwd_dkdv_kernel<D, BQ, BK>, dkdv_bytes);
  if (err != cudaSuccess) return err;
  err = set_smem_once(dq_set, flash_bwd_dq_kernel<D, BQ, BK>, dq_bytes);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));

  const int rows = a.B * a.Sq * a.H;
  flash_bwd_delta_kernel<<<(rows + kThreads / 32 - 1) / (kThreads / 32), kThreads, 0,
                           stream>>>(a.out, a.dout, a.delta, a.Sq, a.H, D, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_kv((a.Sk + BK - 1) / BK, a.KV, a.B);
  flash_bwd_dkdv_kernel<D, BQ, BK><<<grid_kv, kThreads, dkdv_bytes, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dk, a.dv, a.Sq, a.Sk, a.H, a.KV,
      a.causal, a.window, a.softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 grid_q((a.Sq + BQ - 1) / BQ, a.H, a.B);
  flash_bwd_dq_kernel<D, BQ, BK><<<grid_q, kThreads, dq_bytes, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.dq, a.Sq, a.Sk, a.H, a.KV, a.causal,
      a.window, a.softcap, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// C entry point, f32 only. q, out, dout, dq: [B,Sq,H,D]; k, v, dk, dv:
// [B,Sk,KV,D]; lse, delta: [B,H,Sq] (delta is scratch, written here). causal
// is 0 or 1; window <= 0 means no window; softcap <= 0 means none. Runs three
// kernels on `stream` in order and returns the first launch error (0 on
// success).
extern "C" int repro_flash_attention_bwd(const float* q, const float* k, const float* v,
                                         const float* out, const float* dout,
                                         const float* lse, float* delta, float* dq,
                                         float* dk, float* dv, int B, int Sq, int Sk,
                                         int H, int KV, int D, int causal, int window,
                                         float softcap, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const BwdArgs a{q, k, v, out, dout, lse, delta, dq, dk, dv,
                  B, Sq, Sk, H, KV, causal, window, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = launch<32, 64, 64>(a, st); break;
    case 64: err = launch<64, 64, 64>(a, st); break;
    case 128: err = launch<128, 64, 64>(a, st); break;
    case 256: err = launch<256, 32, 32>(a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
