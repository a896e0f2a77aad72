// Flash attention forward for Hopper (sm_90a): blockwise online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, `_kernel` / `flash_attention`
// (the Pallas TPU kernel, grid (B, H, S/bq, S/bk) with the k axis sequential,
// reached from the model through `_pallas_attn` in src/repro/models/layers.py).
// Forward only: the backward comes with the training slice.
//
// Function: q [B,Sq,H,D], k/v [B,Sk,KV,D] -> out [B,Sq,H,D] in q's dtype.
//   q head h reads kv head h / (H/KV): the GQA repeat of the JAX caller is
//   never materialised. Scores (q.k)/sqrt(D) in f32, optional tanh softcap,
//   causal mask kpos <= qpos with an optional window kpos > qpos - window
//   (only when causal, as on the TPU). Masked scores are -1e30, running max,
//   sum and accumulator are f32, and a row whose sum is 0 outputs 0. Any Sq and
//   Sk: the ragged last tile is masked here (the TPU kernel asserted S % block).
//
// What bounds it on the card: operations. At S = 2048 and D = 128 a (b, h)
// pair does ~4*S*S*D/2 causal flops on 4*S*D*sizeof(T) bytes, hundreds of
// flops per byte, above the H100's ridge. The floor is the causal flops over
// the tensor cores' peak (989 TFLOP/s bf16).
//
// What the design does about it (simple first; wgmma, TMA and warp
// specialisation are for a later change):
//   * One block per (q tile of 64 rows, head, batch); the loop over k tiles
//     inside the block takes the place of the TPU's sequential grid axis.
//   * Q, K, V and score tiles sit in shared memory as f32 (rows padded by one
//     word so column walks hit distinct banks); each of the 256 threads keeps
//     a 4-row slice of the f32 output accumulator in registers.
//   * K tiles that causality or the window mask entirely are never loaded.
//   * The products run on the CUDA cores in f32 FMAs: correct for f32 and
//     bf16 inputs alike, and far from the tensor-core peak (see PERF.md).
#include "common.cuh"

namespace repro {
namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kThreads = 256;  // 16 x 16 threads

__device__ __forceinline__ bool keep(int qpos, int kpos, int Sk, int causal,
                                     int window) {
  if (kpos >= Sk) return false;
  if (!causal) return true;
  if (kpos > qpos) return false;
  return window <= 0 || kpos > qpos - window;
}

template <int D, int BK>
constexpr int smem_floats() {
  return kBQ * (D + 1) + 2 * BK * (D + 1) + kBQ * (BK + 1) + 3 * kBQ;
}

template <typename T, int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, int causal, int window, float softcap,
                 float scale) {
  constexpr int LD = D + 1, LDS = BK + 1;
  constexpr int RI = kBQ / 16;   // rows per thread: ty + 16 i
  constexpr int CJ = BK / 16;    // score columns per thread: tx + 16 j
  constexpr int DJ = D / 16;     // output dims per thread: tx + 16 j
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;
  float* sM = sS + kBQ * LDS;
  float* sL = sM + kBQ;
  float* sA = sL + kBQ;

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, qpos = q0 + r;
    sQ[r * LD + d] = qpos < Sq ? to_float(q[(((size_t)b * Sq + qpos) * H + h) * D + d]) : 0.f;
  }
  if (tid < kBQ) { sM[tid] = kNegInf; sL[tid] = 0.f; }

  float acc[RI][DJ];
#pragma unroll
  for (int i = 0; i < RI; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // k tiles that hold at least one kept key for some row of this q tile
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int t_end = (k_end + BK - 1) / BK;

  for (int t = k_begin / BK; t < t_end; ++t) {
    const int k0 = t * BK;
    __syncthreads();   // the previous tile's readers are done (and sQ is in)
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D, d = e % D, kpos = k0 + r;
      const bool in = kpos < Sk;
      const size_t g = (((size_t)b * Sk + kpos) * KV + kvh) * D + d;
      sK[r * LD + d] = in ? to_float(k[g]) : 0.f;
      sV[r * LD + d] = in ? to_float(v[g]) : 0.f;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[RI], c[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) a[i] = sQ[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) c[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        sS[r * LDS + c] = keep(q0 + r, k0 + c, Sk, causal, window) ? x : kNegInf;
      }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes share a row
      const int r = tid >> 2, pp = tid & 3, qpos = q0 + r;
      float mx = kNegInf;
      for (int c = pp; c < BK; c += 4) mx = fmaxf(mx, sS[r * LDS + c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int c = pp; c < BK; c += 4) {
        const float p = keep(qpos, k0 + c, Sk, causal, window)
                            ? expf(sS[r * LDS + c] - m_new) : 0.f;
        sS[r * LDS + c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (pp == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sA[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const float alpha = sA[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[RI], vv[DJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) p[i] = sS[(ty + 16 * i) * LDS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i, qpos = q0 + r;
    if (qpos >= Sq) continue;
    const float l = sL[r];
    T* dst = o + (((size_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      dst[tx + 16 * j] = from_float<T>(l == 0.f ? 0.f : acc[i][j] / l);
  }
}

template <typename T, int D, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int H, int KV, int causal, int window,
                   float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D, BK>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, D, BK><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, H, KV, causal, window, softcap,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KV, int causal, int window,
                     float softcap, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, softcap, stream);
    case 64:
      return launch<T, 64, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, softcap, stream);
    case 128:
      return launch<T, 128, 64>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, softcap, stream);
    case 256:
      return launch<T, 256, 32>(q, k, v, o, B, Sq, Sk, H, KV, causal, window, softcap, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// C entry point. dtype: 0 = f32, 1 = bf16 (q, k, v and out share it).
// causal is 0 or 1; window <= 0 means no window; softcap <= 0 means none.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* out, int B, int Sq, int Sk, int H,
                                     int KV, int D, int dtype, int causal,
                                     int window, float softcap, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = dtype == 0
      ? dispatch<float>(D, q, k, v, out, B, Sq, Sk, H, KV, causal, window, softcap, st)
      : dispatch<__nv_bfloat16>(D, q, k, v, out, B, Sq, Sk, H, KV, causal, window,
                                softcap, st);
  return static_cast<int>(err);
}
