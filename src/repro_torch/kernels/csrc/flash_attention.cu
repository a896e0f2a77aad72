// Flash attention forward for Hopper (sm_90a): blockwise online softmax.
//
// Replaces: src/repro/kernels/flash_attention.py, `_kernel` / `flash_attention`
// (the Pallas TPU kernel, grid (B, H, S/bq, S/bk) with the k axis sequential,
// reached from the model through `_pallas_attn` in src/repro/models/layers.py).
// The backward is flash_attention_bwd.cu: it reads the row log-sum-exp this
// kernel writes when its `lse` pointer is non-null.
//
// Function: q [B,Sq,H,D], k/v [B,Sk,KV,D] f32 -> out [B,Sq,H,D] f32.
//   q head h reads kv head h / (H/KV): the GQA repeat of the JAX caller is
//   never materialised. Scores (q.k)/sqrt(D) in f32, optional tanh softcap,
//   causal mask kpos <= qpos with an optional window kpos > qpos - window
//   (only when causal, as on the TPU). Masked scores are -1e30, running max,
//   sum and accumulator are f32, and a row whose sum is 0 outputs 0. Any Sq and
//   Sk: the ragged last tile is masked here (the TPU kernel asserted S % block).
//   Optional lse [B,H,Sq] f32: m + log(l) per row (+inf for a row with no kept
//   key), written only when the pointer is non-null; `o` is the same either way.
//
// What bounds it on the card: operations. At S = 2048 and D = 128 a (b, h)
// pair does ~4*S*S*D/2 causal flops on 4*S*D*4 bytes, hundreds of flops per
// byte, above the H100's ridge. The floor is the causal flops over the f32
// peak off the tensor cores (67 TFLOP/s).
//
// f32 at D = 256 only (ops.flash_variant): bf16 goes to the tensor-core
// kernel of flash_attention_tc.cu, f32 at D <= 128 to the split-f32
// tensor-core kernel of flash_attention_f32tc.cu, which meets the f32
// tolerance with three TF32 products per product (it has no D = 256 tiles).
//
// What the design does about it (simple first):
//   * One block per (q tile of 64 rows, head, batch); the loop over k tiles
//     inside the block takes the place of the TPU's sequential grid axis.
//   * Q, K, V and score tiles sit in shared memory as f32 (rows padded by one
//     word so column walks hit distinct banks); each of the 256 threads keeps
//     a 4-row slice of the f32 output accumulator in registers.
//   * K tiles that causality or the window mask entirely are never loaded.
//   * The products run on the CUDA cores in f32 FMAs (PERF.md has its time
//     against that peak).
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

template <int D, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                 int causal, int window, float softcap, float scale) {
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
    sQ[r * LD + d] = qpos < Sq ? q[(((size_t)b * Sq + qpos) * H + h) * D + d] : 0.f;
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
      sK[r * LD + d] = in ? k[g] : 0.f;
      sV[r * LD + d] = in ? v[g] : 0.f;
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
    float* dst = o + (((size_t)b * Sq + qpos) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dst[tx + 16 * j] = l == 0.f ? 0.f : acc[i][j] / l;
  }
  if (lse != nullptr && tid < kBQ && q0 + tid < Sq) {
    const float l = sL[tid];
    lse[((size_t)b * H + h) * Sq + q0 + tid] = l == 0.f ? INFINITY : sM[tid] + logf(l);
  }
}

template <int D, int BK>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
                   int window, float softcap, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D, BK>() * static_cast<int>(sizeof(float));
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t attr = set_smem_once(smem_set, flash_fwd_kernel<D, BK>, bytes);
  if (attr != cudaSuccess) return attr;
  dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<D, BK><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, lse, Sq, Sk, H, KV, causal, window, softcap,
      1.0f / sqrtf(static_cast<float>(D)));
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro

// C entry point, f32 only (q, k, v, out and lse), D = 256 only (ops.flash_variant
// sends D <= 128 to flash_attention_f32tc.cu). causal is 0 or 1; window <= 0
// means no window; softcap <= 0 means none; lse may be null. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int repro_flash_attention(const float* q, const float* k, const float* v,
                                     float* out, float* lse, int B, int Sq, int Sk, int H,
                                     int KV, int D, int causal, int window,
                                     float softcap, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 256: err = launch<256, 32>(q, k, v, out, lse, B, Sq, Sk, H, KV, causal, window, softcap, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
