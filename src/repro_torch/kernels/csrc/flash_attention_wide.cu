// Flash attention at head dims above 1024 (ops.flash_variant "cuda_core"),
// f32 and bf16: the forward and its deterministic backward, on CUDA cores
// in f32. Head dims 257 to 1024 run on the tensor cores instead, in
// flash_attention_f32tc_cluster.cu (a tile's head dim over a cluster of up
// to 8 ranks of at most 128 columns); these kernels take any head dim and
// serve the widths past a cluster's reach. No model of the repository has
// such a head dim; chip_smoke.py holds them to their plain versions and
// times them beside the cluster route at head dim 512 (the same-call
// parent: they carried the route above 256 before it).
//
// Replaces: src/repro/kernels/flash_attention.py, `_kernel` / `flash_attention`
// (the Pallas TPU kernel, grid (B, H, S/bq, S/bk) with the k axis
// sequential, which blocks over any head dim) for head dims above 1024.
// The Pallas kernel has no backward (JAX differentiates XLA attention);
// the backward here is that of this forward.
//
// Function: as ref.flash_attention_ref / ref.flash_attention_backward_ref.
//   q [B,Sq,H,D], k/v [B,Sk,KV,D] (f32, or bf16 loaded as bf16 and turned
//   into f32 in shared memory: every product and sum is f32 in both dtypes,
//   on the CUDA cores, and the outputs are rounded to the operands' dtype
//   once); q head h reads kv head h / (H/KV). D is a multiple of 64 (the
//   wrapper pads any other head dim Dt with zero columns, which add nothing
//   to a score; the scale is 1 / sqrt(Dt)). Scores (q.k)/sqrt(Dt), optional
//   tanh softcap, causal mask with optional window; a row whose sum is 0
//   outputs 0 (lse +inf); lse [B,H,Sq] = m + log(l) is written when asked
//   and `o` is the same bits either way. The backward takes q, k, v, o,
//   lse, dO and gives dq, dk, dv (dk, dv summed over the group's q heads).
//
// What bounds it on the card: operations. At [2,2048,4,512] kv 2 causal (its
// timing shape, the cluster route's main one) the forward's two products
// of the kept pairs are 34.4 GFLOP, 0.51 ms at the 67 TFLOP/s of f32 off
// the tensor cores; the backward's five 85.9 GFLOP, 1.28 ms. The design
// below does more than that (the scores once per column slice), and a
// simple CUDA-core tile does not reach the peak.
//
// Design. A block of the split-f32 or bf16 pair holds its 64 rows' operands
// and accumulators over the whole head dim; at D = 512 that is 128 KB of f32
// a 64-row operand and 128 registers a thread for one accumulator, and the
// head dim has no upper limit here. So the output's columns are cut into
// slices of kW = 128 (the last one 64 wide where D is an odd multiple of
// 64), one block per (64 rows, head, slice):
//   * Each block computes the scores over the whole D, in 64-column chunks
//     of both sides staged through shared memory (64 x 64 f32 each), and
//     keeps the online softmax in f32 registers; it accumulates only its own
//     slice of the output (64 x 128 f32: 32 registers a thread). The shared
//     memory stays at 87 KB (forward) or 122 KB (backward) at any D.
//   * Every slice computes the same scores, m and l, in the same order and
//     to the bit (the same instructions on the same data), so the slices of
//     a row agree exactly; slice 0 writes lse.
//   * The cost is the scores, recomputed once per slice: per kept pair and
//     head the forward does (2 n + 2) D flops for n = ceil(D / 128) slices,
//     not 4 D (10 D at D = 512, 2.5x); the backward (8 n + 6) D, not 10 D
//     (38 D at D = 512, 3.8x). ops._meta_call reports that work.
//   * 256 threads a block as a 16 x 16 grid: thread (ty, tx) holds rows
//     ty + 16 i and columns (keys or queries) tx + 16 j (i, j < 4) of a
//     64 x 64 score tile, and rows ty + 16 i, columns 4 tx + e and
//     64 + 4 tx + e of a 64 x 128 slice. Chunks are read as float4 along
//     the head dim at a row stride of 68 floats (conflict-free for the 8
//     threads of a quarter warp); the 16 threads of a row are lanes of one
//     warp, so a row's max and sum are shuffles.
//   * Backward, deterministic, no atomics: dk/dv runs a block per (64 keys,
//     kv head, slice) that loops over the group's q heads and their q tiles
//     in a fixed order (S and dP over the whole D, P from lse, delta =
//     rowsum(dO o) of each q tile computed in the block, dS; then dV_slice +=
//     P^T dO_slice and dK_slice += dS^T Q_slice); dq a block per (64
//     queries, head, slice) (dQ_slice += dS K_slice). Each output element is
//     summed by one thread in one order: the same bits on every call, as
//     the trainer's resume check (==) needs.
//   * Causal order: the q tile is the slowest grid axis, reversed in the
//     forward and dq grids (the heaviest tiles start first); in dk/dv the
//     k tile runs in order (k tile 0 sees every query). Tiles that
//     causality or the window rule out are never visited.
// The cluster route does both for head dims up to 1024 (wgmma, and the
// scores shared between the ranks of a cluster); above that a cluster
// would need more than 8 ranks of 128 columns (the non-portable size 16)
// or ranks of more columns than a block's registers and shared memory hold.
#include "common.cuh"

namespace repro {
namespace {

constexpr int kT = 64;          // rows of a tile (queries or keys)
constexpr int kDC = 64;         // head-dim columns of a score chunk
constexpr int kW = 128;         // output columns of a slice
constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kLd = 68;         // row stride (floats) of a chunk in shared memory
constexpr int kLdP = 80;        // row stride of a P / dS tile
constexpr int kChunkF = kT * kLd;
constexpr int kPF = kT * kLdP;
constexpr int kSliceF = kT * kW;
// forward: Q and K chunks, P, a V slice
constexpr int kFwdSmem = (2 * kChunkF + kPF + kSliceF) * 4;
// backward: four chunks (S and dP together), P or dS, one slice tile, delta
constexpr int kBwdSmem = (4 * kChunkF + kPF + kSliceF + kT) * 4;

// dst[r][c] = src[r * stride + c] as f32 for r < 64, c < COLS; zeros where
// r >= rows or c >= cols (cols a multiple of 4). src is 8-byte aligned (bf16)
// or 16-byte aligned (f32) at every row and every fourth column.
template <typename T, int COLS>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          size_t stride, int rows, int cols) {
  constexpr int V = COLS / 4;
#pragma unroll 4
  for (int idx = threadIdx.x; idx < kT * V; idx += kThreads) {
    const int r = idx / V, c = (idx % V) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (r < rows && c < cols) load_row<T, 4>(src + r * stride + c, x);
    *reinterpret_cast<float4*>(dst + r * ld + c) = make_float4(x[0], x[1], x[2], x[3]);
  }
}

__device__ __forceinline__ void store4(float* p, const float (&x)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&x)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// s[i][j] += sum_d R[ty + 16 i][d] C[tx + 16 j][d] over one chunk in shared
// memory, d in order (one fmaf each): the same bits whichever side is R.
__device__ __forceinline__ void chunk_product(float (&s)[4][4], const float* R, const float* C,
                                              int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < kDC; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(R + (ty + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(C + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j];
        x = fmaf(a[i].x, b[j].x, x);
        x = fmaf(a[i].y, b[j].y, x);
        x = fmaf(a[i].z, b[j].z, x);
        x = fmaf(a[i].w, b[j].w, x);
        s[i][j] = x;
      }
  }
}

// One or two 64 x 64 products over the whole head dim D (a multiple of 64),
// in chunks of 64 columns: s0 = R0 C0^T and, with TWO, s1 = R1 C1^T. Each
// operand is a 64-row tile at row stride `*stride`, rows past `*rows` zero.
// bufs: 2 or 4 chunk buffers. Starts and ends with a block barrier.
template <typename T, bool TWO>
__device__ __forceinline__ void score_tiles(float (&s0)[4][4], float (&s1)[4][4], float* bufs,
                                            const T* r0, size_t rs0, int rr0, const T* c0,
                                            size_t cs0, int cr0, const T* r1, size_t rs1,
                                            int rr1, const T* c1, size_t cs1, int cr1, int D,
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { s0[i][j] = 0.f; s1[i][j] = 0.f; }
  for (int c = 0; c < D; c += kDC) {
    __syncthreads();   // the previous chunk (or tile) is consumed
    load_tile<T, kDC>(bufs, kLd, r0 + c, rs0, rr0, kDC);
    load_tile<T, kDC>(bufs + kChunkF, kLd, c0 + c, cs0, cr0, kDC);
    if (TWO) {
      load_tile<T, kDC>(bufs + 2 * kChunkF, kLd, r1 + c, rs1, rr1, kDC);
      load_tile<T, kDC>(bufs + 3 * kChunkF, kLd, c1 + c, cs1, cr1, kDC);
    }
    __syncthreads();
    chunk_product(s0, bufs, bufs + kChunkF, ty, tx);
    if (TWO) chunk_product(s1, bufs + 2 * kChunkF, bufs + 3 * kChunkF, ty, tx);
  }
}

// acc[i][e] += sum_r P[ty + 16 i][r] X[r][col_e] over the 64 rows r of a
// slice tile X [64][kW] (columns 4 tx + e and 64 + 4 tx + e), r in order.
__device__ __forceinline__ void slice_product(float (&acc)[4][8], const float* P, const float* X,
                                              int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kT; ++r) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kLdP + r];
    const float4 x0 = *reinterpret_cast<const float4*>(X + r * kW + 4 * tx);
    const float4 x1 = *reinterpret_cast<const float4*>(X + r * kW + 64 + 4 * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(p[i], x0.x, acc[i][0]);
      acc[i][1] = fmaf(p[i], x0.y, acc[i][1]);
      acc[i][2] = fmaf(p[i], x0.z, acc[i][2]);
      acc[i][3] = fmaf(p[i], x0.w, acc[i][3]);
      acc[i][4] = fmaf(p[i], x1.x, acc[i][4]);
      acc[i][5] = fmaf(p[i], x1.y, acc[i][5]);
      acc[i][6] = fmaf(p[i], x1.z, acc[i][6]);
      acc[i][7] = fmaf(p[i], x1.w, acc[i][7]);
    }
  }
}

// Write a thread's slice accumulators: rows ty + 16 i (row r0 + ... < rows)
// of dst (row stride `stride`, slice columns from dst), times f[i], in T.
template <typename T>
__device__ __forceinline__ void store_slice(T* dst, size_t stride, int rows, int width,
                                            const float (&acc)[4][8], const float (&f)[4],
                                            int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = 64 * half + 4 * tx;
      if (c >= width) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] = acc[i][4 * half + e] * f[i];
      store4(dst + r * stride + c, x);
    }
  }
}

// delta[r] = sum_d dO[r][d] o[r][d] for the 64 rows of a q tile (rows past
// `rows` 0): four threads a row, each over every fourth group of 4 columns,
// then two shuffles. The same bits in the dk/dv and the dq kernel.
template <typename T>
__device__ __forceinline__ void row_delta(float* delta, const T* __restrict__ o,
                                          const T* __restrict__ dout, size_t stride, int rows,
                                          int D) {
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  float acc = 0.f;
  if (r < rows) {
    const T* po = o + r * stride;
    const T* pd = dout + r * stride;
    for (int d = 4 * part; d < D; d += 16) {
      float a[4], b[4];
      load_row<T, 4>(po + d, a);
      load_row<T, 4>(pd + d, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc = fmaf(a[e], b[e], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) delta[r] = acc;
}

// The score transform of the forward: scale, softcap, mask (-inf).
template <bool kCap>
__device__ __forceinline__ float score(float raw, bool keep, float scale, float softcap) {
  float x = raw * scale;
  if constexpr (kCap) x = softcap * tanhf(x / softcap);
  return keep ? x : -INFINITY;
}

// The keys [lo, hi) a q tile [q0, q0 + 64) may keep.
__device__ __forceinline__ void key_range(int q0, int Sk, int causal, int window, int& lo,
                                          int& hi) {
  lo = 0;
  hi = Sk;
  if (causal) {
    hi = min(Sk, q0 + kT);
    if (window > 0) lo = max(0, q0 - window + 1);
  }
}

template <typename T, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_wide_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                      T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, int H,
                      int KV, int D, int n_slices, int causal, int window, float softcap,
                      float scale) {
  extern __shared__ __align__(16) float smem[];
  float* bufs = smem;                    // Q and K chunks
  float* P = smem + 2 * kChunkF;
  float* Vs = P + kPF;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y / n_slices, slice = blockIdx.y % n_slices;
  const int b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * kT, c0 = slice * kW, width = min(kW, D - c0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(KV) * D;
  const T* qb = q + (static_cast<size_t>(b) * Sq + q0) * qs + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Sk * ks + static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * Sk * ks + static_cast<size_t>(kvh) * D + c0;

  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }
  int lo, hi;
  key_range(q0, Sk, causal, window, lo, hi);
  for (int k0 = lo / kT * kT; k0 < hi; k0 += kT) {
    float s[4][4], unused[4][4];
    score_tiles<T, false>(s, unused, bufs, qb, qs, Sq - q0, kb + k0 * ks, ks, Sk - k0, qb, qs,
                          0, qb, qs, 0, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score<kCap>(s[i][j], kept(qpos, k0 + tx + 16 * j, Sq, Sk, causal, window),
                              scale, softcap);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      // a row with no kept key so far keeps m = -inf, l = 0 and acc = 0
      const float alpha = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] == -INFINITY ? 0.f : expf(s[i][j] - m_new);
        P[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    load_tile<T, kW>(Vs, kW, vb + k0 * ks, ks, Sk - k0, width);
    __syncthreads();
    slice_product(acc, P, Vs, ty, tx);
  }
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  store_slice(out + (static_cast<size_t>(b) * Sq + q0) * qs + static_cast<size_t>(h) * D + c0,
              qs, Sq - q0, width, acc, f, ty, tx);
  if (lse != nullptr && slice == 0 && tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i;
      if (r < Sq)
        lse[(static_cast<size_t>(b) * H + h) * Sq + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
    }
  }
}

// dk, dv of 64 keys of one kv head, one slice of their columns.
template <typename T, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_wide_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                       const T* __restrict__ o, const T* __restrict__ dout,
                       const float* __restrict__ lse, T* __restrict__ dk, T* __restrict__ dv,
                       int Sq, int Sk, int H, int KV, int D, int n_slices, int causal,
                       int window, float softcap, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* bufs = smem;
  float* P = smem + 4 * kChunkF;
  float* X = P + kPF;
  float* delta = X + kSliceF;
  const int k0 = blockIdx.x * kT;
  const int kvh = blockIdx.y / n_slices, slice = blockIdx.y % n_slices;
  const int b = blockIdx.z, G = H / KV;
  const int c0 = slice * kW, width = min(kW, D - c0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(KV) * D;
  const T* kb = k + (static_cast<size_t>(b) * Sk + k0) * ks + static_cast<size_t>(kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * Sk + k0) * ks + static_cast<size_t>(kvh) * D;
  // the queries that may keep a key of this tile: q >= k0 (causal) and
  // q <= k0 + 63 + window - 1 (window)
  int qlo = 0, qhi = Sq;
  if (causal) {
    qlo = k0;
    if (window > 0) qhi = min(Sq, k0 + kT - 1 + window);
  }
  float adk[4][8], adv[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) { adk[i][e] = 0.f; adv[i][e] = 0.f; }
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int q0 = qlo / kT * kT; q0 < qhi; q0 += kT) {
      const size_t row0 = (static_cast<size_t>(b) * Sq + q0) * qs + static_cast<size_t>(h) * D;
      row_delta(delta, o + row0, dout + row0, qs, Sq - q0, D);
      float st[4][4], dpt[4][4];
      // S^T = K Q^T and dP^T = V dO^T over the whole head dim
      score_tiles<T, true>(st, dpt, bufs, kb, ks, Sk - k0, q + row0, qs, Sq - q0, vb, ks,
                           Sk - k0, dout + row0, qs, Sq - q0, D, ty, tx);
      float lq[4], dl[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qpos = q0 + tx + 16 * j;
        lq[j] = qpos < Sq ? lse[(static_cast<size_t>(b) * H + h) * Sq + qpos] : 0.f;
        dl[j] = delta[tx + 16 * j];
      }
      float ds[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool keep = kept(q0 + tx + 16 * j, k0 + ty + 16 * i, Sq, Sk, causal, window);
          float p;
          grad_element<kCap>(st[i][j], dpt[i][j], lq[j], dl[j], keep, scale, softcap, p,
                             ds[i][j]);
          P[(ty + 16 * i) * kLdP + tx + 16 * j] = p;
        }
      // dV_slice += P^T dO_slice
      load_tile<T, kW>(X, kW, dout + row0 + c0, qs, Sq - q0, width);
      __syncthreads();
      slice_product(adv, P, X, ty, tx);
      __syncthreads();
      // dK_slice += dS^T Q_slice
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) P[(ty + 16 * i) * kLdP + tx + 16 * j] = ds[i][j];
      load_tile<T, kW>(X, kW, q + row0 + c0, qs, Sq - q0, width);
      __syncthreads();
      slice_product(adk, P, X, ty, tx);
      __syncthreads();   // P, X and delta are free for the next q tile
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const size_t out0 = (static_cast<size_t>(b) * Sk + k0) * ks + static_cast<size_t>(kvh) * D + c0;
  store_slice(dk + out0, ks, Sk - k0, width, adk, one, ty, tx);
  store_slice(dv + out0, ks, Sk - k0, width, adv, one, ty, tx);
}

// dq of 64 queries of one head, one slice of their columns.
template <typename T, bool kCap>
__global__ void __launch_bounds__(kThreads)
flash_wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ o, const T* __restrict__ dout,
                     const float* __restrict__ lse, T* __restrict__ dq, int Sq, int Sk, int H,
                     int KV, int D, int n_slices, int causal, int window, float softcap,
                     float scale) {
  extern __shared__ __align__(16) float smem[];
  float* bufs = smem;
  float* P = smem + 4 * kChunkF;
  float* X = P + kPF;
  float* delta = X + kSliceF;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y / n_slices, slice = blockIdx.y % n_slices;
  const int b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * kT, c0 = slice * kW, width = min(kW, D - c0);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qs = static_cast<size_t>(H) * D, ks = static_cast<size_t>(KV) * D;
  const size_t row0 = (static_cast<size_t>(b) * Sq + q0) * qs + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Sk * ks + static_cast<size_t>(kvh) * D;
  const T* vb = v + static_cast<size_t>(b) * Sk * ks + static_cast<size_t>(kvh) * D;
  row_delta(delta, o + row0, dout + row0, qs, Sq - q0, D);
  __syncthreads();
  float lq[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    lq[i] = qpos < Sq ? lse[(static_cast<size_t>(b) * H + h) * Sq + qpos] : 0.f;
    dl[i] = delta[ty + 16 * i];
  }
  float adq[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) adq[i][e] = 0.f;
  int lo, hi;
  key_range(q0, Sk, causal, window, lo, hi);
  for (int k0 = lo / kT * kT; k0 < hi; k0 += kT) {
    float s[4][4], dp[4][4];
    // S = Q K^T and dP = dO V^T over the whole head dim
    score_tiles<T, true>(s, dp, bufs, q + row0, qs, Sq - q0, kb + k0 * ks, ks, Sk - k0,
                         dout + row0, qs, Sq - q0, vb + k0 * ks, ks, Sk - k0, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool keep = kept(q0 + ty + 16 * i, k0 + tx + 16 * j, Sq, Sk, causal, window);
        float p, ds;
        grad_element<kCap>(s[i][j], dp[i][j], lq[i], dl[i], keep, scale, softcap, p, ds);
        P[(ty + 16 * i) * kLdP + tx + 16 * j] = ds;
      }
    load_tile<T, kW>(X, kW, kb + k0 * ks + c0, ks, Sk - k0, width);
    __syncthreads();
    slice_product(adq, P, X, ty, tx);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_slice(dq + row0 + c0, qs, Sq - q0, width, adq, one, ty, tx);
}

template <typename T, bool kCap>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out, float* lse, int B,
                int Sq, int Sk, int H, int KV, int D, int causal, int window, float softcap,
                float scale, cudaStream_t st) {
  auto* kernel = flash_wide_fwd_kernel<T, kCap>;
  static std::atomic<uint64_t> smem_set{0};
  cudaError_t err = set_smem_once(smem_set, kernel, kFwdSmem);
  if (err != cudaSuccess) return err;
  const int n_slices = (D + kW - 1) / kW;
  const dim3 grid((Sq + kT - 1) / kT, H * n_slices, B);
  kernel<<<grid, kThreads, kFwdSmem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), lse, Sq, Sk, H, KV, D, n_slices, causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T, bool kCap>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* o, const void* dout,
                const float* lse, void* dq, void* dk, void* dv, int B, int Sq, int Sk, int H,
                int KV, int D, int causal, int window, float softcap, float scale,
                cudaStream_t st) {
  auto* dkdv = flash_wide_dkdv_kernel<T, kCap>;
  auto* dqk = flash_wide_dq_kernel<T, kCap>;
  static std::atomic<uint64_t> dkdv_set{0}, dq_set{0};
  cudaError_t err = set_smem_once(dkdv_set, dkdv, kBwdSmem);
  if (err == cudaSuccess) err = set_smem_once(dq_set, dqk, kBwdSmem);
  if (err != cudaSuccess) return err;
  const int n_slices = (D + kW - 1) / kW;
  const T* Q = static_cast<const T*>(q);
  const T* K = static_cast<const T*>(k);
  const T* V = static_cast<const T*>(v);
  const T* O = static_cast<const T*>(o);
  const T* dO = static_cast<const T*>(dout);
  dkdv<<<dim3((Sk + kT - 1) / kT, KV * n_slices, B), kThreads, kBwdSmem, st>>>(
      Q, K, V, O, dO, lse, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KV, D, n_slices,
      causal, window, softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dqk<<<dim3((Sq + kT - 1) / kT, H * n_slices, B), kThreads, kBwdSmem, st>>>(
      Q, K, V, O, dO, lse, static_cast<T*>(dq), Sq, Sk, H, KV, D, n_slices, causal, window,
      softcap, scale);
  return cudaGetLastError();
}

bool bad_shape(int B, int Sq, int Sk, int H, int KV, int Dt, int D, int dtype) {
  return B <= 0 || B > 65535 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || D % kDC != 0 ||
         Dt <= 0 || Dt > D || (dtype != 0 && dtype != 1) ||
         static_cast<long long>(H) * ((D + kW - 1) / kW) > 65535;
}

}  // namespace
}  // namespace repro

// C entry points. dtype: 0 = f32, 1 = bf16 (every tensor but lse, f32).
// Dt <= D: the head dim the scores are scaled by (1 / sqrt(Dt)), the
// columns from Dt on being zeros the wrapper padded them with; D a multiple
// of 64. lse: [B,H,Sq] f32 or null (not written). window <= 0 means no
// window; softcap <= 0 means no softcap. Return the launch's error (0 on
// success).
extern "C" int repro_flash_attention_wide(const void* q, const void* k, const void* v, void* out,
                                          void* lse, int B, int Sq, int Sk, int H, int KV, int Dt,
                                          int D, int dtype, int causal, int window,
                                          float softcap, void* stream) {
  using namespace repro;
  if (bad_shape(B, Sq, Sk, H, KV, Dt, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(Dt));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ls = static_cast<float*>(lse);
  const bool cap = softcap > 0.f;
#define REPRO_WIDE_FWD(TT, CAP) \
  fwd<TT, CAP>(q, k, v, out, ls, B, Sq, Sk, H, KV, D, causal, window, softcap, scale, st)
  const cudaError_t err =
      dtype == 0 ? (cap ? REPRO_WIDE_FWD(float, true) : REPRO_WIDE_FWD(float, false))
                 : (cap ? REPRO_WIDE_FWD(__nv_bfloat16, true) : REPRO_WIDE_FWD(__nv_bfloat16, false));
#undef REPRO_WIDE_FWD
  return static_cast<int>(err);
}

// q, k, v, o, dout and the grads dq, dk, dv share the dtype; lse [B,H,Sq]
// f32 from the forward. Two launches (dk/dv, then dq), no scratch.
extern "C" int repro_flash_attention_wide_bwd(const void* q, const void* k, const void* v,
                                              const void* o, const void* dout, const void* lse,
                                              void* dq, void* dk, void* dv, int B, int Sq,
                                              int Sk, int H, int KV, int Dt, int D, int dtype,
                                              int causal, int window, float softcap,
                                              void* stream) {
  using namespace repro;
  if (bad_shape(B, Sq, Sk, H, KV, Dt, D, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const float scale = 1.0f / sqrtf(static_cast<float>(Dt));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ls = static_cast<const float*>(lse);
  const bool cap = softcap > 0.f;
#define REPRO_WIDE_BWD(TT, CAP)                                                                \
  bwd<TT, CAP>(q, k, v, o, dout, ls, dq, dk, dv, B, Sq, Sk, H, KV, D, causal, window, softcap, \
               scale, st)
  const cudaError_t err =
      dtype == 0 ? (cap ? REPRO_WIDE_BWD(float, true) : REPRO_WIDE_BWD(float, false))
                 : (cap ? REPRO_WIDE_BWD(__nv_bfloat16, true) : REPRO_WIDE_BWD(__nv_bfloat16, false));
#undef REPRO_WIDE_BWD
  return static_cast<int>(err);
}
