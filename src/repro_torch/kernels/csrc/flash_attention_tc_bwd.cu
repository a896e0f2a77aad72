// Flash attention backward on Hopper's tensor cores (sm_90a), for bf16: the
// backward of flash_attention_tc.cu's forward.
//
// Replaces: the gradient of src/repro/kernels/flash_attention.py's `_kernel` /
// `flash_attention` (the Pallas TPU kernel). The Pallas kernel has no
// backward (JAX differentiates XLA attention, src/repro/models/layers.py); this
// is the backward of the kernel that replaces it, on the bf16 train path.
//
// Function: as ref.flash_attention_backward_ref on bf16 operands. q, o, dO
//   [B,Sq,H,D], k, v [B,Sk,KV,D] bf16, lse [B,H,Sq] f32 (the forward's) ->
//   dq [B,Sq,H,D], dk, dv [B,Sk,KV,D] bf16; dk and dv sum the group's q
//   heads; delta [B,H,Sq] f32 = rowsum(dO * o) is scratch. Scores
//   (q.k)/sqrt(D), optional tanh softcap, causal mask with optional window;
//   P = exp(s - lse) on kept pairs, dS = P (dP - delta) (1 - tanh^2) / sqrt(D).
//   Products take bf16 operands and sum in f32: S and dP from the bf16
//   inputs, and P and dS rounded to bf16 before the products into dv, dk and
//   dq (tests/test_torch_kernels.py emulates these roundings on the CPU).
//   D in {32, 64, 128, 256}; any Sq and Sk; head groups up to 16.
//
// What bounds it on the card: operations. Five products of the kept pairs
// (S recomputed, dP, dv, dk, dq): at [2,2048,16,128] kv 8 causal 85.94 GFLOP,
// 86.9 us at the 989 TFLOP/s dense bf16 peak; at D = 256 twice that.
//
// Design (a simple first kernel; each part is the f32 pair's,
// flash_attention_f32tc.cu, without what TF32 forced on it):
//   * Three launches: delta (a warp a row), dk/dv (a block per (64 keys, kv
//     head, batch) that loops over the group's q heads and their q tiles in
//     a fixed order, so the GQA sum stays in the block), dq (a block per (64
//     queries, head, batch)). No atomics: each output element is summed by
//     one thread in one order, so two calls give the same bits.
//   * Every product is one bf16 wgmma a 16-deep step (m64n64k16 for S and dP,
//     m64nNk16 into the accumulators). Tiles are TMA copies of the bf16
//     inputs as stored, in the 128-byte swizzle (64-byte at D = 32): no
//     hi/lo split, no prep launch. The score products read both operands
//     K-major (contracting over D); the products into dv, dk and dq read the
//     same streamed tiles MN-major through the descriptor's transpose bit (a
//     16-bit type has one), so no transposed copy exists.
//   * P and dS leave the f32 accumulator fragment of S / dP as bf16 pairs
//     that are, register for register, the A fragment of the next product:
//     no shuffle and no permutation.
//   * The accumulators (dk, dv or dq, f32) stay in registers and take each
//     step's product in place, in step order.
//   * The block's fixed tiles (K and V, or Q and dO) load once; the streamed
//     ones (Q and dO, or K and V, 64 rows each) through a ring of two stages,
//     thread 0 refilling a stage as soon as every warp is done with it.
//   * D = 256: dk + dv of 64 x 256 f32 would be 256 registers a thread. A
//     block there runs two warpgroups; each computes the whole score tile (S
//     and dP over all 256 of D, from the same shared tiles, so both hold the
//     same bits) and sums its own 128 columns of the outputs. No exchange and
//     no barrier beyond the ring's; the cost is the two score products done
//     twice (7 products' work for 5). Splitting D across a cluster pair, as
//     the f32 pair does, would halve that work at the price of a
//     distributed-shared-memory exchange and a cluster barrier a step.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kR = 64;          // rows of every tile: a block's own, each step's streamed ones
constexpr int kStages = 2;      // ring of streamed tiles
constexpr int kDeltaThreads = 256;

template <int D>
struct Bwd {
  static constexpr int NW = D == 256 ? 2 : 1;   // warpgroups a block
  static constexpr int DH = D / NW;             // output columns a warpgroup sums
  static constexpr int THREADS = 128 * NW;
  static constexpr int SW = D >= 64 ? 128 : 64; // swizzle span (bytes of a row)
  static constexpr int E = SW / 2;              // bf16 columns per swizzled box
  static constexpr int NC = D / E;              // boxes across D
  static constexpr int TILE = kR * D * 2;       // one tile's bytes
  static constexpr int SMEM = 1024 + 2 * TILE + kStages * 2 * TILE + 64;
  static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
  static_assert(D % E == 0 && DH % E == 0, "a warpgroup's columns start at a box");
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

// Rows [row0, row0 + 64) of one head: NC boxes of E columns, box c at
// dst + c * 64 * SW, each row SW bytes in the swizzled layout.
template <int D>
__device__ __forceinline__ void load_tile(char* dst, const CUtensorMap* map, uint64_t* bar,
                                          int head, int row0, int b) {
  using T = Bwd<D>;
#pragma unroll
  for (int c = 0; c < T::NC; ++c)
    sm90::tma_load_4d(dst + c * kR * T::SW, map, bar, c * T::E, head, row0, b);
}

// Descriptors of a tile loaded by load_tile. K-major (contracting over D):
// 8-row groups 8 SW bytes apart. MN-major (contracting over the rows, N over
// D): boxes of E columns 64 SW bytes apart (leading), groups of 8 rows 8 SW
// bytes apart (stride). Offsets are added in 16-byte units.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(const char* t) {
  return sm90::smem_desc(t, 16, 8 * Bwd<D>::SW, Bwd<D>::SW);
}

template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(const char* t) {
  return sm90::smem_desc(t, kR * Bwd<D>::SW, 8 * Bwd<D>::SW, Bwd<D>::SW);
}

// K-major depth kk * 16: box c, byte `inner` into each swizzled row.
template <int D>
__device__ __forceinline__ uint64_t kmajor_step(int kk) {
  using T = Bwd<D>;
  return static_cast<uint64_t>(((kk * 16 / T::E) * kR * T::SW + (kk * 16 % T::E) * 2) >> 4);
}

// s[64 x 64] = X Y^T over D: X the block's own tile, Y a streamed one, both
// K-major. Part of the caller's commit group.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kR / 2], uint64_t x, uint64_t y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss<kR>(s, x + kmajor_step<D>(kk), y + kmajor_step<D>(kk), kk > 0);
}

// acc[64 x DH] += A [64 x 64] Y: A as bf16 fragments (four registers per
// 16 rows of Y), y the MN-major descriptor of Y at the warpgroup's first
// column. Part of the caller's commit group.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[Bwd<D>::DH / 2],
                                           const uint32_t (&a)[kR / 16][4], uint64_t y) {
#pragma unroll
  for (int kk = 0; kk < kR / 16; ++kk)
    sm90::wgmma_rs<Bwd<D>::DH>(acc, a[kk], y + ((kk * 16 * Bwd<D>::SW) >> 4), 1);
}

// P and dS of a [64 x 64] score tile held as the accumulator fragment (s:
// the scores, dp: dO . v), rounded to bf16 A fragments. Element 4 j + e is
// row row0 (e < 2) or row0 + 8, column col0 + 8 j + (e & 1). In the dq
// launch rows are queries (their lse and delta in rl, rd) and columns keys;
// in dk/dv rows are keys and columns queries, whose lse and delta are read
// from lse_row / delta_row (those of the step's q head).
template <bool kCap, bool kDQ>
__device__ __forceinline__ void p_and_ds(const float (&s)[kR / 2], const float (&dp)[kR / 2],
                                         int row0, int col0, const float* __restrict__ lse_row,
                                         const float* __restrict__ delta_row,
                                         const float (&rl)[2], const float (&rd)[2], int Sq,
                                         int Sk, int causal, int window, float scale,
                                         float softcap, uint32_t (&pf)[kR / 16][4],
                                         uint32_t (&dsf)[kR / 16][4]) {
#pragma unroll
  for (int j = 0; j < kR / 8; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row0 + (e < 2 ? 0 : 8), c = col0 + 8 * j + (e & 1);
      const int qpos = kDQ ? r : c, kpos = kDQ ? c : r;
      float l = 0.f, dl = 0.f;
      if constexpr (kDQ) {
        l = rl[e / 2];
        dl = rd[e / 2];
      } else if (c < Sq) {
        l = lse_row[c];
        dl = delta_row[c];
      }
      grad_element<kCap>(s[4 * j + e], dp[4 * j + e], l, dl,
                         kept(qpos, kpos, Sq, Sk, causal, window), scale, softcap, p[e], ds[e]);
    }
    pf[j / 2][(j % 2) * 2] = pack(p[0], p[1]);
    pf[j / 2][(j % 2) * 2 + 1] = pack(p[2], p[3]);
    dsf[j / 2][(j % 2) * 2] = pack(ds[0], ds[1]);
    dsf[j / 2][(j % 2) * 2 + 1] = pack(ds[2], ds[3]);
  }
}

// Rows row0 and row0 + 8 of a [64 x DH] f32 accumulator into out
// [B, S, heads, D] bf16 at head `head`, columns c0 .. c0 + DH.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[Bwd<D>::DH / 2],
                                           int b, int S, int heads, int head, int row0, int c0,
                                           int col) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + 8 * e;
    if (r >= S) continue;
    bf16* dst = out + ((static_cast<size_t>(b) * S + r) * heads + head) * D + c0 + col;
#pragma unroll
    for (int j = 0; j < Bwd<D>::DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * e], acc[4 * j + 2 * e + 1]);
  }
}

// delta[b, h, s] = sum_d dO * o over one row (b, s, h) a warp, in f32.
template <int D>
__global__ void __launch_bounds__(kDeltaThreads)
flash_bwd_tc_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                          float* __restrict__ delta, int rows, int Sq, int H) {
  const int r = blockIdx.x * (kDeltaThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (r >= rows) return;   // the whole warp
  const __nv_bfloat162* po = reinterpret_cast<const __nv_bfloat162*>(o + static_cast<size_t>(r) * D);
  const __nv_bfloat162* pd =
      reinterpret_cast<const __nv_bfloat162*>(dout + static_cast<size_t>(r) * D);
  float acc = 0.f;
  for (int i = lane; i < D / 2; i += 32) {
    const float2 a = __bfloat1622float2(po[i]), g = __bfloat1622float2(pd[i]);
    acc = fmaf(a.x, g.x, acc);
    acc = fmaf(a.y, g.y, acc);
  }
  acc = warp_sum(acc);
  if (lane == 0) {   // r = (b Sq + s) H + h
    const int h = r % H, s = (r / H) % Sq, b = r / H / Sq;
    delta[(static_cast<size_t>(b) * H + h) * Sq + s] = acc;
  }
}

#define REPRO_TC_BWD_MAPS                                                           \
  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,   \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo

// dk and dv of one (64 keys, kv head, batch) tile.
template <int D, bool kCap>
__global__ void __launch_bounds__(Bwd<D>::THREADS, 1)
flash_bwd_tc_dkdv_kernel(REPRO_TC_BWD_MAPS, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Sq, int Sk, int H, int KV, int causal,
                         int window, float softcap, float scale) {
  using T = Bwd<D>;
  extern __shared__ uint8_t smem_raw[];
  char* sK = sm90::align1024(smem_raw);
  char* sV = sK + T::TILE;
  char* sY = sV + T::TILE;   // stage s: Q at sY + 2 s TILE, dO after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(sY + kStages * 2 * T::TILE);   // K/V, stages

  const int kvh = blockIdx.x, b = blockIdx.y, x0 = blockIdx.z * kR;   // k tile 0 first
  const int group = H / KV;
  // q tiles that hold a query keeping some key of this block
  const int k_last = min(x0 + kR, Sk) - 1;
  const int q_begin = causal ? x0 : 0;
  const int q_end = (causal && window > 0) ? min(Sq, k_last + window) : Sq;
  const int t_begin = q_begin / kR;
  const int nq = max(0, (q_end + kR - 1) / kR - t_begin);
  const int n_steps = group * nq;   // the group's q heads in order, each over its q tiles
  const int tid = threadIdx.x;

  auto load_y = [&](int i) {
    const int head = kvh * group + i / nq, pos0 = (t_begin + i % nq) * kR;
    char* dst = sY + (i % kStages) * 2 * T::TILE;
    uint64_t* full = &bar[1 + i % kStages];
    sm90::mbar_arrive_expect_tx(full, 2 * T::TILE);
    load_tile<D>(dst, &tq, full, head, pos0, b);
    load_tile<D>(dst + T::TILE, &tdo, full, head, pos0, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_barrier_init();
    sm90::mbar_arrive_expect_tx(&bar[0], 2 * T::TILE);
    load_tile<D>(sK, &tk, &bar[0], kvh, x0, b);
    load_tile<D>(sV, &tv, &bar[0], kvh, x0, b);
    for (int i = 0; i < kStages && i < n_steps; ++i) load_y(i);
  }
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = x0 + warp * 16 + lane / 4;   // this thread's keys: row0, row0 + 8
  const int col = 2 * (lane % 4);               // its first column in each group of 8
  const int c0 = wg * T::DH;                    // the warpgroup's first output column
  const uint64_t k_desc = kmajor_desc<D>(sK), v_desc = kmajor_desc<D>(sV);
  // stage 0's Q, K-major and (at column c0) MN-major; its dO is TILE further
  const uint64_t y_k = kmajor_desc<D>(sY);
  const uint64_t y_mn = mnmajor_desc<D>(sY) + (((c0 / T::E) * kR * T::SW) >> 4);
  const float none[2] = {0.f, 0.f};

  float acc_k[T::DH / 2], acc_v[T::DH / 2];
#pragma unroll
  for (int i = 0; i < T::DH / 2; ++i) {
    acc_k[i] = 0.f;
    acc_v[i] = 0.f;
  }
  sm90::mbar_wait(&bar[0], 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages;
    const int head = kvh * group + i / nq, pos0 = (t_begin + i % nq) * kR;
    const uint64_t q_off = static_cast<uint64_t>((st * 2 * T::TILE) >> 4);
    const uint64_t do_off = q_off + (T::TILE >> 4);
    float s[kR / 2], dp[kR / 2];
    sm90::mbar_wait(&bar[1 + st], (i / kStages) & 1);
    sm90::wgmma_fence();
    scores<D>(s, k_desc, y_k + q_off);     // S^T = K Q^T
    scores<D>(dp, v_desc, y_k + do_off);   // dP^T = V dO^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    const size_t rows = (static_cast<size_t>(b) * H + head) * Sq;
    uint32_t pf[kR / 16][4], dsf[kR / 16][4];
    p_and_ds<kCap, false>(s, dp, row0, pos0 + col, lse + rows, delta + rows, none, none, Sq,
                          Sk, causal, window, scale, softcap, pf, dsf);
    sm90::wgmma_fence();
    accumulate<D>(acc_v, pf, y_mn + do_off);   // dV += P^T dO
    accumulate<D>(acc_k, dsf, y_mn + q_off);   // dK += dS^T Q
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc_v);
    sm90::fence_regs(acc_k);
    __syncthreads();   // every warp is done with this stage
    if (tid == 0 && i + kStages < n_steps) load_y(i + kStages);
  }
  store_rows<D>(dk, acc_k, b, Sk, KV, kvh, row0, c0, col);
  store_rows<D>(dv, acc_v, b, Sk, KV, kvh, row0, c0, col);
}

// dq of one (64 queries, head, batch) tile.
template <int D, bool kCap>
__global__ void __launch_bounds__(Bwd<D>::THREADS, 1)
flash_bwd_tc_dq_kernel(REPRO_TC_BWD_MAPS, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk,
                       int H, int KV, int causal, int window, float softcap, float scale) {
  using T = Bwd<D>;
  extern __shared__ uint8_t smem_raw[];
  char* sQ = sm90::align1024(smem_raw);
  char* sO = sQ + T::TILE;   // dO
  char* sY = sO + T::TILE;   // stage s: K at sY + 2 s TILE, V after it
  uint64_t* bar = reinterpret_cast<uint64_t*>(sY + kStages * 2 * T::TILE);   // Q/dO, stages

  const int h = blockIdx.x, b = blockIdx.y;
  const int x0 = (gridDim.z - 1 - blockIdx.z) * kR;   // heaviest q tile first
  const int kvh = h / (H / KV);
  // k tiles that hold a kept key for some row of this block
  const int q_last = min(x0 + kR, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, x0 - window + 1) : 0;
  const int t_begin = k_begin / kR;
  const int n_steps = max(0, (k_end + kR - 1) / kR - t_begin);
  const int tid = threadIdx.x;

  auto load_y = [&](int i) {
    const int pos0 = (t_begin + i) * kR;
    char* dst = sY + (i % kStages) * 2 * T::TILE;
    uint64_t* full = &bar[1 + i % kStages];
    sm90::mbar_arrive_expect_tx(full, 2 * T::TILE);
    load_tile<D>(dst, &tk, full, kvh, pos0, b);
    load_tile<D>(dst + T::TILE, &tv, full, kvh, pos0, b);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + kStages; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_barrier_init();
    sm90::mbar_arrive_expect_tx(&bar[0], 2 * T::TILE);
    load_tile<D>(sQ, &tq, &bar[0], h, x0, b);
    load_tile<D>(sO, &tdo, &bar[0], h, x0, b);
    for (int i = 0; i < kStages && i < n_steps; ++i) load_y(i);
  }
  __syncthreads();

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = x0 + warp * 16 + lane / 4;   // this thread's queries: row0, row0 + 8
  const int col = 2 * (lane % 4);
  const int c0 = wg * T::DH;
  const uint64_t q_desc = kmajor_desc<D>(sQ), o_desc = kmajor_desc<D>(sO);
  // stage 0's K, K-major and (at column c0) MN-major; its V is TILE further
  const uint64_t y_k = kmajor_desc<D>(sY);
  const uint64_t y_mn = mnmajor_desc<D>(sY) + (((c0 / T::E) * kR * T::SW) >> 4);
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};   // lse and delta of the two rows
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (row0 + 8 * e < Sq) {
      const size_t g = (static_cast<size_t>(b) * H + h) * Sq + row0 + 8 * e;
      rl[e] = lse[g];
      rd[e] = delta[g];
    }

  float acc[T::DH / 2];
#pragma unroll
  for (int i = 0; i < T::DH / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(&bar[0], 0);
  for (int i = 0; i < n_steps; ++i) {
    const int st = i % kStages, pos0 = (t_begin + i) * kR;
    const uint64_t k_off = static_cast<uint64_t>((st * 2 * T::TILE) >> 4);
    const uint64_t v_off = k_off + (T::TILE >> 4);
    float s[kR / 2], dp[kR / 2];
    sm90::mbar_wait(&bar[1 + st], (i / kStages) & 1);
    sm90::wgmma_fence();
    scores<D>(s, q_desc, y_k + k_off);    // S = Q K^T
    scores<D>(dp, o_desc, y_k + v_off);   // dP = dO V^T
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    uint32_t pf[kR / 16][4], dsf[kR / 16][4];
    p_and_ds<kCap, true>(s, dp, row0, pos0 + col, nullptr, nullptr, rl, rd, Sq, Sk, causal,
                         window, scale, softcap, pf, dsf);
    sm90::wgmma_fence();
    accumulate<D>(acc, dsf, y_mn + k_off);   // dQ += dS K
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    __syncthreads();   // every warp is done with this stage
    if (tid == 0 && i + kStages < n_steps) load_y(i + kStages);
  }
  store_rows<D>(dq, acc, b, Sq, H, h, row0, c0, col);
}
#undef REPRO_TC_BWD_MAPS

// ---- host side --------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, causal, window;
  float softcap;
};

template <int D, bool kCap>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  using T = Bwd<D>;
  cudaError_t err = sm90::bind_context();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90::bf16_rows_map(&tq, a.q, a.B, a.Sq, a.H, D, kR, T::SW) ||
      !sm90::bf16_rows_map(&tk, a.k, a.B, a.Sk, a.KV, D, kR, T::SW) ||
      !sm90::bf16_rows_map(&tv, a.v, a.B, a.Sk, a.KV, D, kR, T::SW) ||
      !sm90::bf16_rows_map(&tdo, a.dout, a.B, a.Sq, a.H, D, kR, T::SW))
    return cudaErrorInvalidValue;
  const int rows = a.B * a.Sq * a.H;
  flash_bwd_tc_delta_kernel<D><<<(rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32),
                                 kDeltaThreads, 0, st>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.delta, rows, a.Sq, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static std::atomic<uint64_t> dkdv_set{0}, dq_set{0};
  err = set_smem_once(dkdv_set, flash_bwd_tc_dkdv_kernel<D, kCap>, T::SMEM);
  if (err != cudaSuccess) return err;
  err = set_smem_once(dq_set, flash_bwd_tc_dq_kernel<D, kCap>, T::SMEM);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(D));
  flash_bwd_tc_dkdv_kernel<D, kCap><<<dim3(a.KV, a.B, (a.Sk + kR - 1) / kR), T::THREADS,
                                      T::SMEM, st>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.softcap, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_tc_dq_kernel<D, kCap><<<dim3(a.H, a.B, (a.Sq + kR - 1) / kR), T::THREADS, T::SMEM,
                                    st>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.KV,
      a.causal, a.window, a.softcap, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_cap(const BwdArgs& a, cudaStream_t st) {
  return a.softcap > 0.f ? launch_bwd<D, true>(a, st) : launch_bwd<D, false>(a, st);
}

}  // namespace
}  // namespace repro

// C entry point, bf16 q, k, v, out, dout, dq, dk, dv; f32 lse [B,H,Sq] (the
// forward's) and delta [B,H,Sq] (scratch). causal is 0 or 1; window <= 0
// means none; softcap <= 0 means none. Launches delta, dk/dv and dq on
// `stream` in order and returns the first error (cudaGetLastError() after
// each launch; cudaErrorInvalidValue for a shape it does not take or a
// tensor map cuTensorMapEncodeTiled refuses).
extern "C" int repro_flash_attention_tc_bwd(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const float* lse,
                                            float* delta, void* dq, void* dk, void* dv, int B,
                                            int Sq, int Sk, int H, int KV, int D, int causal,
                                            int window, float softcap, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535 ||
      (Sq + kR - 1) / kR > 65535 || (Sk + kR - 1) / kR > 65535 ||
      static_cast<long long>(B) * Sq * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, causal, window, softcap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_cap<32>(a, st); break;
    case 64: err = dispatch_cap<64>(a, st); break;
    case 128: err = dispatch_cap<128>(a, st); break;
    case 256: err = dispatch_cap<256>(a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
