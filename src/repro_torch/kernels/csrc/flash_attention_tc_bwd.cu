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
//   D in {32, 64, 128, 192, 256} (the wrapper pads any other head dim Dt up
//   to the next of those with zero columns; the scale is 1 / sqrt(Dt), a
//   kernel argument); any Sq and Sk; head groups up to 16.
//
// What bounds it on the card: operations. Five products of the kept pairs
// (S recomputed, dP, dv, dk, dq): at [2,2048,16,128] kv 8 causal 85.94 GFLOP,
// 86.9 us at the 989 TFLOP/s dense bf16 peak; at D = 256 twice that. With no
// atomics dq has a launch of its own, which computes S and dP again: seven
// products' work for the five of the bound. Between the products each score
// element takes an exp (and a tanh with a softcap) on the CUDA cores, which
// leave the tensor cores idle unless another warpgroup's products run then.
//
// Design:
//   * Three launches: delta (a warp a row), dk/dv (a block per (ROWS keys,
//     kv head, batch) that loops over the group's q heads and their q tiles
//     in a fixed order, so the GQA sum stays in the block), dq (a block per
//     (ROWS queries, head, batch), the heaviest causal tiles first). No
//     atomics: each output element is summed by one thread in one order, so
//     two calls give the same bits.
//   * A block is two consumer warpgroups and nothing else. ptxas holds every
//     thread of a block to the registers its size allows, 168 for nine to
//     twelve warps (a quarter of the register file serves a quarter of the
//     warps; setmaxnreg moves registers at run time, but the code was
//     allocated for 168 and spilled), 255 for eight. So one consumer thread
//     (kProducer) starts the TMA copies: the fixed operands (K and V, or Q
//     and dO) once, the streamed 64-row tiles (Q and dO, or K and V) through
//     a ring of NS stages, each with a full and an empty mbarrier
//     (sm90::Ring), refilled as soon as all eight warps have released a
//     stage, polled between the thread's own steps; no block-wide barrier.
//   * Row split (dk/dv below D = 128, dq below D = 192): ROWS = 128, each
//     warpgroup owns 64 of them and all their outputs, and both read every
//     streamed stage, so each tile feeds 128 rows of products. The two run
//     unsynchronised beyond the ring. A step none of whose pairs a
//     warpgroup keeps (the first q tile of the upper 64 keys under
//     causality, tiles past a window) is skipped by it; its barriers are
//     passed all the same.
//   * Product split (dk/dv from D = 128, dq from D = 192): ROWS = 64 and the
//     warpgroups split the work instead of duplicating it: warpgroup 0
//     computes S (all of D, one chain of products, as in the row split), P
//     and dV (dk/dv) or only S and P (dq); warpgroup 1 computes dP, dS and
//     dK (dk/dv) or dQ (dq). Warpgroup 0 hands g = P (1 - tanh^2) scale
//     over through a double buffer of 64 x 64 f32 in shared memory (an
//     xfull / xempty mbarrier pair each), and warpgroup 1 forms dS = g (dP -
//     delta). At D = 256 dk + dv of 64 x 256 f32 would be 256 registers a
//     thread; the split does five products' work where each warpgroup
//     computing the whole S and dP did seven. At D = 128 a row-split dk/dv
//     warpgroup (two 64 x 128 f32 accumulators, S, dP, P and dS: 224
//     registers) spilled past 255 (4-8 bytes, measured 0.400 ms for the
//     backward at internlm2's shape against 0.44 split, on an H100); the
//     split holds 170.
//   * A round of a warpgroup issues its output products of the last step
//     and the score products of this one back to back (except dq at D <=
//     64, which runs two blocks an SM in 128 registers and waits for its
//     output products first) and waits for them before the loop's back
//     edge: a wgmma in flight there let the compiler move accumulator
//     registers, and ptxas serialised every wgmma (C7515). Each
//     warpgroup's elementwise work thus runs under the other's products.
//     Forcing the two to take turns at issuing (as FA3's forward does)
//     measured no faster, so they do not.
//   * The elementwise work is lean: P = exp2(z - lse log2 e) on the fast
//     exp2, tanh from the fast exp2 and reciprocal (within about 1e-7),
//     masks as one range a row, tested only on tiles that cross a mask
//     edge; dk/dv's lse and delta of each step's queries come through
//     shared memory, loaded a step ahead by the warpgroup (one value a
//     thread).
//   * Every product is one bf16 wgmma a 16-deep step (m64n64k16 for S and
//     dP, the first step write-only; m64nDk16 into the accumulators). Tiles
//     are TMA copies of the bf16 inputs as stored, in the 128-byte swizzle
//     (64-byte at D = 32): no prep launch. The score products read both
//     operands K-major (contracting over D); the products into dv, dk and
//     dq read the same streamed tiles MN-major through the descriptor's
//     transpose bit, so no transposed copy exists. P and dS leave the f32
//     accumulator fragment of S / dP as bf16 pairs that are, register for
//     register, the A fragment of the next product. Shared-memory pointers
//     are offsets into the block's array, so they stay 32-bit.
//   * Shared memory (fixed + ring + exchange + lse/delta): dk/dv at D = 64
//     32 + 4 x 16 + 2 KB; D = 128 32 + 4 x 32 + 32 + 1 KB (194 KB); D = 256
//     64 + 2 x 64 + 32 + 1 KB (226 KB of the 227 KB a block may take); dq
//     at D = 128 64 + 4 x 32 KB, at D = 256 64 + 2 x 64 + 32 KB. D = 192
//     takes D = 256's settings (two stages; dk/dv 48 + 2 x 48 + 32 + 1 KB,
//     dq 48 + 2 x 48 + 32 KB): a row-split dq warpgroup there would hold a
//     64 x 192 accumulator, S, dP, P and dS (192 registers before any
//     address), where D = 128's row-split dk/dv at as many spilled.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kR = 64;                  // rows of a warpgroup's own tile and of a streamed one
constexpr int kThreads = 256;           // two consumer warpgroups: the whole block
constexpr int kProducer = 128;          // the thread that starts every copy
constexpr int kDeltaThreads = 256;
// named barrier kPre + wg: warpgroup wg's own (its lse / delta prefetch);
// 0 is __syncthreads'
constexpr int kPre = 1;

// The swizzled layout of a 64-row tile of D bf16 columns.
template <int D>
struct Lay {
  static constexpr int SW = D >= 64 ? 128 : 64;    // swizzle span (bytes of a row)
  static constexpr int E = SW / 2;                 // bf16 columns per swizzled box
  static constexpr int NC = D / E;                 // boxes across D
  static constexpr int TILE = kR * D * 2;          // one 64-row tile's bytes
  static_assert(D % E == 0, "D is a whole number of boxes");
};

// A launch's blocks: dk/dv (kDQ false) or dq.
template <int D, bool kDQ>
struct Bwd {
  // the warpgroups split the products of 64 rows, not 128 rows between
  // them: dk/dv from D = 128 (a row-split warpgroup there holds two 64 x 128
  // f32 accumulators, S, dP, P and dS, 224 registers, and ptxas spilled the
  // ring's and the masks' state past 255), dq from D = 192
  static constexpr bool SPLIT = kDQ ? D >= 192 : D >= 128;
  static constexpr int ROWS = SPLIT ? kR : 2 * kR; // a block's own rows (keys, or queries)
  static constexpr int NS = D > 128 ? 2 : 4;       // ring of streamed stages
  // the next step's score products issued right behind this step's output
  // products (dq at D <= 64 runs two blocks an SM, in 128 registers, and
  // waits for its output products first)
  static constexpr bool PIPE = !kDQ || D > 64;
  static constexpr int BLOCKS = kDQ && D <= 64 ? 2 : 1;
  static constexpr int TILE = Lay<D>::TILE;
  static constexpr int FIXED = 2 * ROWS * D * 2;   // the block's two fixed operands
  static constexpr int XCH = SPLIT ? 2 * kR * kR * 4 : 0;   // two 64 x 64 f32 buffers
  // dk/dv: a step's lse (times log2 e) and delta of its 64 queries, two
  // buffers a warpgroup; each warpgroup reads both in the row split, one in
  // the product split
  static constexpr int PRE_W = SPLIT ? kR : 2 * kR;   // floats a buffer
  static constexpr int PRE = kDQ ? 0 : 2 * 2 * PRE_W * 4;
  static constexpr int BARS = 2 * NS + 1 + (SPLIT ? 4 : 0);   // mbarriers
  static constexpr int SMEM = 1024 + FIXED + NS * 2 * TILE + XCH + PRE + 8 * BARS;
  static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
};

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Rows [row0, row0 + 64) of one head: NC boxes of E columns, box c at
// dst + c * 64 * SW, each row SW bytes in the swizzled layout.
template <int D>
__device__ __forceinline__ void load_tile(char* dst, const CUtensorMap* map, uint64_t* bar,
                                          int head, int row0, int b) {
  using L = Lay<D>;
#pragma unroll
  for (int c = 0; c < L::NC; ++c)
    sm90::tma_load_4d(dst + c * kR * L::SW, map, bar, c * L::E, head, row0, b);
}

// Descriptors of a tile loaded by load_tile. K-major (contracting over D):
// 8-row groups 8 SW bytes apart. MN-major (contracting over the rows, N over
// D): boxes of E columns 64 SW bytes apart (leading), groups of 8 rows 8 SW
// bytes apart (stride). Offsets are added in 16-byte units.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(const char* t) {
  return sm90::smem_desc(t, 16, 8 * Lay<D>::SW, Lay<D>::SW);
}

template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(const char* t) {
  return sm90::smem_desc(t, kR * Lay<D>::SW, 8 * Lay<D>::SW, Lay<D>::SW);
}

// K-major depth kk * 16: box c, byte `inner` into each swizzled row.
template <int D>
__device__ __forceinline__ uint64_t kmajor_step(int kk) {
  using L = Lay<D>;
  return static_cast<uint64_t>(((kk * 16 / L::E) * kR * L::SW + (kk * 16 % L::E) * 2) >> 4);
}

// s[64 x 64] = X Y^T over all of D, X and Y 64-row tiles, both K-major, the
// first 16-deep step write-only (s is no input). Part of the caller's commit
// group.
template <int D>
__device__ __forceinline__ void scores(float (&s)[kR / 2], uint64_t x, uint64_t y) {
  sm90::wgmma_ss_init<kR>(s, x, y);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk)
    sm90::wgmma_ss<kR>(s, x + kmajor_step<D>(kk), y + kmajor_step<D>(kk), 1);
}

// acc[64 x D] += A [64 x 64] Y: A as bf16 fragments (four registers per 16
// rows of Y), y the MN-major descriptor of Y. Part of the caller's commit
// group.
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[D / 2], const uint32_t (&a)[kR / 16][4],
                                           uint64_t y) {
#pragma unroll
  for (int kk = 0; kk < kR / 16; ++kk)
    sm90::wgmma_rs<D>(acc, a[kk], y + ((kk * 16 * Lay<D>::SW) >> 4), 1);
}

// A score element in log2 units, z (P = 2^(z - lse log2 e)), and the factor
// dS takes beside P (dP - delta): (1 - t^2) scale with a softcap, t =
// tanh(raw scale / softcap) and z = t softcap log2 e; scale without one, and
// z = raw scale log2 e. tanh(y) = 1 - 2 / (2^(2 y log2 e) + 1) on the fast
// exp2 and reciprocal, within about 1e-7 of tanh; P's exp2 is the forward's.
// scale = 1 / sqrt(Dt), the f32 value of 1.0f / sqrtf(Dt) for the true head
// dim Dt, and zscale = scale * log2 e (its f32 product) are kernel
// arguments, read where they are used (an instruction's constant operand,
// not a register the loop holds).
template <bool kCap>
struct Score {
  float scale, zscale;
  float c_raw, c_cap;   // raw -> tanh's argument and t -> z (softcap only)
  __device__ __forceinline__ Score(float softcap, float scale_, float zscale_)
      : scale(scale_), zscale(zscale_), c_raw(kCap ? scale_ / softcap : 0.f),
        c_cap(softcap * kLog2e) {}
  __device__ __forceinline__ void eval(float raw, float& z, float& chain) const {
    if constexpr (kCap) {
      const float t = 1.f - 2.f * rcp(ex2(raw * c_raw * (2.f * kLog2e)) + 1.f);
      z = t * c_cap;
      chain = (1.f - t * t) * scale;
    } else {
      z = raw * zscale;
      chain = scale;
    }
  }
};

// The kept columns of one row of a score tile, relative to the thread's
// first column col0: the fragment's element 4 j + e is in column col0 +
// 8 j + (e & 1), kept when lo <= 8 j + (e & 1) <= hi. In dq rows are
// queries and columns keys; in dk/dv rows are keys and columns queries.
struct Range {
  int lo, hi;
  __device__ __forceinline__ bool has(int rel) const { return rel >= lo && rel <= hi; }
};

__device__ __forceinline__ Range keys_of_query(int q, int col0, int Sq, int Sk, int causal,
                                               int window) {
  if (q >= Sq) return {1, 0};
  const int first = (causal && window > 0) ? q - window + 1 : 0;
  const int last = causal ? min(q, Sk - 1) : Sk - 1;
  return {first - col0, last - col0};
}

__device__ __forceinline__ Range queries_of_key(int k, int col0, int Sq, int Sk, int causal,
                                                int window) {
  if (k >= Sk) return {1, 0};
  const int first = causal ? k : 0;
  const int last = (causal && window > 0) ? min(Sq - 1, k + window - 1) : Sq - 1;
  return {first - col0, last - col0};
}

// Whether every pair of queries [q0, q0 + 64) and keys [k0, k0 + 64) is
// kept (no element of the tile needs its range tested).
__device__ __forceinline__ bool all_kept(int q0, int k0, int Sq, int Sk, int causal, int window) {
  if (q0 + kR > Sq || k0 + kR > Sk) return false;
  return !causal || (k0 + kR - 1 <= q0 && (window <= 0 || k0 > q0 + kR - 1 - window));
}

// P and dS of a [64 x 64] score tile held as the accumulator fragments (s:
// the scores, dp: dO . v), rounded to bf16 A fragments: the row-split
// launches, where a warpgroup holds both products of its rows.
// ll(j, e) and dl(j, e): lse (times log2 e) and delta of element 4 j + e's
// query; with `edge` each element is held to its row's range (r0: e < 2).
template <bool kCap, int D, typename LL, typename DL>
__device__ __forceinline__ void p_and_ds(const float (&s)[kR / 2], const float (&dp)[kR / 2],
                                         const Score<kCap>& sc, bool edge, Range r0, Range r1,
                                         LL ll, DL dl, uint32_t (&pf)[kR / 16][4],
                                         uint32_t (&dsf)[kR / 16][4]) {
#pragma unroll
  for (int j = 0; j < kR / 8; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float z, chain;
      sc.eval(s[4 * j + e], z, chain);
      p[e] = ex2(z - ll(j, e));
      if (edge && !(e < 2 ? r0 : r1).has(8 * j + (e & 1))) p[e] = 0.f;
      ds[e] = p[e] * (dp[4 * j + e] - dl(j, e)) * chain;
    }
    pf[j / 2][(j % 2) * 2] = pack(p[0], p[1]);
    pf[j / 2][(j % 2) * 2 + 1] = pack(p[2], p[3]);
    dsf[j / 2][(j % 2) * 2] = pack(ds[0], ds[1]);
    dsf[j / 2][(j % 2) * 2 + 1] = pack(ds[2], ds[3]);
  }
}

// The product split, the score warpgroup's half of p_and_ds: P as bf16 A fragments
// (pf) and, into this thread's slots of the exchange buffer (x[128 j],
// j < 8), g = P (1 - tanh^2) scale, the factor dS = g (dP - delta) takes
// from the scores.
template <bool kCap, int D, typename LL>
__device__ __forceinline__ void probs(const float (&s)[kR / 2], const Score<kCap>& sc,
                                      bool edge, Range r0, Range r1, LL ll,
                                      uint32_t (&pf)[kR / 16][4], float4* __restrict__ x) {
#pragma unroll
  for (int j = 0; j < kR / 8; ++j) {
    float p[4], g[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float z, chain;
      sc.eval(s[4 * j + e], z, chain);
      p[e] = ex2(z - ll(j, e));
      if (edge && !(e < 2 ? r0 : r1).has(8 * j + (e & 1))) p[e] = 0.f;
      g[e] = p[e] * chain;
    }
    pf[j / 2][(j % 2) * 2] = pack(p[0], p[1]);
    pf[j / 2][(j % 2) * 2 + 1] = pack(p[2], p[3]);
    x[128 * j] = make_float4(g[0], g[1], g[2], g[3]);
  }
}

// The product split, the gradient warpgroup's half: dS = g (dP - delta) as bf16 A
// fragments, g read from the score warpgroup's slots of the same elements
// (the two warpgroups' fragments hold the same (row, column) pairs).
template <typename DL>
__device__ __forceinline__ void grads(const float (&dp)[kR / 2], const float4* __restrict__ x,
                                      DL dl, uint32_t (&dsf)[kR / 16][4]) {
#pragma unroll
  for (int j = 0; j < kR / 8; ++j) {
    const float4 g4 = x[128 * j];
    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[e] = g[e] * (dp[4 * j + e] - dl(j, e));
    dsf[j / 2][(j % 2) * 2] = pack(ds[0], ds[1]);
    dsf[j / 2][(j % 2) * 2 + 1] = pack(ds[2], ds[3]);
  }
}

// Rows row0 and row0 + 8 of a [64 x D] f32 accumulator into out
// [B, S, heads, D] bf16 at head `head`.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[D / 2],
                                           int b, int S, int heads, int head, int row0, int col) {
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = row0 + 8 * e;
    if (r >= S) continue;
    bf16* dst = out + ((static_cast<size_t>(b) * S + r) * heads + head) * D + col;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
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

extern __shared__ uint8_t smem_raw[];   // a block's dynamic shared memory

// The block's shared memory: the fixed operands (ROWS rows of two inputs,
// as 64-row tiles), the ring (stage s: two 64-row tiles at sY + 2 s TILE),
// the exchange buffers (product split), dk/dv's lse / delta buffers and the
// barriers: full and empty a stage, one for the fixed operands, and at
// the product split xfull and xempty an exchange buffer (its g written by warpgroup
// 0; read by warpgroup 1).
template <int D, bool kDQ>
struct Smem {
  char *sA, *sB, *sY;
  float *xch, *pre;
  uint64_t *full, *empty, *fixed, *xfull, *xempty;
  __device__ __forceinline__ explicit Smem(uint8_t* raw) {
    using T = Bwd<D, kDQ>;
    // 1024-byte aligned, as an offset into the shared array: the compiler
    // then keeps every pointer below in the shared window (32-bit registers)
    sA = reinterpret_cast<char*>(raw) + ((1024u - (sm90::smem_addr(raw) & 1023u)) & 1023u);
    sB = sA + T::FIXED / 2;
    sY = sB + T::FIXED / 2;
    xch = reinterpret_cast<float*>(sY + T::NS * 2 * T::TILE);
    pre = reinterpret_cast<float*>(reinterpret_cast<char*>(xch) + T::XCH);
    full = reinterpret_cast<uint64_t*>(reinterpret_cast<char*>(pre) + T::PRE);
    empty = full + T::NS;
    fixed = empty + T::NS;
    xfull = fixed + 1;
    xempty = xfull + 2;
  }
};

// The ring's copies, started by the producer thread: the fixed operands'
// 64-row tiles (fixed_head, rows x0 ..), then (LoadStep) step i's two
// streamed tiles (step(i) gives their head and first row) into stage s.
template <int D, bool kDQ>
__device__ __forceinline__ void load_fixed(const Smem<D, kDQ>& sm, const CUtensorMap* fa,
                                           const CUtensorMap* fb, int fixed_head, int x0,
                                           int b) {
  using T = Bwd<D, kDQ>;
  sm90::mbar_arrive_expect_tx(sm.fixed, T::FIXED);
#pragma unroll
  for (int r = 0; r < T::ROWS / kR; ++r) {
    load_tile<D>(sm.sA + r * T::TILE, fa, sm.fixed, fixed_head, x0 + r * kR, b);
    load_tile<D>(sm.sB + r * T::TILE, fb, sm.fixed, fixed_head, x0 + r * kR, b);
  }
}

// (The ring's addresses are recomputed from the block's shared memory at
// each copy, so the consumers keep no register for them.)
template <int D, bool kDQ, typename Step>
struct LoadStep {
  const CUtensorMap *ya, *yb;
  int b;
  Step step;
  __device__ __forceinline__ void operator()(int i, int s) const {
    using T = Bwd<D, kDQ>;
    const Smem<D, kDQ> sm(smem_raw);
    int head, row0;
    step(i, head, row0);
    char* dst = sm.sY + s * 2 * T::TILE;
    sm90::mbar_arrive_expect_tx(&sm.full[s], 2 * T::TILE);
    load_tile<D>(dst, ya, &sm.full[s], head, row0, b);
    load_tile<D>(dst + T::TILE, yb, &sm.full[s], head, row0, b);
  }
};

template <int D, bool kDQ>
__device__ __forceinline__ void init_barriers(const Smem<D, kDQ>& sm) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < Bwd<D, kDQ>::NS; ++s) {
      sm90::mbar_init(&sm.full[s], 1);
      sm90::mbar_init(&sm.empty[s], kThreads / 32);   // one arrival per consumer warp
    }
    sm90::mbar_init(sm.fixed, 1);
    if constexpr (Bwd<D, kDQ>::SPLIT) {
      for (int b = 0; b < 2; ++b) {   // every thread of the writing / reading warpgroup
        sm90::mbar_init(&sm.xfull[b], 128);
        sm90::mbar_init(&sm.xempty[b], 128);
      }
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
}

// One consumer warpgroup's loop over the streamed steps, the same in every
// launch. Round i issues this warpgroup's output products of step i - 1
// (`acc`, when due) and the score products of step i (`scores`, when
// `live(i)`: a step none of whose pairs this warpgroup keeps issues none),
// each as a commit group: back to back with kPipe, else the output products
// are waited on first (their fragments and the new scores' accumulators then
// need not be live at once). The round's products are waited on within the
// round, so none is in flight across the loop's back edge (where the
// compiler may move registers, and ptxas would serialise every wgmma,
// C7515); step i - 1's stage is released, and `pre(i)` and `elem(i)` (P and
// dS on the CUDA cores; it returns whether output products are due) run
// while the other warpgroup's products occupy the tensor cores. The
// producer thread (kProducer) refills the ring after each release, at the
// latest the next step's tiles. Every phase of every barrier is passed in
// order.
template <int NS, bool kPipe, typename Ring, typename Live, typename Pre, typename Scores,
          typename Elem, typename Acc>
__device__ __forceinline__ void consume(uint64_t* full, uint64_t* empty, int n_steps,
                                        Ring& ring, Live live, Pre pre, Scores scores,
                                        Elem elem, Acc acc) {
  const int lane = threadIdx.x % 32;
  const bool producer = threadIdx.x == kProducer;
  if (producer) ring.poll(1);
  pre(-1);
  bool due = false;
  for (int i = 0;; ++i) {
    bool sc = false;
    if (i < n_steps) {
      sm90::mbar_wait(&full[i % NS], (i / NS) & 1);
      sc = live(i);
    }
    if (due) {
      acc(i - 1, (i - 1) % NS);
      if constexpr (!kPipe) sm90::wgmma_wait<0>();
    }
    if (sc) scores(i, i % NS);
    sm90::wgmma_wait<0>();
    if (i > 0 && lane == 0) sm90::mbar_arrive(&empty[(i - 1) % NS]);
    if (i == n_steps) break;
    if (producer) ring.poll(i + 2);   // step i + 1's tiles at the latest
    pre(i);
    due = sc && elem(i, i % NS);
  }
}

#define REPRO_TC_BWD_MAPS                                                           \
  const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,   \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo

// dk and dv of one (ROWS keys, kv head, batch) tile.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_dkdv_kernel(REPRO_TC_BWD_MAPS, const float* __restrict__ lse,
                         const float* __restrict__ delta, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, int Sq, int Sk, int H, int KV, int causal,
                         int window, float softcap, float scale, float zscale) {
  using T = Bwd<D, false>;
  const Smem<D, false> sm(smem_raw);   // fixed: K (sA) and V (sB); a stage: Q, then dO

  const int kvh = blockIdx.x, b = blockIdx.y, x0 = blockIdx.z * T::ROWS;   // k tile 0 first
  const int group = H / KV;
  // q tiles that hold a query keeping some key of this block
  const int k_last = min(x0 + T::ROWS, Sk) - 1;
  const int q_begin = causal ? x0 : 0;
  const int q_end = (causal && window > 0) ? min(Sq, k_last + window) : Sq;
  const int t_begin = q_begin / kR;
  const int nq = max(0, (q_end + kR - 1) / kR - t_begin);
  const int n_steps = group * nq;   // the group's q heads in order, each over its q tiles
  const int tid = threadIdx.x;
  // the warpgroup index, read from lane 0 so the compiler sees it is the
  // same across the warp
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  auto step = [=](int i, int& head, int& pos0) {
    head = kvh * group + i / nq;
    pos0 = (t_begin + i % nq) * kR;
  };

  init_barriers(sm);
  if (tid == kProducer) load_fixed(sm, &tk, &tv, kvh, x0, b);
  sm90::Ring<T::NS, LoadStep<D, false, decltype(step)>> ring{
      sm.empty, n_steps, LoadStep<D, false, decltype(step)>{&tq, &tdo, b, step}, 0};
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int col = 2 * (lane % 4);   // this thread's first column in each group of 8
  const uint64_t y_k = kmajor_desc<D>(sm.sY), y_mn = mnmajor_desc<D>(sm.sY);   // stage 0's Q
  constexpr uint64_t kStage = (2 * T::TILE) >> 4, kSecond = T::TILE >> 4;      // dO = Q + kSecond
  const Score<kCap> sc(softcap, scale, zscale);

  // lse (times log2 e) and delta of each step's queries, through shared
  // memory: thread t of a warpgroup loads query t % 64's (lse for t < 64 at
  // the row split, for warpgroup 0 in the product split; else delta) a step
  // ahead
  float* pre_buf = sm.pre + wg * 2 * T::PRE_W;
  const bool pre_on = !T::SPLIT || t < kR;
  const bool pre_lse = T::SPLIT ? wg == 0 : t < kR;
  auto pre_load = [&](int i) {
    int head, pos0;
    step(i, head, pos0);
    const int q = pos0 + t % kR;
    if (!pre_on || i >= n_steps || q >= Sq) return 0.f;
    const size_t g = (static_cast<size_t>(b) * H + head) * Sq + q;
    return pre_lse ? lse[g] * kLog2e : delta[g];
  };
  float pre_v = 0.f;
  auto pre = [&](int i) {
    if (i < 0) {   // step 0's values into buffer 0, step 1's into pre_v
      if (pre_on) pre_buf[t] = pre_load(0);
      pre_v = pre_load(1);
      return;
    }
    sm90::named_sync(kPre + wg, 128);   // buffer i % 2 written, (i + 1) % 2 read
    if (pre_on) pre_buf[((i + 1) % 2) * T::PRE_W + t] = pre_v;
    pre_v = pre_load(i + 2);
  };
  sm90::mbar_wait(sm.fixed, 0);

  if constexpr (!T::SPLIT) {
    // row split: warpgroup wg owns keys kw0 .. kw0 + 63 and both of their
    // outputs; the two warpgroups share each streamed Q/dO stage
    const int kw0 = x0 + wg * kR, kw_last = min(kw0 + kR, Sk) - 1;
    const int row0 = kw0 + warp * 16 + lane / 4;   // this thread's keys: row0, row0 + 8
    const uint64_t k_desc = kmajor_desc<D>(sm.sA + wg * T::TILE);
    const uint64_t v_desc = kmajor_desc<D>(sm.sB + wg * T::TILE);
    float acc_k[D / 2], acc_v[D / 2], s[kR / 2], dp[kR / 2];
    uint32_t pf[kR / 16][4], dsf[kR / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) {
      acc_k[i] = 0.f;
      acc_v[i] = 0.f;
    }
    // whether step i's q tile keeps a key of this warpgroup
    auto live = [&](int i) {
      int head, pos0;
      step(i, head, pos0);
      if (kw0 >= Sk) return false;
      return !causal || (pos0 + kR - 1 >= kw0 && !(window > 0 && pos0 >= kw_last + window));
    };
    auto scores_of = [&](int, int st) {
      sm90::wgmma_fence();
      scores<D>(s, k_desc, y_k + st * kStage);             // S^T = K Q^T
      scores<D>(dp, v_desc, y_k + st * kStage + kSecond);  // dP^T = V dO^T
      sm90::wgmma_commit();
    };
    auto elem = [&](int i, int) {
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      int head, pos0;
      step(i, head, pos0);
      const float* lb = pre_buf + (i % 2) * T::PRE_W;
      p_and_ds<kCap, D>(
          s, dp, sc, !all_kept(pos0, kw0, Sq, Sk, causal, window),
          queries_of_key(row0, pos0 + col, Sq, Sk, causal, window),
          queries_of_key(row0 + 8, pos0 + col, Sq, Sk, causal, window),
          [&](int j, int e) { return lb[8 * j + col + (e & 1)]; },
          [&](int j, int e) { return lb[kR + 8 * j + col + (e & 1)]; }, pf, dsf);
      return true;
    };
    auto acc = [&](int, int st) {
      sm90::wgmma_fence();
      accumulate<D>(acc_v, pf, y_mn + st * kStage + kSecond);   // dV += P^T dO
      accumulate<D>(acc_k, dsf, y_mn + st * kStage);            // dK += dS^T Q
      sm90::wgmma_commit();
    };
    consume<T::NS, T::PIPE>(sm.full, sm.empty, n_steps, ring, live, pre, scores_of, elem,
                                 acc);
    sm90::fence_regs(acc_k);
    sm90::fence_regs(acc_v);
    store_rows<D>(dk, acc_k, b, Sk, KV, kvh, row0, col);
    store_rows<D>(dv, acc_v, b, Sk, KV, kvh, row0, col);
  } else {
    // product split (D >= 128): warpgroup 0 computes S^T = K Q^T, P and
    // dV += P^T dO; warpgroup 1 dP^T = V dO^T, dS and dK += dS^T Q, with g
    // from warpgroup 0 through the exchange buffer of the step's parity.
    // Each score product sums all of D in one chain, as in the row split.
    const int row0 = x0 + warp * 16 + lane / 4;
    const uint64_t x_desc = kmajor_desc<D>(wg == 0 ? sm.sA : sm.sB);
    const uint64_t y_off = wg == 0 ? 0 : kSecond;   // the score product's streamed tile
    const uint64_t a_off = wg == 0 ? kSecond : 0;   // the output product's
    float4* slot = reinterpret_cast<float4*>(sm.xch) + t;
    float acc_x[D / 2], sx[kR / 2];
    uint32_t frag[kR / 16][4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_x[i] = 0.f;
    auto live = [](int) { return true; };   // 64 keys: every step keeps a pair
    auto scores_of = [&](int, int st) {
      sm90::wgmma_fence();
      scores<D>(sx, x_desc, y_k + st * kStage + y_off);
      sm90::wgmma_commit();
    };
    auto elem = [&](int i, int) {
      sm90::fence_regs(sx);
      int head, pos0;
      step(i, head, pos0);
      const float* lb = pre_buf + (i % 2) * T::PRE_W;
      const int buf = i % 2;
      float4* x = slot + buf * (kR * kR / 4);
      auto by_query = [&](int j, int e) { return lb[8 * j + col + (e & 1)]; };
      if (wg == 0) {
        if (i >= 2) sm90::mbar_wait(&sm.xempty[buf], (i / 2 - 1) & 1);
        probs<kCap, D>(sx, sc, !all_kept(pos0, x0, Sq, Sk, causal, window),
                    queries_of_key(row0, pos0 + col, Sq, Sk, causal, window),
                    queries_of_key(row0 + 8, pos0 + col, Sq, Sk, causal, window), by_query, frag,
                    x);
        sm90::mbar_arrive(&sm.xfull[buf]);   // release: this thread's g
      } else {
        sm90::mbar_wait(&sm.xfull[buf], (i / 2) & 1);
        grads(sx, x, by_query, frag);
        sm90::mbar_arrive(&sm.xempty[buf]);
      }
      return true;
    };
    auto acc = [&](int, int st) {
      sm90::wgmma_fence();
      accumulate<D>(acc_x, frag, y_mn + st * kStage + a_off);   // dV (wg 0) or dK (wg 1)
      sm90::wgmma_commit();
    };
    consume<T::NS, true>(sm.full, sm.empty, n_steps, ring, live, pre, scores_of, elem, acc);
    sm90::fence_regs(acc_x);
    store_rows<D>(wg == 0 ? dv : dk, acc_x, b, Sk, KV, kvh, row0, col);
  }
}

// dq of one (ROWS queries, head, batch) tile.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, Bwd<D, true>::BLOCKS)
flash_bwd_tc_dq_kernel(REPRO_TC_BWD_MAPS, const float* __restrict__ lse,
                       const float* __restrict__ delta, bf16* __restrict__ dq, int Sq, int Sk,
                       int H, int KV, int causal, int window, float softcap, float scale,
                       float zscale) {
  using T = Bwd<D, true>;
  const Smem<D, true> sm(smem_raw);   // fixed: Q (sA) and dO (sB); a stage: K, then V

  const int h = blockIdx.x, b = blockIdx.y;
  const int x0 = (gridDim.z - 1 - blockIdx.z) * T::ROWS;   // heaviest q tile first
  const int kvh = h / (H / KV);
  // k tiles that hold a kept key for some row of this block
  const int q_last = min(x0 + T::ROWS, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, x0 - window + 1) : 0;
  const int t_begin = k_begin / kR;
  const int n_steps = max(0, (k_end + kR - 1) / kR - t_begin);
  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  auto step = [=](int i, int& head, int& pos0) {
    head = kvh;
    pos0 = (t_begin + i) * kR;
  };

  init_barriers(sm);
  if (tid == kProducer) load_fixed(sm, &tq, &tdo, h, x0, b);
  sm90::Ring<T::NS, LoadStep<D, true, decltype(step)>> ring{
      sm.empty, n_steps, LoadStep<D, true, decltype(step)>{&tk, &tv, b, step}, 0};
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int col = 2 * (lane % 4);
  const uint64_t y_k = kmajor_desc<D>(sm.sY), y_mn = mnmajor_desc<D>(sm.sY);   // stage 0's K
  constexpr uint64_t kStage = (2 * T::TILE) >> 4, kSecond = T::TILE >> 4;      // V = K + kSecond
  const Score<kCap> sc(softcap, scale, zscale);
  // this warpgroup's queries (row split) or the block's (product split)
  const int qw0 = x0 + (T::SPLIT ? 0 : wg * kR);
  const int row0 = qw0 + warp * 16 + lane / 4;   // this thread's queries: row0, row0 + 8
  float rl[2] = {0.f, 0.f}, rd[2] = {0.f, 0.f};  // lse (times log2 e) and delta of the rows
#pragma unroll
  for (int e = 0; e < 2; ++e)
    if (row0 + 8 * e < Sq) {
      const size_t g = (static_cast<size_t>(b) * H + h) * Sq + row0 + 8 * e;
      rl[e] = lse[g] * kLog2e;
      rd[e] = delta[g];
    }
  auto by_row_l = [&](int, int e) { return rl[e >> 1]; };
  auto by_row_d = [&](int, int e) { return rd[e >> 1]; };
  auto pre = [](int) {};   // lse and delta are the rows' own, in registers
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  sm90::mbar_wait(sm.fixed, 0);

  if constexpr (!T::SPLIT) {
    // row split: warpgroup wg owns queries qw0 .. qw0 + 63; the two share
    // each streamed K/V stage
    const int qw_last = min(qw0 + kR, Sq) - 1;
    const uint64_t q_desc = kmajor_desc<D>(sm.sA + wg * T::TILE);
    const uint64_t o_desc = kmajor_desc<D>(sm.sB + wg * T::TILE);
    float s[kR / 2], dp[kR / 2];
    uint32_t pf[kR / 16][4], dsf[kR / 16][4];
    // whether step i's k tile holds a key kept by a query of this warpgroup
    auto live = [&](int i) {
      const int pos0 = (t_begin + i) * kR;
      if (qw0 >= Sq) return false;
      return !causal ||
             (pos0 <= qw_last && !(window > 0 && pos0 + kR - 1 <= qw0 - window));
    };
    auto scores_of = [&](int, int st) {
      sm90::wgmma_fence();
      scores<D>(s, q_desc, y_k + st * kStage);             // S = Q K^T
      scores<D>(dp, o_desc, y_k + st * kStage + kSecond);  // dP = dO V^T
      sm90::wgmma_commit();
    };
    auto elem = [&](int i, int) {
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      const int pos0 = (t_begin + i) * kR;
      p_and_ds<kCap, D>(s, dp, sc, !all_kept(qw0, pos0, Sq, Sk, causal, window),
                     keys_of_query(row0, pos0 + col, Sq, Sk, causal, window),
                     keys_of_query(row0 + 8, pos0 + col, Sq, Sk, causal, window), by_row_l,
                     by_row_d, pf, dsf);
      return true;
    };
    auto acc_of = [&](int, int st) {
      sm90::wgmma_fence();
      accumulate<D>(acc, dsf, y_mn + st * kStage);   // dQ += dS K
      sm90::wgmma_commit();
    };
    consume<T::NS, T::PIPE>(sm.full, sm.empty, n_steps, ring, live, pre, scores_of, elem,
                               acc_of);
    sm90::fence_regs(acc);
    store_rows<D>(dq, acc, b, Sq, H, h, row0, col);
  } else {
    // product split (D >= 192): warpgroup 0 computes S = Q K^T and P's
    // factor g; warpgroup 1 dP = dO V^T, dS and dQ += dS K
    const uint64_t x_desc = kmajor_desc<D>(wg == 0 ? sm.sA : sm.sB);
    const uint64_t y_off = wg == 0 ? 0 : kSecond;
    float4* slot = reinterpret_cast<float4*>(sm.xch) + t;
    float sx[kR / 2];
    uint32_t frag[kR / 16][4];
    auto live = [](int) { return true; };   // 64 queries: every step keeps a pair
    auto scores_of = [&](int, int st) {
      sm90::wgmma_fence();
      scores<D>(sx, x_desc, y_k + st * kStage + y_off);
      sm90::wgmma_commit();
    };
    auto elem = [&](int i, int) {
      sm90::fence_regs(sx);
      const int pos0 = (t_begin + i) * kR;
      const int buf = i % 2;
      float4* x = slot + buf * (kR * kR / 4);
      if (wg == 0) {
        if (i >= 2) sm90::mbar_wait(&sm.xempty[buf], (i / 2 - 1) & 1);
        probs<kCap, D>(sx, sc, !all_kept(x0, pos0, Sq, Sk, causal, window),
                    keys_of_query(row0, pos0 + col, Sq, Sk, causal, window),
                    keys_of_query(row0 + 8, pos0 + col, Sq, Sk, causal, window), by_row_l, frag,
                    x);
        sm90::mbar_arrive(&sm.xfull[buf]);   // release: this thread's g
        return false;                        // no output product
      }
      sm90::mbar_wait(&sm.xfull[buf], (i / 2) & 1);
      grads(sx, x, by_row_d, frag);
      sm90::mbar_arrive(&sm.xempty[buf]);
      return true;
    };
    auto acc_of = [&](int, int st) {
      sm90::wgmma_fence();
      accumulate<D>(acc, frag, y_mn + st * kStage);   // dQ += dS K
      sm90::wgmma_commit();
    };
    consume<T::NS, true>(sm.full, sm.empty, n_steps, ring, live, pre, scores_of, elem, acc_of);
    sm90::fence_regs(acc);
    if (wg == 1) store_rows<D>(dq, acc, b, Sq, H, h, row0, col);
  }
}
#undef REPRO_TC_BWD_MAPS

// ---- host side --------------------------------------------------------------

struct BwdArgs {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  void *dq, *dk, *dv;
  int B, Sq, Sk, H, KV, causal, window;
  float softcap, scale;   // scale = 1 / sqrt(Dt)
};

template <int D, bool kCap>
cudaError_t launch_bwd(const BwdArgs& a, cudaStream_t st) {
  using KV = Bwd<D, false>;
  using Q = Bwd<D, true>;
  constexpr int SW = Lay<D>::SW;
  cudaError_t err = sm90::bind_context();
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv, tdo;
  if (!sm90::bf16_rows_map(&tq, a.q, a.B, a.Sq, a.H, D, kR, SW) ||
      !sm90::bf16_rows_map(&tk, a.k, a.B, a.Sk, a.KV, D, kR, SW) ||
      !sm90::bf16_rows_map(&tv, a.v, a.B, a.Sk, a.KV, D, kR, SW) ||
      !sm90::bf16_rows_map(&tdo, a.dout, a.B, a.Sq, a.H, D, kR, SW))
    return cudaErrorInvalidValue;
  const int rows = a.B * a.Sq * a.H;
  flash_bwd_tc_delta_kernel<D><<<(rows + kDeltaThreads / 32 - 1) / (kDeltaThreads / 32),
                                 kDeltaThreads, 0, st>>>(
      static_cast<const bf16*>(a.o), static_cast<const bf16*>(a.dout), a.delta, rows, a.Sq, a.H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  static std::atomic<uint64_t> dkdv_set{0}, dq_set{0};
  err = set_smem_once(dkdv_set, flash_bwd_tc_dkdv_kernel<D, kCap>, KV::SMEM);
  if (err != cudaSuccess) return err;
  err = set_smem_once(dq_set, flash_bwd_tc_dq_kernel<D, kCap>, Q::SMEM);
  if (err != cudaSuccess) return err;
  flash_bwd_tc_dkdv_kernel<D, kCap><<<dim3(a.KV, a.B, (a.Sk + KV::ROWS - 1) / KV::ROWS),
                                      kThreads, KV::SMEM, st>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
      a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.softcap, a.scale, a.scale * kLog2e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_tc_dq_kernel<D, kCap><<<dim3(a.H, a.B, (a.Sq + Q::ROWS - 1) / Q::ROWS), kThreads,
                                    Q::SMEM, st>>>(
      tq, tk, tv, tdo, a.lse, a.delta, static_cast<bf16*>(a.dq), a.Sq, a.Sk, a.H, a.KV,
      a.causal, a.window, a.softcap, a.scale, a.scale * kLog2e);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch_cap(const BwdArgs& a, cudaStream_t st) {
  return a.softcap > 0.f ? launch_bwd<D, true>(a, st) : launch_bwd<D, false>(a, st);
}

}  // namespace
}  // namespace repro

// C entry point, bf16 q, k, v, out, dout, dq, dk, dv ([..., D]); f32 lse
// [B,H,Sq] (the forward's) and delta [B,H,Sq] (scratch). Dt <= D: the head
// dim the scores are scaled by (1 / sqrt(Dt)), the operands' columns from Dt
// on being zeros the wrapper padded them with. causal is 0 or 1; window <= 0
// means none; softcap <= 0 means none. Launches delta, dk/dv and dq on
// `stream` in order and returns the first error (cudaGetLastError() after
// each launch; cudaErrorInvalidValue for a shape it does not take or a
// tensor map cuTensorMapEncodeTiled refuses).
extern "C" int repro_flash_attention_tc_bwd(const void* q, const void* k, const void* v,
                                            const void* out, const void* dout, const float* lse,
                                            float* delta, void* dq, void* dk, void* dv, int B,
                                            int Sq, int Sk, int H, int KV, int Dt, int D,
                                            int causal, int window, float softcap, void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 || H > 65535 ||
      (Sq + kR - 1) / kR > 65535 || (Sk + kR - 1) / kR > 65535 ||
      static_cast<long long>(B) * Sq * H > 0x7fffffffLL || Dt <= 0 || Dt > D)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a{q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV, causal, window, softcap,
            1.0f / sqrtf(static_cast<float>(Dt))};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 32: err = dispatch_cap<32>(a, st); break;
    case 64: err = dispatch_cap<64>(a, st); break;
    case 128: err = dispatch_cap<128>(a, st); break;
    case 192: err = dispatch_cap<192>(a, st); break;
    case 256: err = dispatch_cap<256>(a, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) a block of the dk/dv (dq = 0) or of the dq
// launch (dq = 1) takes at head dim D; 0 for a D it does not take. Not a
// launch.
extern "C" int repro_flash_tc_bwd_smem(int D, int dq) {
  using namespace repro;
  switch (D) {
    case 32: return dq ? Bwd<32, true>::SMEM : Bwd<32, false>::SMEM;
    case 64: return dq ? Bwd<64, true>::SMEM : Bwd<64, false>::SMEM;
    case 128: return dq ? Bwd<128, true>::SMEM : Bwd<128, false>::SMEM;
    case 192: return dq ? Bwd<192, true>::SMEM : Bwd<192, false>::SMEM;
    case 256: return dq ? Bwd<256, true>::SMEM : Bwd<256, false>::SMEM;
    default: return 0;
  }
}
