// Flash attention on Hopper's tensor cores (sm_90a) with tf32 wgmma
// products: the forward and its deterministic backward. In f32 each product
// is split-f32 ("3xTF32"); above head dim 256 bf16 operands take the same
// kernels with one TF32 product. The kernel bodies and the host side that
// flash_attention_f32tc.cu (head dims up to 256, f32) and
// flash_attention_f32tc_cluster.cu (head dims 320 to 1024, f32 and bf16)
// instantiate.
//
// Replaces: src/repro/kernels/flash_attention.py, `_kernel` / `flash_attention`
// (the Pallas TPU kernel, grid (B, H, S/bq, S/bk) with the k axis sequential)
// for f32 operands at head dims 32, 64, 128 (internlm2's train path), 192
// (d_model 768 over 4 heads: examples/torch_train_e2e.py --big) and 256
// (gemma2-9b's), and for f32 and bf16 operands at head dims 320 to 1024
// (internlm2-1.8b's d_model 2048 over the launchers' 4 heads: head dim 512,
// repro_torch.launch.train / serve --d-model 2048; 320 at --d-model 1280).
// Any other head dim Dt runs the instance of the next built width D (ops.py:
// flash_built_head_dim), the prep launch writing zeros into the copies'
// columns Dt .. D - 1 (no copy beyond the prep's own): they add nothing to a
// score, their output columns are not stored, and the scale is 1 / sqrt(Dt).
// The Pallas kernel has no backward (JAX differentiates XLA attention); the
// backward here is that of this forward.
//
// Function: as ref.flash_attention_ref / ref.flash_attention_backward_ref.
//   q [B,Sq,H,D], k/v [B,Sk,KV,D] (f32, or bf16 above head dim 256); q head
//   h reads kv head h / (H/KV). Scores (q.k)/sqrt(D), optional tanh softcap,
//   causal mask with optional window; a row whose sum is 0 outputs 0 (lse
//   +inf); lse [B,H,Sq] f32 = m + log(l) is written when asked and `o` is
//   the same bits either way. The backward takes q, k, v, o, lse, dO and
//   gives dq, dk, dv (dk, dv summed over the group's q heads) with delta =
//   rowsum(dO * o) f32 as scratch. Sums are f32 in both dtypes; bf16
//   outputs are rounded once, when stored.
//
// Numerics: one TF32 product keeps 10 mantissa bits and misses the f32
// tolerance (2e-5; tests/test_torch_kernels.py emulates both). Each f32
// operand x is split as hi = tf32(x), lo = tf32(x - hi) (cvt.rna), and each
// product is lo.hi + hi.lo + hi.hi with f32 sums (the lo.lo term, ~2^-22
// relative, is dropped), as CUTLASS's OpMultiplyAddFastF32, which PyTorch's
// f32 memory-efficient attention runs on mma.sync. A bf16 value has 8
// significant bits and is exact in TF32 (11), so with bf16 operands Q K^T
// and dO V^T are exact as one TF32 product with f32 sums (kOne: the prep
// writes only hi copies, every product is hi.hi); P and dS round to TF32,
// more bits than the bf16 tensor-core pair keeps (it rounds them to bf16).
//
// What bounds it on the card: operations. At [2,2048,16,128] kv 8 causal the
// forward's two products of the kept pairs are 34.4 GFLOP and the backward's
// five 85.9 GFLOP; three TF32 products each at 495 TFLOP/s give 208 us and
// 521 us (at 67 TFLOP/s off the tensor cores: 513 us and 1283 us). At
// [2,2048,16,256] (gemma2-9b) twice that: 68.75 / 171.88 GFLOP, 417 / 1042 us.
// At [2,2048,4,512] kv 2 the same as at [2,2048,16,128]; one TF32 product in
// bf16 a third of it (69 / 174 us).
//
// The K-major rule, and how the design keeps to it:
//   * For 32-bit types wgmma takes A (from shared memory) and B K-major only:
//     the contraction axis contiguous; there is no transpose bit. Q K^T,
//     dO V^T (and K Q^T, V dO^T) contract over D, which is contiguous as
//     stored. P V, dS K, P^T dO and dS^T Q contract over keys or queries, so
//     their B operands must be V^T, K^T, dO^T and Q^T: [D, S] with S
//     contiguous.
//   * A prep launch per call (prep_body) writes every operand the products
//     read as hi and lo copies: as stored (K-major over D) and, where the
//     rule asks, transposed to [B, heads, D, S_pad] (S_pad = S rounded up to
//     16, zeros past S). The main kernels then only TMA tiles into shared
//     memory and run wgmma on them.
//   * P and dS are A operands from registers. The tf32 A fragment holds
//     columns l % 4 and l % 4 + 4 of each 8-wide k group; the f32 accumulator
//     fragment holds columns 2 (l % 4) + {0, 1}. Feeding accumulator column
//     pair (2c, 2c + 1) as k slots (c, c + 4) contracts slot s with column
//     kPerm[s] = {0,2,4,6,1,3,5,7}[s]; the transposed copies store position
//     8 g + s of each group of 8 from row 8 g + kPerm[s], so both operands
//     follow the same permutation and the sum is unchanged. No shuffles.
//
// Design:
//   * One warpgroup (128 threads) per block; thread 0 starts every TMA copy.
//     A block owns 64 rows (its fixed operand: Q in the forward and dq
//     kernels, K and V in dk/dv) and streams tiles of 16 rows of the other
//     side. Each streamed tile has two parts with a barrier each: the K-major
//     part (read by the score products) and the transposed part (read by the
//     products into the accumulators). A part is refilled as soon as its
//     products of this tile are done, so its copy overlaps the softmax and
//     the products of the other part: in the forward for the next tile; in
//     the backward through rings (BwdRing: at D = 128 the dq launch two
//     stages of both parts, dk/dv two of the transposed one).
//   * The forward uses 96 KB of shared memory at D = 128, two blocks per SM
//     (one block's softmax overlaps the other's products); online softmax,
//     running max and sum in f32 registers. Tiles that causality or the
//     window rule out are never loaded; only edge tiles test each score.
//   * The backward (one block per SM: 225 KB of shared memory at D = 128),
//     deterministic, no atomics: the prep launch also writes
//     delta; dk/dv runs a block per (64 keys, kv head, batch) that loops over
//     the group's q heads and their q tiles in a fixed order, so the GQA sum
//     stays in the block; dq a block per (64 queries, head, batch). Each
//     output element is summed by one thread in one order: the same bits on
//     every call, as the trainer's resume check (==) needs. Recomputing S
//     and dP in both launches is 2 of 7 products.
//   * Each step's product into an accumulator (o, dq, dk, dv) is a fresh
//     wgmma sum over 16 keys or queries, added to the running f32 sum in
//     registers with round to nearest (o = o * alpha + P V as one FMA), not
//     accumulated in place across steps (see part_product).
//   * Causal order: the q tile is the slowest grid axis, reversed in the
//     forward and dq grids, so the heaviest tiles start first; in dk/dv the
//     k tile is the slowest axis in order (k tile 0 sees every query).
//
// Above D = 128, a cluster of N ranks (split_of): the D = 128 design does
// not fit one block. At D = 256 the backward's four fixed hi/lo operands
// would be 4 x 64 KB, over the 227 KB a block may hold, and its dk + dv sums
// 256 registers a thread; the forward's o sum and P V part would be 256. So
// a tile takes a thread block cluster of N blocks, rank r owning head-dim
// columns [DH r, DH r + DH) with DH in {64, 96, 128}: its share of the fixed
// operands (128 KB of hi/lo in the backward at DH = 128), of each streamed
// tile, and of o, dq or dk and dv (DH / 2 registers each, as at D = DH).
// Each rank computes its DH-column partial of S (and of dP) over its k loop,
// puts it in its shared memory, and after one cluster barrier a step forms
// the N-way sum through distributed shared memory. Every rank adds the
// partials in rank order, ((p0 + p1) + p2) + ... + p_{N-1}, reading its own
// at its place in that order (xch_sum), so every rank holds the same score
// bits and runs the same softmax or gradient on them: each score is
// computed once, not once per rank. A pair (N = 2, D = 192 and 256) keeps
// its own partial in registers and adds the peer's (xch_add): fl(a + b) =
// fl(b + a) gives both ranks those same bits. The exchange has two stages
// and one barrier a step: a rank rewrites a stage two steps later, after it
// has passed the next step's barrier, which every one of the N - 1 readers
// reaches only after its reads of that stage (the release on arrive orders
// them). With its 16 KB the backward rings keep one stage of each part in
// dk/dv at DH = 128, and in dq two of the K-major part and one transposed.
// The rest is the D = DH code: the ranks share the prep launch, the masks
// and the loop.
//   * D = 192 and 256 are pairs of 96 and 128 columns, built with
//     __cluster_dims__(2) (*_d192_* and *_d256_* in a profile). 128 + 64
//     columns would leave the two blocks unequal work behind one barrier a
//     step; three blocks of 64 would read two peers a step. Two consumer
//     warpgroups in one block, splitting D through its own shared memory,
//     would fit the forward but not the backward's fixed operands.
//   * Above 256 (*_cluster_* in a profile) the cluster size is set at
//     launch (cudaLaunchKernelEx with cudaLaunchAttributeClusterDimension),
//     one kernel instance per DH: 320 = 5 x 64, 384 = 3 x 128, 448 = 7 x 64,
//     512 = 4 x 128, 576 = 6 x 96, 640 = 5 x 128, 768 = 6 x 128, 896 = 7 x
//     128, 1024 = 8 x 128, within the portable cluster size of 8. 704, 832
//     and 960 split no such way and run the next of these (ops.py pads
//     them: 9%, 8% and 7% more work); above 1024, flash_attention_wide.cu.
//   * Each rank pulls all N partials a step, N - 1 of them remote (at N = 4
//     and DH = 128: 12 KB a step forward, 24 KB backward), issuing the
//     loads of several ranks at once (xch_sum). A reduce-scatter (each rank
//     sums 1 / N of the tile, then all read the sums) would move less but
//     wait for two barriers and two remote round trips a step; the pull
//     waits for one barrier and one or two round trips (N in dk/dv, whose
//     registers are full). The exchange is still the cost of a rank: per
//     step the N = 4 backward takes about 1.1x the pair's time at D = 256,
//     and ranks of 64 columns at D = 512 (8 of them, two blocks an SM)
//     took 1.74x the time of 4 ranks of 128 on an H100 (PERF.md), so
//     split_of takes the widest DH.
// The prep's hi copy stays in f32: reading the raw f32 as hi would truncate
// it (wgmma's tf32 read drops the low 13 bits), a split the emulation in
// tests/test_torch_kernels.py does not cover.
#pragma once

#include <type_traits>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

constexpr int kRows = 64;     // rows of a block's fixed operand (one warpgroup)
constexpr int kBN = 16;       // rows of each streamed tile
constexpr int kThreads = 128;
constexpr int kMaxCluster = 8;   // the portable thread block cluster size

// Tile sizes of a block that owns D columns of the head dim.
template <int D>
struct Geo {
  static_assert(D == 32 || D == 64 || D == 96 || D == 128, "head-dim columns of a block");
  static constexpr int NC = D / 32;             // 128-byte boxes across D
  static constexpr int FIX = kRows * D * 4;     // one part (hi or lo) of a fixed operand
  static constexpr int STR = kBN * D * 4;       // one part of a streamed K-major tile
  static constexpr int TR = D * kBN * 4;        // one part of a streamed transposed tile
};

// How a built head dim D is split: n blocks take one (rows, head) tile, each
// the dh = D / n columns of its cluster rank: one block up to D = 128, a
// pair at 192 (dh 96) and 256 (dh 128), above 256 n ranks of dh 128, else
// 96, else 64 columns, n <= kMaxCluster; {0, 0} for a D no cluster takes.
struct SplitDH {
  int n, dh;
};

__host__ __device__ constexpr SplitDH split_of(int D) {
  if (D <= 128) return {1, D};
  if (D <= 256) return {2, D / 2};
  const int dhs[3] = {128, 96, 64};
  for (int dh : dhs)
    if (D % dh == 0 && D / dh <= kMaxCluster) return {D / dh, dh};
  return {0, 0};
}

// NC, a body's cluster kind: 1 one block a tile, 2 a pair (__cluster_dims__),
// 0 a cluster of N ranks whose size is set at launch.
template <int NC>
__device__ __forceinline__ uint32_t ranks() {
  if constexpr (NC == 0) return sm90::cluster_nranks();
  return NC;
}

template <int NC>
__device__ __forceinline__ uint32_t rank_of() {
  if constexpr (NC == 1) return 0;
  return sm90::cluster_rank();
}

// bf16 operands: one TF32 product (hi copies only); f32: three.
template <typename T>
constexpr bool kOneOf = std::is_same_v<T, __nv_bfloat16>;

__host__ __device__ constexpr int round16(int s) { return (s + 15) / 16 * 16; }

// ---- prep: hi/lo copies, as stored and transposed ----------------------------

// One operand x [B, S, heads, Dt] of the prep launch (Dt <= D, the built
// head dim of the copies), f32 or bf16 (the launch's T). hi/lo (as stored,
// [B, S, heads, D]) and thi/tlo (transposed, [B, heads, D, S_pad]) are
// written when non-null (lo and tlo null for bf16, whose values are exact
// in tf32), columns Dt .. D - 1 as zeros; with `dot` ([B, S, heads, Dt], T),
// delta[b, head, s] = sum_d x * dot in f32.
struct PrepOp {
  const void* src;
  const void* dot;
  float *hi, *lo, *thi, *tlo, *delta;
  int S, heads, blocks;   // blocks = ceil(S / 32) * heads * B
};

struct PrepArgs {
  PrepOp op[4];
  int n_ops, B, D, Dt;
};

constexpr int kPrepThreads = 256;
constexpr int kPrepRows = 32;
constexpr int kPrepCols = 256;   // head-dim columns a block stages at a time
constexpr int kPrepWarpRows = kPrepRows / (kPrepThreads / 32);

__device__ __forceinline__ float tf32_hi(float x) { return __uint_as_float(sm90::tf32_bits(x)); }

// kPerm[s] = {0,2,4,6,1,3,5,7}[s]: the row stored at position s of a group of 8
__device__ __forceinline__ int k_perm(int s) { return ((s & 3) << 1) | (s >> 2); }

// Columns c and c + 1 of an output row of Dt elements (Dt <= the built head
// dim; columns from Dt on are the padding's and are not stored): one store
// of both where Dt is even (the row and c then aligned to it), else each
// column. bf16 rounds to nearest even, once.
__device__ __forceinline__ void store_cols(float* row, int c, int Dt, float x, float y) {
  if (Dt % 2 == 0) {
    if (c < Dt) *reinterpret_cast<float2*>(row + c) = make_float2(x, y);
  } else {
    if (c < Dt) row[c] = x;
    if (c + 1 < Dt) row[c + 1] = y;
  }
}

__device__ __forceinline__ void store_cols(__nv_bfloat16* row, int c, int Dt, float x, float y) {
  if (Dt % 2 == 0) {
    if (c < Dt) *reinterpret_cast<__nv_bfloat162*>(row + c) = __floats2bfloat162_rn(x, y);
  } else {
    if (c < Dt) row[c] = __float2bfloat16(x);
    if (c + 1 < Dt) row[c + 1] = __float2bfloat16(y);
  }
}

// One block: 32 rows of one head of one operand, all D columns (zeros from
// Dt on: the padding of a head dim the kernels are not built for), staged
// kPrepCols columns at a time. Each lane sums delta over its columns in one
// chain across the stages, in the order of a single stage.
template <typename T>
__device__ __forceinline__ void prep_body(const PrepArgs& a) {
  extern __shared__ float tile[];   // [32][min(D, kPrepCols) + 1]
  int blk = blockIdx.x, i = 0;
  while (i + 1 < a.n_ops && blk >= a.op[i].blocks) blk -= a.op[i++].blocks;
  const PrepOp& p = a.op[i];
  const T* src = static_cast<const T*>(p.src);
  const int D = a.D, Dt = a.Dt, S = p.S, heads = p.heads, S_pad = round16(S);
  const int n_st = (S + kPrepRows - 1) / kPrepRows;
  const int st = blk % n_st, head = (blk / n_st) % heads, b = blk / n_st / heads;
  const int s0 = st * kPrepRows;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  float acc[kPrepWarpRows];   // delta of rows warp + 8 j
#pragma unroll
  for (int j = 0; j < kPrepWarpRows; ++j) acc[j] = 0.f;
  for (int cb = 0; cb < D; cb += kPrepCols) {
    const int W = min(kPrepCols, D - cb), LD = W + 1;
    if (cb > 0) __syncthreads();   // every thread is done with the last stage
    for (int e = tid; e < kPrepRows * W; e += kPrepThreads) {
      const int r = e / W, d = cb + e % W, s = s0 + r;
      const size_t row = (static_cast<size_t>(b) * S + s) * heads + head;
      const size_t g = row * D + d;
      const float x = s < S && d < Dt ? to_float(src[row * Dt + d]) : 0.f;
      tile[r * LD + d - cb] = x;
      if (p.hi != nullptr && s < S) {
        const float hi = tf32_hi(x);
        p.hi[g] = hi;
        if (p.lo != nullptr) p.lo[g] = tf32_hi(x - hi);
      }
    }
    __syncthreads();
    if (p.thi != nullptr) {
      for (int e = tid; e < kPrepRows * W; e += kPrepThreads) {
        const int d = cb + e / kPrepRows, c = e % kPrepRows, s = s0 + c;
        if (s >= S_pad) continue;
        const float x = tile[((c & ~7) | k_perm(c & 7)) * LD + d - cb];
        const size_t g = ((static_cast<size_t>(b) * heads + head) * D + d) * S_pad + s;
        const float hi = tf32_hi(x);
        p.thi[g] = hi;
        if (p.tlo != nullptr) p.tlo[g] = tf32_hi(x - hi);
      }
    }
    if (p.dot != nullptr) {
      const int d_end = min(cb + W, Dt);
#pragma unroll
      for (int j = 0; j < kPrepWarpRows; ++j) {
        const int r = warp + 8 * j, s = s0 + r;
        if (s >= S) break;
        const T* o = static_cast<const T*>(p.dot) +
                     ((static_cast<size_t>(b) * S + s) * heads + head) * Dt;
        for (int d = cb + lane; d < d_end; d += 32)
          acc[j] = fmaf(tile[r * LD + d - cb], to_float(o[d]), acc[j]);
      }
    }
  }
  if (p.dot != nullptr) {
#pragma unroll
    for (int j = 0; j < kPrepWarpRows; ++j) {
      const int s = s0 + warp + 8 * j;
      if (s >= S) break;
      const float sum = warp_sum(acc[j]);
      if (lane == 0) p.delta[(static_cast<size_t>(b) * heads + head) * S + s] = sum;
    }
  }
}

// Two names, so a profile tells the forward's prep from the backward's.
template <typename T>
__global__ void __launch_bounds__(kPrepThreads) flash_f32tc_fwd_prep_kernel(const PrepArgs a) {
  prep_body<T>(a);
}

template <typename T>
__global__ void __launch_bounds__(kPrepThreads) flash_f32tc_bwd_prep_kernel(const PrepArgs a) {
  prep_body<T>(a);
}

// ---- tiles and descriptors -----------------------------------------------------

// Rows [row0, row0 + R) of one head of a K-major copy, columns [c0, c0 + D):
// NC boxes of 32 columns, box c at dst + c * R * 128, each row 128 bytes in
// the 128-byte swizzle.
template <int D, int R>
__device__ __forceinline__ void load_kmajor(char* dst, const CUtensorMap* map, uint64_t* bar,
                                            int head, int row0, int b, int c0) {
#pragma unroll
  for (int c = 0; c < Geo<D>::NC; ++c)
    sm90::tma_load_4d(dst + c * R * 128, map, bar, c0 + c * 32, head, row0, b);
}

// Positions [pos0, pos0 + 16) of one head of a transposed copy, head-dim rows
// [c0, c0 + the map's box): rows of 64 bytes in the 64-byte swizzle.
__device__ __forceinline__ void load_trans(char* dst, const CUtensorMap* map, uint64_t* bar,
                                           int head, int pos0, int b, int c0) {
  sm90::tma_load_4d(dst, map, bar, pos0, c0, head, b);
}

// Descriptors: K-major tiles of R rows (8-row groups 1024 bytes apart; k step
// kk of 8 columns is box kk / 4, 32 (kk % 4) bytes into each row), and
// transposed tiles (8-row groups 512 bytes apart; k step kk at 32 kk bytes).
__device__ __forceinline__ uint64_t kmajor_desc(const char* t) {
  return sm90::smem_desc(t, 16, 1024, 128);
}
__device__ __forceinline__ uint64_t trans_desc(const char* t) {
  return sm90::smem_desc(t, 16, 512, 64);
}
template <int R>
__device__ __forceinline__ uint64_t kmajor_step(int kk) {
  return static_cast<uint64_t>(((kk / 4) * R * 128 + (kk % 4) * 32) >> 4);
}
__device__ __forceinline__ uint64_t trans_step(int kk) {
  return static_cast<uint64_t>((kk * 32) >> 4);
}

// s[64 x 16] = X Y^T over D, three tf32 products a k step (lo.hi, hi.lo,
// hi.hi), or with kOne hi.hi alone, as one commit group; x*, y*: descriptors
// of the hi and lo parts.
template <int D, bool kOne>
__device__ __forceinline__ void score_product(float (&s)[8], uint64_t xhi, uint64_t xlo,
                                              uint64_t yhi, uint64_t ylo) {
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const uint64_t ox = kmajor_step<kRows>(kk), oy = kmajor_step<kBN>(kk);
    if constexpr (!kOne) {
      sm90::wgmma_tf32_ss<16>(s, xlo + ox, yhi + oy, kk > 0);
      sm90::wgmma_tf32_ss<16>(s, xhi + ox, ylo + oy, 1);
    }
    sm90::wgmma_tf32_ss<16>(s, xhi + ox, yhi + oy, kOne ? kk > 0 : 1);
  }
  sm90::wgmma_commit();
}

// The hi and lo A fragments of a [64 x 16] accumulator, k step j = columns
// 8 j .. 8 j + 7: a[0..3] = (row r, col 2c), (r + 8, 2c), (r, 2c + 1),
// (r + 8, 2c + 1), i.e. k slots c and c + 4 (kPerm). kOne: hi alone.
template <bool kOne>
__device__ __forceinline__ void split_fragments(const float (&p)[8], uint32_t (&hi)[2][4],
                                                uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float v[4] = {p[4 * j], p[4 * j + 2], p[4 * j + 1], p[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[j][e] = sm90::tf32_bits(v[e]);
      if constexpr (!kOne) lo[j][e] = sm90::tf32_bits(v[e] - __uint_as_float(hi[j][e]));
    }
  }
}

// part[64 x D] = A [64 x 16] T, A from registers (hi/lo fragments), T the
// transposed tile [D x 16] (its hi and lo parts), as one commit group; kOne:
// hi.hi alone. The caller adds the part to its running sum in registers
// (round to nearest). Summed in place in the wgmma accumulator over
// thousands of steps instead, dk at the train shape was up to 3.5e-5 of its
// max off the plain version on an H100 (2e-5 is the tolerance), as if each
// accumulator update rounded toward zero; with the part added in registers
// it is 4.4e-6.
template <int D, bool kOne>
__device__ __forceinline__ void part_product(float (&part)[D / 2], const uint32_t (&ahi)[2][4],
                                             const uint32_t (&alo)[2][4], uint64_t thi,
                                             uint64_t tlo) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    if constexpr (!kOne) {
      sm90::wgmma_tf32_rs<D>(part, alo[kk], thi + trans_step(kk), kk > 0);
      sm90::wgmma_tf32_rs<D>(part, ahi[kk], tlo + trans_step(kk), 1);
    }
    sm90::wgmma_tf32_rs<D>(part, ahi[kk], thi + trans_step(kk), kOne ? kk > 0 : 1);
  }
  sm90::wgmma_commit();
}

// The tensor maps of one operand's hi and lo copies (lo = hi where the
// operand has no lo copy: bf16).
struct MapPair {
  CUtensorMap hi, lo;
};

// ---- the exchange of a cluster's partial scores -----------------------------------

// Each rank sums its DH columns of the head dim into every score element (F
// of them a thread: s, and dp in the backward), puts its partial sums into
// a stage of its shared memory (stage i % 2 at step i: a peer may still read
// stage i - 1), and after the cluster barrier forms the sum from the same
// offset of every rank's stage. Laid out as float4 slots [slot][kThreads],
// so a warp's 16-byte accesses do not conflict.
template <int F>
__device__ __forceinline__ void xch_put(float* stage, int slot, const float (&x)[F]) {
  float4* dst = reinterpret_cast<float4*>(stage) + slot * kThreads + threadIdx.x;
#pragma unroll
  for (int i = 0; i < F / 4; ++i)
    dst[i * kThreads] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
}

// A pair: x (this rank's partial) += the peer's. fl(a + b) = fl(b + a), so
// both ranks hold the bits of (rank 0's) + (rank 1's).
template <int F>
__device__ __forceinline__ void xch_add(const float* stage, int slot, uint32_t peer,
                                        float (&x)[F]) {
  const uint32_t src = sm90::cluster_addr(
      reinterpret_cast<const float4*>(stage) + slot * kThreads + threadIdx.x, peer);
#pragma unroll
  for (int i = 0; i < F / 4; ++i) {
    const float4 v = sm90::ld_cluster_v4(src + i * kThreads * 16);
    x[4 * i] += v.x;
    x[4 * i + 1] += v.y;
    x[4 * i + 2] += v.z;
    x[4 * i + 3] += v.w;
  }
}

// N ranks: x = ((p_0 + p_1) + p_2) + ... + p_{n-1}, every partial read from
// its rank's stage (this rank's own among them, at its place in the order),
// so every rank forms the same sum in the same order: the same bits. The
// loads of G ranks at a time are issued together (G F registers, which the
// products' part frees while the scores are summed), so a step waits for
// ceil(N / G) remote round trips, not N: G F = 64 in the forward and dq;
// in dk/dv, whose dk and dv sums leave no more, G = 1 (at G F = 32 or 64
// its 128-column ranks spill).
template <int G, int F>
__device__ __forceinline__ void xch_sum(const float* stage, int slot, uint32_t n,
                                        float (&x)[F]) {
  const float4* mine = reinterpret_cast<const float4*>(stage) + slot * kThreads + threadIdx.x;
#pragma unroll 1
  for (uint32_t r0 = 0; r0 < n; r0 += G) {
    float4 v[G][F / 4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (r0 + g < n) {
        const uint32_t src = sm90::cluster_addr(mine, r0 + g);
#pragma unroll
        for (int i = 0; i < F / 4; ++i) v[g][i] = sm90::ld_cluster_v4(src + i * kThreads * 16);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (r0 + g >= n) break;
      const bool first = r0 + g == 0;
#pragma unroll
      for (int i = 0; i < F / 4; ++i) {
        x[4 * i] = first ? v[g][i].x : x[4 * i] + v[g][i].x;
        x[4 * i + 1] = first ? v[g][i].y : x[4 * i + 1] + v[g][i].y;
        x[4 * i + 2] = first ? v[g][i].z : x[4 * i + 2] + v[g][i].z;
        x[4 * i + 3] = first ? v[g][i].w : x[4 * i + 3] + v[g][i].w;
      }
    }
  }
}

__device__ __forceinline__ void cluster_sync() {
  sm90::cluster_arrive_release();
  sm90::cluster_wait();
}

// Bytes of a block's two exchange stages of F floats a thread (none alone).
template <int NC, int F>
__host__ __device__ constexpr int xch_bytes() {
  return NC != 1 ? 2 * kThreads * F * 4 : 0;
}

// ---- forward -----------------------------------------------------------------

struct FwdMaps {
  MapPair q, k, vt;   // Q and K as stored, V transposed
};

// Dynamic shared memory of a forward block of DH columns.
template <int DH, int NC>
constexpr int fwd_smem() {
  using G = Geo<DH>;
  return 1024 + 2 * G::FIX + 2 * G::STR + 2 * G::TR + xch_bytes<NC, 8>() + 64;
}

// The forward of one (64 q rows, head, batch) tile, or of the DH head-dim
// columns of its cluster rank (NC != 1; see split_of). o's rows hold Dt <= D
// columns (D - Dt: the padding's zero columns, not stored); scale is
// 1 / sqrt(Dt).
template <int DH, int NC, typename T, bool kCap>
__device__ __forceinline__ void fwd_body(const FwdMaps& m, T* __restrict__ o,
                                         float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                                         int causal, int window, float softcap, float scale,
                                         int Dt) {
  constexpr bool kOne = kOneOf<T>;
  using G = Geo<DH>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern follows address bits: tiles start 1024-byte aligned
  char* sQ = sm90::align1024(smem_raw);
  char* sK = sQ + 2 * G::FIX;    // hi, then lo
  char* sV = sK + 2 * G::STR;    // V^T: hi, then lo
  float* sX = reinterpret_cast<float*>(sV + 2 * G::TR);   // the cluster's exchange stages
  uint64_t* bar = reinterpret_cast<uint64_t*>(sV + 2 * G::TR + xch_bytes<NC, 8>());   // Q, K, V

  const uint32_t n = ranks<NC>(), rank = rank_of<NC>();
  const int c0 = rank * DH;   // the block's first head-dim column
  const int h = blockIdx.x / n, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // heaviest q tile first
  const int kvh = h / (H / KV);
  // k tiles that hold a kept key for some row of this block
  const int q_last = min(q0 + kRows, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / kBN;
  const int n_tiles = max(0, (k_end + kBN - 1) / kBN - t_begin);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  constexpr int kParts = kOne ? 1 : 2;   // hi (and lo) of each operand

  auto load_k = [&](int i) {
    sm90::mbar_arrive_expect_tx(&bar[1], kParts * G::STR);
    load_kmajor<DH, kBN>(sK, &m.k.hi, &bar[1], kvh, (t_begin + i) * kBN, b, c0);
    if constexpr (!kOne)
      load_kmajor<DH, kBN>(sK + G::STR, &m.k.lo, &bar[1], kvh, (t_begin + i) * kBN, b, c0);
  };
  auto load_v = [&](int i) {
    sm90::mbar_arrive_expect_tx(&bar[2], kParts * G::TR);
    load_trans(sV, &m.vt.hi, &bar[2], kvh, (t_begin + i) * kBN, b, c0);
    if constexpr (!kOne) load_trans(sV + G::TR, &m.vt.lo, &bar[2], kvh, (t_begin + i) * kBN, b, c0);
  };
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_barrier_init();
    sm90::mbar_arrive_expect_tx(&bar[0], kParts * G::FIX);
    load_kmajor<DH, kRows>(sQ, &m.q.hi, &bar[0], h, q0, b, c0);
    if constexpr (!kOne) load_kmajor<DH, kRows>(sQ + G::FIX, &m.q.lo, &bar[0], h, q0, b, c0);
    if (n_tiles > 0) {
      load_k(0);
      load_v(0);
    }
  }
  __syncthreads();

  const int qpos0 = q0 + warp * 16 + lane / 4, qpos1 = qpos0 + 8;   // this thread's rows
  const int col = 2 * (lane % 4);   // its first column in each group of 8
  const float c = scale * kLog2e;
  const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
  const float cap_out = softcap > 0.f ? softcap / scale : 0.f;
  const uint64_t qhi = kmajor_desc(sQ), qlo = kmajor_desc(sQ + G::FIX);
  const uint64_t khi = kmajor_desc(sK), klo = kmajor_desc(sK + G::STR);
  const uint64_t vhi = trans_desc(sV), vlo = trans_desc(sV + G::TR);

  float acc[DH / 2], part[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows qpos0, qpos1 (raw units)
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the running sums

  sm90::mbar_wait(&bar[0], 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int k0 = (t_begin + i) * kBN;
    const uint32_t parity = i & 1;
    float s[8];
    sm90::mbar_wait(&bar[1], parity);
    sm90::wgmma_fence();
    score_product<DH, kOne>(s, qhi, qlo, khi, klo);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    [[maybe_unused]] float* stage = sX + (i & 1) * kThreads * 8;
    if constexpr (NC != 1) {   // the barrier also orders every warp's use of this K tile
      xch_put(stage, 0, s);
      cluster_sync();
    } else {
      __syncthreads();   // every warp is done with this K tile
    }
    if (tid == 0 && i + 1 < n_tiles) load_k(i + 1);
    if constexpr (NC == 2) xch_add(stage, 0, rank ^ 1, s);
    else if constexpr (NC == 0) xch_sum<8>(stage, 0, n, s);

    // online softmax in the registers of the S fragment: s[4 j + e] is row
    // qpos0 (e < 2) or qpos1, column k0 + 8 j + col + (e & 1)
    const bool edge = k0 + kBN > Sk ||
                      (causal && (k0 + kBN - 1 > q0 || (window > 0 && k0 <= q_last - window)));
    const RowKeys r0(qpos0, k0, col, Sk, causal, window), r1(qpos1, k0, col, Sk, causal, window);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e];
        // softcap * tanh(x * scale / softcap), kept in raw units
        if constexpr (kCap) x = cap_out * tanhf(x * cap_in);
        const RowKeys& r = e < 2 ? r0 : r1;
        const int rel = 8 * j + (e & 1);
        if (edge && (rel < r.lo || rel > r.hi)) x = -INFINITY;
        s[4 * j + e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    // the four lanes of a row hold all its columns
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = exp2f((m0 - mx0) * c), alpha1 = exp2f((m1 - mx1) * c);
    m0 = mx0;
    m1 = mx1;
    const float b0 = m0 * c, b1 = m1 * c;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      s[4 * j] = exp2f(fmaf(s[4 * j], c, -b0));
      s[4 * j + 1] = exp2f(fmaf(s[4 * j + 1], c, -b0));
      s[4 * j + 2] = exp2f(fmaf(s[4 * j + 2], c, -b1));
      s[4 * j + 3] = exp2f(fmaf(s[4 * j + 3], c, -b1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    uint32_t phi[2][4], plo[2][4];
    split_fragments<kOne>(s, phi, plo);

    sm90::mbar_wait(&bar[2], parity);
    sm90::wgmma_fence();
    part_product<DH, kOne>(part, phi, plo, vhi, vlo);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(part);
    __syncthreads();   // every warp is done with this V^T tile
    if (tid == 0 && i + 1 < n_tiles) load_v(i + 1);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {   // o = o * alpha + P V, one rounding
      acc[4 * j] = fmaf(acc[4 * j], alpha0, part[4 * j]);
      acc[4 * j + 1] = fmaf(acc[4 * j + 1], alpha0, part[4 * j + 1]);
      acc[4 * j + 2] = fmaf(acc[4 * j + 2], alpha1, part[4 * j + 2]);
      acc[4 * j + 3] = fmaf(acc[4 * j + 3], alpha1, part[4 * j + 3]);
    }
  }
  if constexpr (NC != 1) sm90::cluster_arrive_release();   // done reading the peers' stages

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  // lse from rank 0 only: every rank of a cluster holds the same m and l
  const bool write_lse = lse != nullptr && lane % 4 == 0 && rank == 0;
  if (qpos0 < Sq) {
    T* dst = o + ((static_cast<size_t>(b) * Sq + qpos0) * H + h) * Dt;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      store_cols(dst, c0 + col + 8 * j, Dt, acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (write_lse)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qpos0] =
          l0 == 0.f ? INFINITY : m0 * scale + logf(l0);
  }
  if (qpos1 < Sq) {
    T* dst = o + ((static_cast<size_t>(b) * Sq + qpos1) * H + h) * Dt;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      store_cols(dst, c0 + col + 8 * j, Dt, acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    if (write_lse)
      lse[(static_cast<size_t>(b) * H + h) * Sq + qpos1] =
          l1 == 0.f ? INFINITY : m1 * scale + logf(l1);
  }
  if constexpr (NC != 1) sm90::cluster_wait();   // the peers are done reading ours: exit
}

#define REPRO_F32TC_FWD_ARGS(T)                                                        \
  const __grid_constant__ FwdMaps m, T* __restrict__ o, float* __restrict__ lse, int Sq, \
      int Sk, int H, int KV, int causal, int window, float softcap, float scale, int Dt
#define REPRO_F32TC_FWD_CALL m, o, lse, Sq, Sk, H, KV, causal, window, softcap, scale, Dt

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 2) flash_f32tc_fwd_kernel(REPRO_F32TC_FWD_ARGS(float)) {
  fwd_body<D, 1, float, kCap>(REPRO_F32TC_FWD_CALL);
}

// D = 192 and 256: a cluster of two blocks a tile, one per half of the head dim.
template <bool kCap>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 2)
flash_f32tc_fwd_d192_kernel(REPRO_F32TC_FWD_ARGS(float)) {
  fwd_body<96, 2, float, kCap>(REPRO_F32TC_FWD_CALL);
}

template <bool kCap>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 2)
flash_f32tc_fwd_d256_kernel(REPRO_F32TC_FWD_ARGS(float)) {
  fwd_body<128, 2, float, kCap>(REPRO_F32TC_FWD_CALL);
}

// Above 256: a cluster of N ranks of DH columns, N set at launch.
template <int DH, typename T, bool kCap>
__global__ void __launch_bounds__(kThreads, 2)
flash_f32tc_fwd_cluster_kernel(REPRO_F32TC_FWD_ARGS(T)) {
  fwd_body<DH, 0, T, kCap>(REPRO_F32TC_FWD_CALL);
}
#undef REPRO_F32TC_FWD_ARGS
#undef REPRO_F32TC_FWD_CALL

// ---- backward ----------------------------------------------------------------

// dk/dv: x1 = K, x2 = V (the block's 64 keys); y1 = Q, y2 = dO (16 queries
// a step); t1 = dO^T (into dV), t2 = Q^T (into dK).
// dq:    x1 = Q, x2 = dO (the block's 64 queries); y1 = K, y2 = V (16 keys
// a step); t1 = K^T (into dQ); t2 unused.
struct BwdMaps {
  MapPair x1, x2, y1, y2, t1, t2;
};

// The backward's rings of streamed tiles: NY stages of the K-major part
// (y1, y2 hi/lo), NT of the transposed part (t1 and, in dk/dv, t2), each
// refilled NY / NT steps ahead: dk/dv one K-major stage, dq two (its next
// scores' tiles then load during this step's products), and two transposed
// ones where 227 KB hold them. At D = 128 they do; a rank of 128 columns in
// a cluster holds its copies and its exchange stages (s and dp), which leave
// room for one transposed stage; at 96 columns two. On the cluster route,
// where a rank's copies and one stage of each part fit in half an SM's
// shared memory (one product, kOne: bf16, which has no lo parts, and f32
// ranks of 64 columns), a second block takes the other half (its 255
// registers a thread at most still fit twice): the stages are those that
// fit in the half, with no alignment slack (the dynamic shared memory
// starts 1024-byte aligned; a block that finds it not so traps).
template <int DH, int NC, bool kDQ, bool kOne = false>
struct BwdRing {
  static constexpr int P = kOne ? 1 : 2;                            // hi (and lo)
  static constexpr int X_BYTES = 2 * P * Geo<DH>::FIX;              // x1, x2
  static constexpr int Y_BYTES = 2 * P * Geo<DH>::STR;              // one stage
  static constexpr int T_BYTES = (kDQ ? 1 : 2) * P * Geo<DH>::TR;   // one stage
  static constexpr int XCH = xch_bytes<NC, 16>();
  static constexpr int HALF = (233472 - 2 * 1024) / 2;   // of an SM, less its reserve
  static constexpr bool kTwo = NC == 0 && X_BYTES + XCH + 64 + Y_BYTES + T_BYTES <= HALF;
  static constexpr int SLACK = kTwo ? 0 : 1024;                     // to align the tiles
  static constexpr int BUDGET = kTwo ? HALF : 232448;               // a block's
  static constexpr int BASE = SLACK + X_BYTES + XCH + 64;
  static constexpr int NY = kDQ && BASE + 2 * Y_BYTES + T_BYTES <= BUDGET ? 2 : 1;
  static constexpr int FIXED = BASE + NY * Y_BYTES;
  static constexpr int NT = FIXED + 2 * T_BYTES <= BUDGET ? 2 : 1;
  static constexpr int SMEM = FIXED + NT * T_BYTES;
  static_assert(SMEM <= BUDGET, "tiles exceed a block's shared memory");
  static_assert(1 + NY + NT <= 8, "barriers");
};

// The dk/dv (kDQ false) or dq (kDQ true) launch; see BwdMaps. With NC != 1
// one rank of a cluster, for the DH head-dim columns of its rank. The
// outputs' rows hold Dt <= D columns (as fwd_body's o).
template <int DH, int NC, typename T, bool kDQ, bool kCap>
__device__ __forceinline__ void bwd_body(const BwdMaps& m, const float* __restrict__ lse,
                                         const float* __restrict__ delta,
                                         T* __restrict__ out1, T* __restrict__ out2,
                                         int Sq, int Sk, int H, int KV, int causal, int window,
                                         float softcap, float scale, int Dt) {
  constexpr bool kOne = kOneOf<T>;
  using G = Geo<DH>;
  using R = BwdRing<DH, NC, kDQ, kOne>;
  constexpr int P = R::P;   // hi and lo of each operand, or hi alone
  extern __shared__ uint8_t smem_raw[];
  char* sX = sm90::align1024(smem_raw);
  if constexpr (R::SLACK == 0) {
    if (sX != reinterpret_cast<char*>(smem_raw)) __trap();   // no room to align
  }
  char* sY = sX + R::X_BYTES;          // x1 hi, (x1 lo,) x2 hi, (x2 lo)
  char* sT = sY + R::NY * R::Y_BYTES;  // stage s: y1 hi, (y1 lo,) y2 hi, (y2 lo)
  float* sE = reinterpret_cast<float*>(sT + R::NT * R::T_BYTES);   // the cluster's exchange
  uint64_t* bar = reinterpret_cast<uint64_t*>(sT + R::NT * R::T_BYTES + R::XCH);
  uint64_t* bar_y = bar + 1;           // bar[0]: X; then the Y and T stages
  uint64_t* bar_t = bar_y + R::NY;     // stage s: t1 hi, t1 lo (, t2 hi, t2 lo)

  const uint32_t n = ranks<NC>(), rank = rank_of<NC>();
  const int c0 = rank * DH;   // the block's first head-dim column
  const int b = blockIdx.y, group = H / KV;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // the block's rows, the heads it reads, and the steps it takes
  int x0, xhead, s_begin, n_steps, nq = 1;
  if constexpr (kDQ) {
    const int h = blockIdx.x / n;
    x0 = (gridDim.z - 1 - blockIdx.z) * kRows;   // heaviest q tile first
    xhead = h;
    const int q_last = min(x0 + kRows, Sq) - 1;
    const int k_end = causal ? min(Sk, q_last + 1) : Sk;
    const int k_begin = (causal && window > 0) ? max(0, x0 - window + 1) : 0;
    s_begin = k_begin / kBN;
    n_steps = max(0, (k_end + kBN - 1) / kBN - s_begin);
  } else {
    xhead = blockIdx.x / n;    // kv head
    x0 = blockIdx.z * kRows;   // k tile 0, the heaviest, first
    const int k_last = min(x0 + kRows, Sk) - 1;
    const int q_begin = causal ? x0 : 0;
    const int q_end = (causal && window > 0) ? min(Sq, k_last + window) : Sq;
    s_begin = q_begin / kBN;
    nq = max(0, (q_end + kBN - 1) / kBN - s_begin);
    n_steps = group * nq;   // the group's q heads in order, each over its q tiles
  }
  // step i: the streamed rows and their head
  auto step_rows = [&](int i, int& pos0, int& head) {
    if constexpr (kDQ) {
      pos0 = (s_begin + i) * kBN;
      head = xhead / group;
    } else {
      pos0 = (s_begin + i % nq) * kBN;
      head = xhead * group + i / nq;
    }
  };
  auto load_y = [&](int i) {
    int pos0, head;
    step_rows(i, pos0, head);
    char* dst = sY + (i % R::NY) * R::Y_BYTES;
    uint64_t* full = &bar_y[i % R::NY];
    sm90::mbar_arrive_expect_tx(full, R::Y_BYTES);
    load_kmajor<DH, kBN>(dst, &m.y1.hi, full, head, pos0, b, c0);
    if constexpr (!kOne) load_kmajor<DH, kBN>(dst + G::STR, &m.y1.lo, full, head, pos0, b, c0);
    load_kmajor<DH, kBN>(dst + P * G::STR, &m.y2.hi, full, head, pos0, b, c0);
    if constexpr (!kOne) load_kmajor<DH, kBN>(dst + 3 * G::STR, &m.y2.lo, full, head, pos0, b, c0);
  };
  auto load_t = [&](int i) {
    int pos0, head;
    step_rows(i, pos0, head);
    char* dst = sT + (i % R::NT) * R::T_BYTES;
    uint64_t* full = &bar_t[i % R::NT];
    sm90::mbar_arrive_expect_tx(full, R::T_BYTES);
    load_trans(dst, &m.t1.hi, full, head, pos0, b, c0);
    if constexpr (!kOne) load_trans(dst + G::TR, &m.t1.lo, full, head, pos0, b, c0);
    if constexpr (!kDQ) {
      load_trans(dst + P * G::TR, &m.t2.hi, full, head, pos0, b, c0);
      if constexpr (!kOne) load_trans(dst + 3 * G::TR, &m.t2.lo, full, head, pos0, b, c0);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + R::NY + R::NT; ++i) sm90::mbar_init(&bar[i], 1);
    sm90::fence_barrier_init();
    sm90::mbar_arrive_expect_tx(&bar[0], R::X_BYTES);
    load_kmajor<DH, kRows>(sX, &m.x1.hi, &bar[0], xhead, x0, b, c0);
    if constexpr (!kOne) load_kmajor<DH, kRows>(sX + G::FIX, &m.x1.lo, &bar[0], xhead, x0, b, c0);
    load_kmajor<DH, kRows>(sX + P * G::FIX, &m.x2.hi, &bar[0], xhead, x0, b, c0);
    if constexpr (!kOne)
      load_kmajor<DH, kRows>(sX + 3 * G::FIX, &m.x2.lo, &bar[0], xhead, x0, b, c0);
    for (int i = 0; i < R::NY && i < n_steps; ++i) load_y(i);
    for (int i = 0; i < R::NT && i < n_steps; ++i) load_t(i);
  }
  __syncthreads();

  // this thread's rows of the block and its first column in each group of 8
  const int row0 = x0 + warp * 16 + lane / 4, row1 = row0 + 8;
  const int col = 2 * (lane % 4);
  // (the lo descriptors are not used with one product)
  const uint64_t x1hi = kmajor_desc(sX), x1lo = kmajor_desc(sX + G::FIX);
  const uint64_t x2hi = kmajor_desc(sX + P * G::FIX), x2lo = kmajor_desc(sX + 3 * G::FIX);
  // descriptors of stage 0; stage s is s * Y_BYTES (T_BYTES) further
  const uint64_t y1hi = kmajor_desc(sY), y1lo = kmajor_desc(sY + G::STR);
  const uint64_t y2hi = kmajor_desc(sY + P * G::STR), y2lo = kmajor_desc(sY + 3 * G::STR);
  const uint64_t t1hi = trans_desc(sT), t1lo = trans_desc(sT + G::TR);
  const uint64_t t2hi = trans_desc(sT + P * G::TR), t2lo = trans_desc(sT + 3 * G::TR);

  float acc1[DH / 2], acc2[kDQ ? 1 : DH / 2], part[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc1[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kDQ ? 1 : DH / 2); ++i) acc2[i] = 0.f;
  // dq: lse and delta of this thread's two rows, read once
  float row_lse[2] = {0.f, 0.f}, row_delta[2] = {0.f, 0.f};
  if constexpr (kDQ) {
    const int rows[2] = {row0, row1};
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (rows[e] < Sq) {
        const size_t g = (static_cast<size_t>(b) * H + xhead) * Sq + rows[e];
        row_lse[e] = lse[g];
        row_delta[e] = delta[g];
      }
  }

  sm90::mbar_wait(&bar[0], 0);
  for (int i = 0; i < n_steps; ++i) {
    int pos0, head;
    step_rows(i, pos0, head);
    const int ys = i % R::NY, ts = i % R::NT;
    const uint64_t yoff = static_cast<uint64_t>((ys * R::Y_BYTES) >> 4);
    const uint64_t toff = static_cast<uint64_t>((ts * R::T_BYTES) >> 4);
    // dk/dv: lse and delta of this step's columns (queries pos0 + 8 j + col + e)
    float col_lse[4] = {0.f, 0.f, 0.f, 0.f}, col_delta[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (!kDQ) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qpos = pos0 + 8 * j + col + e;
          if (qpos < Sq) {
            const size_t g = (static_cast<size_t>(b) * H + head) * Sq + qpos;
            col_lse[2 * j + e] = lse[g];
            col_delta[2 * j + e] = delta[g];
          }
        }
    }
    float s[8], dp[8];
    sm90::mbar_wait(&bar_y[ys], (i / R::NY) & 1);
    sm90::wgmma_fence();
    score_product<DH, kOne>(s, x1hi, x1lo, y1hi + yoff, y1lo + yoff);
    score_product<DH, kOne>(dp, x2hi, x2lo, y2hi + yoff, y2lo + yoff);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    [[maybe_unused]] float* stage = sE + (i & 1) * kThreads * 16;
    if constexpr (NC != 1) {   // the barrier also orders every warp's use of the tiles
      xch_put(stage, 0, s);
      xch_put(stage, 2, dp);
      cluster_sync();
    } else {
      __syncthreads();   // every warp is done with this step's K-major tiles
    }
    if (tid == 0 && i + R::NY < n_steps) load_y(i + R::NY);
    if constexpr (NC == 2) {
      xch_add(stage, 0, rank ^ 1, s);
      xch_add(stage, 2, rank ^ 1, dp);
    } else if constexpr (NC == 0) {   // s and dp in one pass: slots 0-1, 2-3
      float sdp[16];
#pragma unroll
      for (int e = 0; e < 8; ++e) sdp[e] = s[e], sdp[8 + e] = dp[e];
      xch_sum<kDQ ? 4 : 1>(stage, 0, n, sdp);
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = sdp[e], dp[e] = sdp[8 + e];
    }

    // s[4 j + e]: row row0 (e < 2) or row1, column pos0 + 8 j + col + (e & 1)
    float p[8], ds[8];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e < 2 ? row0 : row1, cpos = pos0 + 8 * j + col + (e & 1);
        const int qpos = kDQ ? r : cpos, kpos = kDQ ? cpos : r;
        const float l = kDQ ? row_lse[e / 2] : col_lse[2 * j + (e & 1)];
        const float dl = kDQ ? row_delta[e / 2] : col_delta[2 * j + (e & 1)];
        grad_element<kCap>(s[4 * j + e], dp[4 * j + e], l, dl,
                           kept(qpos, kpos, Sq, Sk, causal, window), scale, softcap,
                           p[4 * j + e], ds[4 * j + e]);
      }
    uint32_t ahi[2][4], alo[2][4];
    sm90::mbar_wait(&bar_t[ts], (i / R::NT) & 1);
    if constexpr (!kDQ) {   // dV += P^T dO
      split_fragments<kOne>(p, ahi, alo);
      sm90::wgmma_fence();
      part_product<DH, kOne>(part, ahi, alo, t1hi + toff, t1lo + toff);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(part);
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) acc1[e] += part[e];
    }
    // dq: dQ += dS K; dk/dv: dK += dS^T Q
    split_fragments<kOne>(ds, ahi, alo);
    sm90::wgmma_fence();
    part_product<DH, kOne>(part, ahi, alo, (kDQ ? t1hi : t2hi) + toff,
                           (kDQ ? t1lo : t2lo) + toff);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(part);
    __syncthreads();   // every warp is done with this step's transposed tiles
    if (tid == 0 && i + R::NT < n_steps) load_t(i + R::NT);
    if constexpr (kDQ) {
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) acc1[e] += part[e];
    } else {
#pragma unroll
      for (int e = 0; e < DH / 2; ++e) acc2[e] += part[e];
    }
  }
  if constexpr (NC != 1) sm90::cluster_arrive_release();   // done reading the peers' stages

  // dq: out1 = dq [B,Sq,H,D]; dk/dv: out1 = dv, out2 = dk [B,Sk,KV,D]
  const int S_out = kDQ ? Sq : Sk, heads_out = kDQ ? H : KV;
  const int rows[2] = {row0, row1};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (rows[e] >= S_out) continue;
    const size_t base = ((static_cast<size_t>(b) * S_out + rows[e]) * heads_out + xhead) * Dt;
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      const int c = c0 + col + 8 * j;
      store_cols(out1 + base, c, Dt, acc1[4 * j + 2 * e], acc1[4 * j + 2 * e + 1]);
      if constexpr (!kDQ)
        store_cols(out2 + base, c, Dt, acc2[4 * j + 2 * e], acc2[4 * j + 2 * e + 1]);
    }
  }
  if constexpr (NC != 1) sm90::cluster_wait();   // the peers are done reading ours: exit
}

// Two names for the profile: the dk/dv launch (out1 = dv, out2 = dk) and
// the dq launch (out1 = dq); at D = 192 and 256 two more each, whose blocks
// form pairs, and above 256 two more whose blocks form clusters of N.
#define REPRO_F32TC_BWD_ARGS(T)                                                       \
  const __grid_constant__ BwdMaps m, const float* __restrict__ lse,                  \
      const float* __restrict__ delta, T* __restrict__ out1, T* __restrict__ out2,   \
      int Sq, int Sk, int H, int KV, int causal, int window, float softcap, float scale, int Dt
#define REPRO_F32TC_BWD_CALL \
  m, lse, delta, out1, out2, Sq, Sk, H, KV, causal, window, softcap, scale, Dt

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32tc_dkdv_kernel(REPRO_F32TC_BWD_ARGS(float)) {
  bwd_body<D, 1, float, false, kCap>(REPRO_F32TC_BWD_CALL);
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32tc_dq_kernel(REPRO_F32TC_BWD_ARGS(float)) {
  bwd_body<D, 1, float, true, kCap>(REPRO_F32TC_BWD_CALL);
}

template <bool kCap>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
flash_f32tc_dkdv_d192_kernel(REPRO_F32TC_BWD_ARGS(float)) {
  bwd_body<96, 2, float, false, kCap>(REPRO_F32TC_BWD_CALL);
}

template <bool kCap>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
flash_f32tc_dq_d192_kernel(REPRO_F32TC_BWD_ARGS(float)) {
  bwd_body<96, 2, float, true, kCap>(REPRO_F32TC_BWD_CALL);
}

template <bool kCap>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
flash_f32tc_dkdv_d256_kernel(REPRO_F32TC_BWD_ARGS(float)) {
  bwd_body<128, 2, float, false, kCap>(REPRO_F32TC_BWD_CALL);
}

template <bool kCap>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
flash_f32tc_dq_d256_kernel(REPRO_F32TC_BWD_ARGS(float)) {
  bwd_body<128, 2, float, true, kCap>(REPRO_F32TC_BWD_CALL);
}

template <int DH, typename T, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32tc_dkdv_cluster_kernel(REPRO_F32TC_BWD_ARGS(T)) {
  bwd_body<DH, 0, T, false, kCap>(REPRO_F32TC_BWD_CALL);
}

template <int DH, typename T, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
flash_f32tc_dq_cluster_kernel(REPRO_F32TC_BWD_ARGS(T)) {
  bwd_body<DH, 0, T, true, kCap>(REPRO_F32TC_BWD_CALL);
}
#undef REPRO_F32TC_BWD_ARGS
#undef REPRO_F32TC_BWD_CALL

// The kernels of DH columns a rank and cluster kind NC: one block a tile
// (NC 1, f32), pairs at 192 and 256 (NC 2, f32), clusters of N (NC 0).
template <int DH, int NC, typename T, bool kCap>
auto fwd_kernel() {
  if constexpr (NC == 0) return flash_f32tc_fwd_cluster_kernel<DH, T, kCap>;
  else if constexpr (NC == 2 && DH == 128) return flash_f32tc_fwd_d256_kernel<kCap>;
  else if constexpr (NC == 2) return flash_f32tc_fwd_d192_kernel<kCap>;
  else return flash_f32tc_fwd_kernel<DH, kCap>;
}

template <int DH, int NC, typename T, bool kCap>
auto dkdv_kernel() {
  if constexpr (NC == 0) return flash_f32tc_dkdv_cluster_kernel<DH, T, kCap>;
  else if constexpr (NC == 2 && DH == 128) return flash_f32tc_dkdv_d256_kernel<kCap>;
  else if constexpr (NC == 2) return flash_f32tc_dkdv_d192_kernel<kCap>;
  else return flash_f32tc_dkdv_kernel<DH, kCap>;
}

template <int DH, int NC, typename T, bool kCap>
auto dq_kernel() {
  if constexpr (NC == 0) return flash_f32tc_dq_cluster_kernel<DH, T, kCap>;
  else if constexpr (NC == 2 && DH == 128) return flash_f32tc_dq_d256_kernel<kCap>;
  else if constexpr (NC == 2) return flash_f32tc_dq_d192_kernel<kCap>;
  else return flash_f32tc_dq_kernel<DH, kCap>;
}

// ---- host side --------------------------------------------------------------

// A tensor map over a K-major copy [B, S, heads, D] f32 whose box is `rows`
// rows of one head, 32 columns wide, in the 128-byte swizzle.
inline bool kmajor_map(CUtensorMap* map, const float* x, int B, int S, int heads, int D,
                       int rows) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(heads) * D * 4;
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 4, row, row * S};
  const cuuint32_t box[4] = {32, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A tensor map over a transposed copy [B, heads, D, S_pad] f32 whose box is
// 16 positions of `rows` head-dim rows (all D, or a cluster rank's DH) of one
// head, in the 64-byte swizzle.
inline bool trans_map(CUtensorMap* map, const float* x, int B, int S, int heads, int D,
                      int rows) {
  const sm90::EncodeTiled encode = sm90::encode_tiled();
  if (encode == nullptr) return false;
  const int S_pad = round16(S);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(S_pad), static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t row = static_cast<cuuint64_t>(S_pad) * 4;
  const cuuint64_t strides[3] = {row, row * D, row * D * heads};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kBN), static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<float*>(x), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of a hi copy and, where there is one, its lo copy (else lo =
// hi: a one-product kernel never loads it).
inline bool kmajor_pair(MapPair* p, const float* hi, const float* lo, int B, int S, int heads,
                        int D, int rows) {
  if (!kmajor_map(&p->hi, hi, B, S, heads, D, rows)) return false;
  if (lo == nullptr) {
    p->lo = p->hi;
    return true;
  }
  return kmajor_map(&p->lo, lo, B, S, heads, D, rows);
}

inline bool trans_pair(MapPair* p, const float* hi, const float* lo, int B, int S, int heads,
                       int D, int rows) {
  if (!trans_map(&p->hi, hi, B, S, heads, D, rows)) return false;
  if (lo == nullptr) {
    p->lo = p->hi;
    return true;
  }
  return trans_map(&p->lo, lo, B, S, heads, D, rows);
}

// The workspace: hi and lo copies (hi alone with one product), each part
// 256-byte aligned. Forward: Q, K (as stored), V^T. Backward: Q, dO, K, V
// (as stored), Q^T, dO^T, K^T. Part 2 i is a hi copy, 2 i + 1 its lo.
constexpr int kFwdParts = 6, kBwdParts = 14;

inline size_t workspace_parts(int B, int Sq, int Sk, int H, int KV, int D, bool backward,
                              bool one, size_t (&off)[kBwdParts]) {
  const size_t nq = static_cast<size_t>(B) * Sq * H * D, nk = static_cast<size_t>(B) * Sk * KV * D;
  const size_t nqt = static_cast<size_t>(B) * H * D * round16(Sq);
  const size_t nkt = static_cast<size_t>(B) * KV * D * round16(Sk);
  const size_t fwd[kFwdParts] = {nq, nq, nk, nk, nkt, nkt};
  const size_t bwd[kBwdParts] = {nq, nq, nq, nq, nk, nk, nk, nk, nqt, nqt, nqt, nqt, nkt, nkt};
  const size_t* sizes = backward ? bwd : fwd;
  const int n = backward ? kBwdParts : kFwdParts;
  size_t total = 0;
  for (int i = 0; i < n; ++i) {
    off[i] = total;
    if (!(one && i % 2 == 1)) total += (sizes[i] + 63) / 64 * 64;
  }
  return total * sizeof(float);
}

inline PrepOp prep_op(const void* src, int B, int S, int heads) {
  PrepOp p{};
  p.src = src;
  p.S = S;
  p.heads = heads;
  p.blocks = (S + kPrepRows - 1) / kPrepRows * heads * B;
  return p;
}

template <typename Kernel>
cudaError_t launch_prep(Kernel kernel, const PrepArgs& a, cudaStream_t stream) {
  int blocks = 0;
  for (int i = 0; i < a.n_ops; ++i) blocks += a.op[i].blocks;
  const int cols = a.D < kPrepCols ? a.D : kPrepCols;
  const int smem = kPrepRows * (cols + 1) * static_cast<int>(sizeof(float));
  kernel<<<blocks, kPrepThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// A launch of `kernel` whose blocks form clusters of n along x (NC 0: the
// size set here), or a plain launch (NC 1, and NC 2 whose kernels carry
// __cluster_dims__).
template <int NC, typename... KArgs, typename... Args>
cudaError_t launch_tiles(void (*kernel)(KArgs...), dim3 grid, int smem, int n,
                         cudaStream_t stream, Args&&... args) {
  if constexpr (NC == 0) {
    cudaLaunchConfig_t cfg{};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(smem);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(n);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
    return err != cudaSuccess ? err : cudaGetLastError();
  } else {
    kernel<<<grid, kThreads, smem, stream>>>(std::forward<Args>(args)...);
    return cudaGetLastError();
  }
}

// Clusters of n blocks of `kernel` at `smem` bytes a block that the card can
// hold at once (cudaOccupancyMaxActiveClusters); 0: it cannot schedule one.
template <typename... KArgs>
int max_active_clusters(void (*kernel)(KArgs...), int smem, int n) {
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(n * 64);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(n);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int count = 0;
  return cudaOccupancyMaxActiveClusters(&count, kernel, &cfg) == cudaSuccess ? count : 0;
}

// Dt: the operands' head dim, at most the kernels' D (the columns between
// are the padding's, zeros in the prep launch's copies). q, k, v, out, dout,
// o, dq, dk, dv are of the launch's element type (f32 or bf16).
struct Args {
  const void *q, *k, *v, *out, *dout;
  const float* lse;
  void *o, *dq, *dk, *dv;
  float *lse_out, *delta, *work;
  int B, Sq, Sk, H, KV, Dt, causal, window;
  float softcap;
};

// The forward at built head dim D = n * DH: the prep launch, then the
// kernel of DH columns a rank in clusters of n (NC, as fwd_kernel).
template <int DH, int NC, typename T, bool kCap>
cudaError_t launch_forward(const Args& a, int n, cudaStream_t stream) {
  constexpr bool kOne = kOneOf<T>;
  const int D = n * DH;
  size_t off[kBwdParts];
  workspace_parts(a.B, a.Sq, a.Sk, a.H, a.KV, D, false, kOne, off);
  cudaError_t err = sm90::bind_context();
  if (err != cudaSuccess) return err;
  float* w = a.work;
  float* lo[3] = {nullptr, nullptr, nullptr};   // Q, K, V^T
  if constexpr (!kOne) lo[0] = w + off[1], lo[1] = w + off[3], lo[2] = w + off[5];
  PrepArgs p{};
  p.n_ops = 3;
  p.B = a.B;
  p.D = D;
  p.Dt = a.Dt;
  p.op[0] = prep_op(a.q, a.B, a.Sq, a.H);
  p.op[0].hi = w + off[0];
  p.op[0].lo = lo[0];
  p.op[1] = prep_op(a.k, a.B, a.Sk, a.KV);
  p.op[1].hi = w + off[2];
  p.op[1].lo = lo[1];
  p.op[2] = prep_op(a.v, a.B, a.Sk, a.KV);
  p.op[2].thi = w + off[4];
  p.op[2].tlo = lo[2];
  FwdMaps m;
  if (!kmajor_pair(&m.q, w + off[0], lo[0], a.B, a.Sq, a.H, D, kRows) ||
      !kmajor_pair(&m.k, w + off[2], lo[1], a.B, a.Sk, a.KV, D, kBN) ||
      !trans_pair(&m.vt, w + off[4], lo[2], a.B, a.Sk, a.KV, D, DH))
    return cudaErrorInvalidValue;
  err = launch_prep(flash_f32tc_fwd_prep_kernel<T>, p, stream);
  if (err != cudaSuccess) return err;
  constexpr int smem = fwd_smem<DH, NC>();
  const auto kernel = fwd_kernel<DH, NC, T, kCap>();
  static std::atomic<uint64_t> smem_set{0};
  err = set_smem_once(smem_set, kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n * a.H, a.B, (a.Sq + kRows - 1) / kRows);
  return launch_tiles<NC>(kernel, grid, smem, n, stream, m, static_cast<T*>(a.o), a.lse_out,
                          a.Sq, a.Sk, a.H, a.KV, a.causal, a.window, a.softcap,
                          1.0f / sqrtf(static_cast<float>(a.Dt)), a.Dt);
}

template <int DH, int NC, typename T, bool kCap>
cudaError_t launch_backward(const Args& a, int n, cudaStream_t stream) {
  constexpr bool kOne = kOneOf<T>;
  const int D = n * DH;
  size_t off[kBwdParts];
  workspace_parts(a.B, a.Sq, a.Sk, a.H, a.KV, D, true, kOne, off);
  cudaError_t err = sm90::bind_context();
  if (err != cudaSuccess) return err;
  float* w = a.work;
  // part 2 i: a hi copy; 2 i + 1: its lo (none with one product)
  auto hi = [&](int i) { return w + off[2 * i]; };
  auto lo = [&](int i) { return kOne ? nullptr : w + off[2 * i + 1]; };
  enum { kQ, kO, kK, kV, kQt, kOt, kKt };
  PrepArgs p{};
  p.n_ops = 4;
  p.B = a.B;
  p.D = D;
  p.Dt = a.Dt;
  p.op[0] = prep_op(a.q, a.B, a.Sq, a.H);
  p.op[0].hi = hi(kQ), p.op[0].lo = lo(kQ), p.op[0].thi = hi(kQt), p.op[0].tlo = lo(kQt);
  p.op[1] = prep_op(a.dout, a.B, a.Sq, a.H);
  p.op[1].hi = hi(kO), p.op[1].lo = lo(kO), p.op[1].thi = hi(kOt), p.op[1].tlo = lo(kOt);
  p.op[1].dot = a.out, p.op[1].delta = a.delta;
  p.op[2] = prep_op(a.k, a.B, a.Sk, a.KV);
  p.op[2].hi = hi(kK), p.op[2].lo = lo(kK), p.op[2].thi = hi(kKt), p.op[2].tlo = lo(kKt);
  p.op[3] = prep_op(a.v, a.B, a.Sk, a.KV);
  p.op[3].hi = hi(kV), p.op[3].lo = lo(kV);
  BwdMaps kv{}, qd{};   // dk/dv's and dq's operands
  const int B = a.B, Sq = a.Sq, Sk = a.Sk, H = a.H, KV = a.KV;
  const bool ok =
      kmajor_pair(&kv.x1, hi(kK), lo(kK), B, Sk, KV, D, kRows) &&
      kmajor_pair(&kv.x2, hi(kV), lo(kV), B, Sk, KV, D, kRows) &&
      kmajor_pair(&kv.y1, hi(kQ), lo(kQ), B, Sq, H, D, kBN) &&
      kmajor_pair(&kv.y2, hi(kO), lo(kO), B, Sq, H, D, kBN) &&
      trans_pair(&kv.t1, hi(kOt), lo(kOt), B, Sq, H, D, DH) &&
      trans_pair(&kv.t2, hi(kQt), lo(kQt), B, Sq, H, D, DH) &&
      kmajor_pair(&qd.x1, hi(kQ), lo(kQ), B, Sq, H, D, kRows) &&
      kmajor_pair(&qd.x2, hi(kO), lo(kO), B, Sq, H, D, kRows) &&
      kmajor_pair(&qd.y1, hi(kK), lo(kK), B, Sk, KV, D, kBN) &&
      kmajor_pair(&qd.y2, hi(kV), lo(kV), B, Sk, KV, D, kBN) &&
      trans_pair(&qd.t1, hi(kKt), lo(kKt), B, Sk, KV, D, DH);
  if (!ok) return cudaErrorInvalidValue;
  qd.t2 = qd.t1;   // unused by the dq launch
  err = launch_prep(flash_f32tc_bwd_prep_kernel<T>, p, stream);
  if (err != cudaSuccess) return err;
  constexpr int dkdv_smem = BwdRing<DH, NC, false, kOne>::SMEM;
  constexpr int dq_smem = BwdRing<DH, NC, true, kOne>::SMEM;
  const auto dkdv = dkdv_kernel<DH, NC, T, kCap>();
  const auto dq = dq_kernel<DH, NC, T, kCap>();
  static std::atomic<uint64_t> dkdv_set{0}, dq_set{0};
  err = set_smem_once(dkdv_set, dkdv, dkdv_smem);
  if (err != cudaSuccess) return err;
  err = set_smem_once(dq_set, dq, dq_smem);
  if (err != cudaSuccess) return err;
  const float scale = 1.0f / sqrtf(static_cast<float>(a.Dt));
  const dim3 grid_kv(n * KV, B, (Sk + kRows - 1) / kRows);
  T* no_out = nullptr;
  err = launch_tiles<NC>(dkdv, grid_kv, dkdv_smem, n, stream, kv, a.lse,
                         static_cast<const float*>(a.delta), static_cast<T*>(a.dv),
                         static_cast<T*>(a.dk), Sq, Sk, H, KV, a.causal, a.window, a.softcap,
                         scale, a.Dt);
  if (err != cudaSuccess) return err;
  const dim3 grid_q(n * H, B, (Sq + kRows - 1) / kRows);
  return launch_tiles<NC>(dq, grid_q, dq_smem, n, stream, qd, a.lse,
                          static_cast<const float*>(a.delta), static_cast<T*>(a.dq), no_out, Sq,
                          Sk, H, KV, a.causal, a.window, a.softcap, scale, a.Dt);
}

inline bool shape_ok(int B, int Sq, int Sk, int H, int KV, int Dt, int D) {
  return B > 0 && Sq > 0 && Sk > 0 && KV > 0 && H % KV == 0 && B <= 65535 && H <= 65535 &&
         Dt > 0 && Dt <= D &&
         (Sq + kRows - 1) / kRows <= 65535 && (Sk + kRows - 1) / kRows <= 65535;
}

}  // namespace
}  // namespace repro
