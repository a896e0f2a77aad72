// Flash attention forward on Hopper's tensor cores (sm_90a), for bf16.
//
// Replaces: src/repro/kernels/flash_attention.py, `_kernel` / `flash_attention`
// (the Pallas TPU kernel, grid (B, H, S/bq, S/bk) with the k axis sequential,
// reached from the model through `_pallas_attn` in src/repro/models/layers.py)
// for bf16 operands. f32 operands go to flash_attention_f32tc.cu (split-f32,
// three TF32 products per f32 product, which meet the f32 tolerance of 2e-5
// where one TF32 product cannot). Its backward is flash_attention_tc_bwd.cu.
//
// Function: as ref.flash_attention_ref. q [B,Sq,H,D],
//   k/v [B,Sk,KV,D] bf16 -> out [B,Sq,H,D] bf16; q head h reads kv head
//   h / (H/KV), the GQA repeat is never materialised. Scores (q.k)/sqrt(D) in
//   f32, then the optional tanh softcap, then the causal mask kpos <= qpos
//   with an optional window kpos > qpos - window (only when causal). Masked
//   scores get no weight; running max, sum and output are f32; a row whose sum
//   is 0 outputs 0. Any Sq and Sk; D in {32, 64, 128, 192, 256} (the
//   wrapper pads any other head dim Dt up to the next of those with zero
//   columns, and the scale is 1 / sqrt(Dt), the true head dim's). When asked, lse
//   [B,H,Sq] f32 = m + log(sum of P before its bf16 rounding) of each row
//   (+inf for a row with no kept key), as ref.flash_attention_lse_ref, is
//   written after the output, which stays the same bits (a template flag:
//   the kernel without it keeps no second sum).
//
// What bounds it on the card: operations. At S = 2048 and D = 128 a (b, h)
// pair does ~4*S*S*D/2 causal flops on 4*S*D*2 bytes, hundreds of flops per
// byte, above the H100's ridge. The floor is the causal flops over the bf16
// tensor-core peak (989 TFLOP/s), which only wgmma reaches.
//
// What the design does about it:
//   * Both products run on the tensor cores with wgmma. S = Q K^T takes Q and
//     K from shared memory (both K-major). P = exp2(S - m) is rounded to bf16
//     in registers: the f32 fragment of S is, pair by pair, the A-register
//     fragment of O += P V, whose B operand V is read from shared memory
//     MN-major (the transpose bit). O, the running max and the running sum
//     stay f32 in registers; scores never touch shared memory. The sum is
//     taken over the bf16-rounded P that the product uses.
//   * One block per (128 q rows, head, batch): two consumer warpgroups own 64
//     rows each, and one thread loads by TMA: Q once, then K/V tiles
//     through a ring of stages, each with a full and an empty mbarrier, so
//     the next tiles arrive while this one is multiplied. Tiles land in the
//     128-byte swizzle (64-byte for D = 32) that wgmma reads without bank
//     conflicts; a 4-D tensor map (D, heads, S, batch) reads one head's rows
//     in place and fills rows past S with zeros.
//   * Registers decide who loads. ptxas holds every thread of a block to
//     the registers its size allows: 168 for nine to twelve warps (a
//     quarter of the register file serves a quarter of the warps; setmaxnreg
//     moves registers at run time, but the code was allocated for 168), 255
//     for eight. At D <= 128 (O is 64 registers) a ninth warp, the producer,
//     starts the copies and waits on each release; the consumers fit 168. At
//     D = 256, O is 128 registers beside S and P (48 at 64 keys): under 168
//     that spilled and ptxas serialised the wgmmas (C7512), so the block is
//     the two consumer warpgroups alone (223-248 registers, no spill) and a
//     consumer thread starts the copies, polling the ring (sm90::Ring)
//     between its own tiles.
//   * The two consumer warpgroups run unsynchronised, so one's softmax
//     overlaps the other's products on the tensor cores.
//   * Tiles that causality or the window rule out entirely are never loaded;
//     only tiles that cross the diagonal, the window edge or the ragged end
//     test each score against the mask (two bounds per row).
//   * exp2 of (s - m) * scale * log2(e) in one FMA, the max taken on the raw
//     scores; the softcap, which must come before that, is a template
//     argument, so the kernel without one carries no tanh.
//   * The q tile is the slowest grid axis, taken in reverse, so the heaviest
//     causal tiles start first and the light ones fill the tail.
//   * Tiles: BK = 128 keys and 3 stages for D <= 128 (Q 32 KB + 3 x (K + V)
//     192 KB at D = 128), BK = 64 and 2 stages above (Q 64 KB + 2 x (K + V)
//     128 KB at D = 256; 48 + 96 KB at 192, whose O of 96 registers takes
//     the D = 256 block of two consumer warpgroups and no producer warp).
//     At D = 256, 32-key tiles in 4 stages measured
//     0.308 ms against 0.228 on an H100 at gemma2-9b's shape: O's rescale
//     (128 registers), the row max shuffles and the barrier waits come once
//     a tile, twice as often.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {
namespace {

using bf16 = __nv_bfloat16;

constexpr int kBQ = 128;                        // q rows per block
constexpr int kConsumers = 256;                 // two warpgroups of 64 rows each

template <int D>
struct Tile {
  static constexpr int BK = D <= 128 ? 128 : 64;   // keys per k tile
  static constexpr int STAGES = D <= 128 ? 3 : 2;  // K/V ring depth
  // a producer warp after the consumers (ptxas then holds every thread to
  // 168 registers), or none and one consumer thread starts the copies (255)
  static constexpr bool WARP = D <= 128;
  static constexpr int THREADS = kConsumers + (WARP ? 32 : 0);
  static constexpr int PRODUCER = WARP ? kConsumers : 128;   // the thread that copies
  static constexpr int SW = D >= 64 ? 128 : 64;    // swizzle span (bytes of a row)
  static constexpr int E = SW / 2;                 // bf16 columns per swizzled box
  static constexpr int NC = D / E;                 // boxes across D
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int BAR_BYTES = 128;
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * 2 * KV_BYTES + BAR_BYTES;
  static_assert(SMEM <= 232448, "tiles exceed a block's shared memory");
  static_assert(D % E == 0 && BK % 16 == 0 && 2 * STAGES + 1 <= BAR_BYTES / 8, "bad tile");
};

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// TMA copies of rows [row0, row0 + R) of one head: NC boxes of E columns, box
// c at dst + c * R * SW, each row SW bytes in the swizzled layout.
template <int D, int R>
__device__ __forceinline__ void load_rows(char* dst, const CUtensorMap* map, uint64_t* bar,
                                          int head, int row0, int b) {
  using T = Tile<D>;
#pragma unroll
  for (int c = 0; c < T::NC; ++c)
    sm90::tma_load_4d(dst + c * R * T::SW, map, bar, c * T::E, head, row0, b);
}

// Descriptors of a tile loaded by load_rows. K-major (Q, K): 8-row groups
// 8 SW bytes apart. MN-major (V): boxes of E columns BK SW bytes apart
// (leading), groups of 8 keys 8 SW bytes apart (stride). Offsets within a
// tile are added to the start-address field in 16-byte units.
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(const char* tile) {
  return sm90::smem_desc(tile, 16, 8 * Tile<D>::SW, Tile<D>::SW);
}

template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(const char* tile) {
  return sm90::smem_desc(tile, Tile<D>::BK * Tile<D>::SW, 8 * Tile<D>::SW, Tile<D>::SW);
}

// s = Q K^T for one warpgroup: 64 rows of the Q tile (q: their descriptor)
// against the BK rows of the K tile (k), as one commit group (the caller waits).
// The first 16-deep step writes s without reading it (wgmma_ss_init), so
// the last tile's scores need not stay live through the softmax and P V.
template <int D>
__device__ __forceinline__ void qk_product(float (&s)[Tile<D>::BK / 2], uint64_t q, uint64_t k) {
  using T = Tile<D>;
  sm90::wgmma_fence();
  sm90::wgmma_ss_init<T::BK>(s, q, k);
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) {
    // depth kk * 16: box c, byte `inner` into each swizzled row
    const int c = kk * 16 / T::E, inner = (kk * 16 % T::E) * 2;
    sm90::wgmma_ss<T::BK>(s, q + ((c * kBQ * T::SW + inner) >> 4),
                          k + ((c * T::BK * T::SW + inner) >> 4), 1);
  }
  sm90::wgmma_commit();
}

// o += P V for one warpgroup: p holds P's bf16 A fragments, one set of four
// registers per 16 keys; v is the V tile's MN-major descriptor. One commit
// group (the caller waits).
template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&p)[Tile<D>::BK / 16][4], uint64_t v) {
  using T = Tile<D>;
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::BK / 16; ++kk)
    sm90::wgmma_rs<D>(o, p[kk], v + ((kk * 16 * T::SW) >> 4), 1);
  sm90::wgmma_commit();
}

// Online softmax over one k tile, in the registers of the S fragment.
// This thread holds rows qpos0 and qpos1 (index e < 2 and e >= 2 of each
// group of four) at columns k0 + 8 j + col + (e & 1). m is the running max of
// the raw scores, in raw units; on return s holds P = exp2((s - m) * c) with
// c = scale * log2(e), and alpha the factors the older sums are scaled by.
// With kLse it also keeps the sums of P before rounding (x0, x1), whose log
// gives lse to f32 accuracy: the rounded sums that normalise o can be 2^-9
// off in a row of few keys.
template <int BK, bool kCap, bool kLse>
struct RowSoftmax {
  float m0 = kNegInf, m1 = kNegInf;   // running max of rows qpos0, qpos1
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the running sums
  float x0 = 0.f, x1 = 0.f;           // the same of the unrounded P (kLse)

  __device__ __forceinline__ void step(float (&s)[BK / 2], float& alpha0, float& alpha1,
                                       bool edge, RowKeys r0, RowKeys r1, float cap_in,
                                       float cap_out, float c) {
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
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
    alpha0 = fast_exp2((m0 - mx0) * c);
    alpha1 = fast_exp2((m1 - mx1) * c);
    m0 = mx0;
    m1 = mx1;
    const float b0 = m0 * c, b1 = m1 * c;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j] = fast_exp2(fmaf(s[4 * j], c, -b0));
      s[4 * j + 1] = fast_exp2(fmaf(s[4 * j + 1], c, -b0));
      s[4 * j + 2] = fast_exp2(fmaf(s[4 * j + 2], c, -b1));
      s[4 * j + 3] = fast_exp2(fmaf(s[4 * j + 3], c, -b1));
    }
  }

  // Round P to bf16 A fragments and add the rounded values to the sums
  // (scaled by alpha first); with kLse the unrounded ones to x0, x1 too.
  __device__ __forceinline__ void to_fragments(const float (&s)[BK / 2],
                                               uint32_t (&pf)[BK / 16][4], float alpha0,
                                               float alpha1) {
    float sum0 = 0.f, sum1 = 0.f, ex0 = 0.f, ex1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const __nv_bfloat162 r0 = __floats2bfloat162_rn(s[4 * j], s[4 * j + 1]);
      const __nv_bfloat162 r1 = __floats2bfloat162_rn(s[4 * j + 2], s[4 * j + 3]);
      sum0 += __low2float(r0) + __high2float(r0);
      sum1 += __low2float(r1) + __high2float(r1);
      if constexpr (kLse) {
        ex0 += s[4 * j] + s[4 * j + 1];
        ex1 += s[4 * j + 2] + s[4 * j + 3];
      }
      pf[j / 2][(j % 2) * 2] = bits(r0);
      pf[j / 2][(j % 2) * 2 + 1] = bits(r1);
    }
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    if constexpr (kLse) {
      x0 = x0 * alpha0 + ex0;
      x1 = x1 * alpha1 + ex1;
    }
  }
};

template <int R>
__device__ __forceinline__ void rescale(float (&o)[R], float alpha0, float alpha1) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    o[4 * j] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

template <int D, bool kCap, bool kLse>
__global__ void __launch_bounds__(Tile<D>::THREADS, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                    float* __restrict__ lse, int Sq, int Sk, int H, int KV, int causal,
                    int window, float softcap, float scale) {
  using T = Tile<D>;
  constexpr int BK = T::BK, NS = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle pattern follows address bits: tiles start 1024-byte aligned
  char* sQ = reinterpret_cast<char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  char* sKV = sQ + T::Q_BYTES;   // stage s: K at sKV + 2 s KV_BYTES, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(sKV + NS * 2 * T::KV_BYTES);
  uint64_t* empty = full + NS;
  uint64_t* qbar = empty + NS;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // heaviest q tile first
  const int kvh = h / (H / KV);
  // k tiles that hold a kept key for some row of this block
  const int q_last = min(q0 + kBQ, Sq) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = (causal && window > 0) ? max(0, q0 - window + 1) : 0;
  const int t_begin = k_begin / BK, n_tiles = (k_end + BK - 1) / BK - t_begin;
  const int tid = threadIdx.x;
  // the warpgroup index, read from lane 0 so the compiler sees it is the
  // same across the warp
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], kConsumers / 32);   // one arrival per consumer warp
    }
    sm90::mbar_init(qbar, 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();

  // one thread starts every copy: Q once, then K/V tiles through the ring,
  // refilled as the consumers release stages: the producer warp's lane 0,
  // waiting for each release, or (no producer warp) a consumer thread,
  // which polls the ring (sm90::Ring) between its own tiles
  auto load = [&](int i, int s) {
    const int k0 = (t_begin + i) * BK;
    char* stage = sKV + s * 2 * T::KV_BYTES;
    sm90::mbar_arrive_expect_tx(&full[s], 2 * T::KV_BYTES);
    load_rows<D, BK>(stage, &tk, &full[s], kvh, k0, b);
    load_rows<D, BK>(stage + T::KV_BYTES, &tv, &full[s], kvh, k0, b);
  };
  const bool producer = tid == T::PRODUCER;
  if (producer) {
    sm90::mbar_arrive_expect_tx(qbar, T::Q_BYTES);
    load_rows<D, kBQ>(sQ, &tq, qbar, h, q0, b);
  }
  if (T::WARP && wg == 2) {
    for (int i = 0; producer && i < n_tiles; ++i) {
      const int s = i % NS;
      // the stage's previous tile (i - NS) must be released first
      if (i >= NS) sm90::mbar_wait(&empty[s], (i / NS - 1) & 1);
      load(i, s);
    }
  } else {
    sm90::Ring<NS, decltype(load)> ring{empty, n_tiles, load, 0};
    if (!T::WARP && producer) ring.poll(1);
    // consumers: warpgroup wg owns rows qw0 .. qw0 + 63 of the block
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int qw0 = q0 + wg * 64;
    const int qpos0 = qw0 + warp * 16 + lane / 4, qpos1 = qpos0 + 8;   // this thread's rows
    const int col = 2 * (lane % 4);   // its first column in each group of 8
    const int w_last = min(qw0 + 64, Sq) - 1;
    const float c = scale * kLog2e;
    const float cap_in = softcap > 0.f ? scale / softcap : 0.f;
    const float cap_out = softcap > 0.f ? softcap / scale : 0.f;
    // descriptors of this warpgroup's Q rows and of stage 0's K and V tiles;
    // stage s is 2 s KV_BYTES further
    const uint64_t q_desc = kmajor_desc<D>(sQ + wg * 64 * T::SW);
    const uint64_t k_desc0 = kmajor_desc<D>(sKV), v_desc0 = mnmajor_desc<D>(sKV + T::KV_BYTES);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    RowSoftmax<BK, kCap, kLse> sm;
    float sc[BK / 2];
    uint32_t pf[BK / 16][4];
    float alpha0, alpha1;

    sm90::mbar_wait(qbar, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % NS, k0 = (t_begin + i) * BK;
      const uint64_t stage = (s * 2 * T::KV_BYTES) >> 4;
      if (!T::WARP && producer) ring.poll(i + 1);
      sm90::mbar_wait(&full[s], (i / NS) & 1);
      qk_product<D>(sc, q_desc, k_desc0 + stage);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      // only tiles where some score of this warpgroup is masked test each one
      const bool edge = k0 + BK > Sk ||
                        (causal && (k0 + BK - 1 > qw0 || (window > 0 && k0 <= w_last - window)));
      sm.step(sc, alpha0, alpha1, edge, RowKeys(qpos0, k0, col, Sk, causal, window),
              RowKeys(qpos1, k0, col, Sk, causal, window), cap_in, cap_out, c);
      rescale(acc, alpha0, alpha1);
      sm.to_fragments(sc, pf, alpha0, alpha1);
      pv_product<D>(acc, pf, v_desc0 + stage);
      sm90::wgmma_wait<0>();
      sm90::fence_regs(acc);
      if (lane == 0) sm90::mbar_arrive(&empty[s]);   // the stage may be refilled
      if (!T::WARP && producer) ring.poll(0);
    }
    float l0 = sm.l0, l1 = sm.l1;
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
    const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    // lse = m + log(x) in scaled units, x the unrounded sum (+inf for a row
    // with no kept key); o does not read it
    if constexpr (kLse) {
      float x0 = sm.x0, x1 = sm.x1;
      x0 += __shfl_xor_sync(0xffffffffu, x0, 1);
      x0 += __shfl_xor_sync(0xffffffffu, x0, 2);
      x1 += __shfl_xor_sync(0xffffffffu, x1, 1);
      x1 += __shfl_xor_sync(0xffffffffu, x1, 2);
      if (lane % 4 == 0) {
        float* row_lse = lse + (static_cast<size_t>(b) * H + h) * Sq;
        if (qpos0 < Sq) row_lse[qpos0] = x0 == 0.f ? INFINITY : sm.m0 * scale + logf(x0);
        if (qpos1 < Sq) row_lse[qpos1] = x1 == 0.f ? INFINITY : sm.m1 * scale + logf(x1);
      }
    }
    if (qpos0 < Sq) {
      bf16* dst = o + ((static_cast<size_t>(b) * Sq + qpos0) * H + h) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    }
    if (qpos1 < Sq) {
      bf16* dst = o + ((static_cast<size_t>(b) * Sq + qpos1) * H + h) * D + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// ---- host side --------------------------------------------------------------

template <int D, bool kCap, bool kLse>
cudaError_t launch_kernel(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                      void* o, float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
                      int window, float softcap, float scale, cudaStream_t stream) {
  using T = Tile<D>;
  static std::atomic<uint64_t> smem_set{0};
  const cudaError_t attr = set_smem_once(smem_set, flash_fwd_tc_kernel<D, kCap, kLse>, T::SMEM);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(H, B, (Sq + kBQ - 1) / kBQ);
  flash_fwd_tc_kernel<D, kCap, kLse><<<grid, T::THREADS, T::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), lse, Sq, Sk, H, KV, causal, window, softcap, scale);
  return cudaGetLastError();
}

// Tensor maps for q, k, v, then the kernel for D with or without a softcap
// and an lse output; scale = 1 / sqrt(Dt).
template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                      int Sq, int Sk, int H, int KV, int Dt, int causal, int window,
                      float softcap, cudaStream_t stream) {
  using T = Tile<D>;
  const cudaError_t bound = sm90::bind_context();
  if (bound != cudaSuccess) return bound;
  CUtensorMap tq, tk, tv;
  if (!sm90::bf16_rows_map(&tq, q, B, Sq, H, D, kBQ, T::SW) || !sm90::bf16_rows_map(&tk, k, B, Sk, KV, D, T::BK, T::SW) ||
      !sm90::bf16_rows_map(&tv, v, B, Sk, KV, D, T::BK, T::SW))
    return cudaErrorInvalidValue;
  // the softcap and the lse output as template arguments
  const auto kernel = softcap > 0.f
                          ? (lse != nullptr ? launch_kernel<D, true, true>
                                            : launch_kernel<D, true, false>)
                          : (lse != nullptr ? launch_kernel<D, false, true>
                                            : launch_kernel<D, false, false>);
  return kernel(tq, tk, tv, o, lse, B, Sq, Sk, H, KV, causal, window, softcap,
                1.0f / sqrtf(static_cast<float>(Dt)), stream);
}

}  // namespace
}  // namespace repro

// C entry point, bf16 only (q, k, v and out, [..., D]). lse [B,H,Sq] f32 is
// written when non-null (the backward's input; out is the same bits either
// way). Dt <= D: the head dim the scores are scaled by (1 / sqrt(Dt)), the
// operands' columns from Dt on being zeros the wrapper padded them with.
// causal is 0 or 1; window <= 0 means no window; softcap <= 0 means none. Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a shape it does not
// take or a tensor map cuTensorMapEncodeTiled refuses.
extern "C" int repro_flash_attention_tc(const void* q, const void* k, const void* v, void* out,
                                        float* lse, int B, int Sq, int Sk, int H, int KV, int Dt,
                                        int D, int causal, int window, float softcap,
                                        void* stream) {
  using namespace repro;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || B > 65535 ||
      (Sq + kBQ - 1) / kBQ > 65535 || Dt <= 0 || Dt > D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define REPRO_TC_CASE(DD)                                                                     \
  case DD:                                                                                    \
    err = launch_tc<DD>(q, k, v, out, lse, B, Sq, Sk, H, KV, Dt, causal, window, softcap, st); \
    break;
  switch (D) {
    REPRO_TC_CASE(32)
    REPRO_TC_CASE(64)
    REPRO_TC_CASE(128)
    REPRO_TC_CASE(192)
    REPRO_TC_CASE(256)
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_TC_CASE
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) a block of the forward takes at head dim D;
// 0 for a D it does not take. Not a launch.
extern "C" int repro_flash_tc_smem(int D) {
  using namespace repro;
  switch (D) {
    case 32: return Tile<32>::SMEM;
    case 64: return Tile<64>::SMEM;
    case 128: return Tile<128>::SMEM;
    case 192: return Tile<192>::SMEM;
    case 256: return Tile<256>::SMEM;
    default: return 0;
  }
}
