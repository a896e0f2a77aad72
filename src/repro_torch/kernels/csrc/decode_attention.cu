// Decode attention for Hopper (sm_90a): one query token per (slot, head)
// against a KV cache held at kv heads, in one launch.
//
// Replaces: src/repro/kernels/decode_attention.py, `_kernel` / `decode_attention`
// (the Pallas TPU kernel, grid (B, H, S/block_k) with the KV axis sequential).
// The JAX model path computes the same function with einsums
// (src/repro/models/layers.py `apply_attention_decode`); the port sends it here.
//
// Function: q [B,H,D], k/v [B,S,KV,D], lengths [B] int32 -> out [B,H,D], and
//   optionally lse [B,H] f32, the row log-sum-exp of the scores.
//   q head h reads kv head h / (H/KV). Key j stands for position offset + j
//   (offset > 0 on a rank's range of a sequence-sharded cache). Keys are valid
//   where kpos < length and, with a window, kpos >= length - window. Scores are
//   (q.k)/sqrt(Dt) in f32, Dt the true head dim (D in {32, 64, 128, 192,
//   256}, or above 256 a multiple of 64 on the wide kernel below; the
//   wrapper pads any other Dt up to the next with zero columns),
//   optionally soft-capped (softcap * tanh(s /
//   softcap)). If no key is valid every score is the same masked value, so the
//   softmax is uniform over all S keys: the kernel then averages V over S,
//   which is what the XLA path (softmax over scores that are all -1e30) gives,
//   and its lse is -1e30 (-1e30 + log S in f32). Ranges' (out, lse) merge by
//   lse weights (ops.merge_attention_parts); the out bits do not depend on
//   whether lse is written.
//
// What bounds it on the card: bytes. Each valid key costs 2*D*sizeof(T) bytes
// of K and V and about 4*D flops per query head in its group, far below the
// H100's 295 flops per byte. The floor is the K+V bytes of the valid prefix
// over 3.35 TB/s. At the serving shape that prefix is small (64 keys per slot,
// 2 MB), so what is left is latency: one launch, one round trip to memory for
// K/V, and the merge of the pieces.
//
// What the design does about it:
//   * One launch, no global scratch. The n_split blocks of one (slot, kv head)
//     form a thread block cluster (n_split <= 8, the portable cluster size).
//     Each block merges its warps' partials (m, l, acc) in shared memory, in
//     warp order, and stores the result through distributed shared memory
//     into its slot of block rank 0's inbox; after the cluster barrier, rank
//     0 merges the inbox in rank order and writes the output. Stores, not
//     loads, cross the cluster: no block waits on a remote round trip, and
//     only rank 0 waits at the barrier (the others exit, since nothing reads
//     their shared memory). No atomics: the result is bit-identical from run
//     to run.
//   * K/V are read once per kv head: the G = H/KV query heads of a group live
//     in the same warp's registers, so the cache is never expanded to H heads.
//     A group above 16 (multi-query layouts: Falcon-7B's 71 heads over one kv
//     head) is cut into chunks of at most 2 heads (group_chunks), a cluster
//     each on the grid's y axis (KV x chunks), in the same launch; each
//     chunk reads the kv head's K/V once.
//   * Work follows the valid range, not S: each block derives [lo, hi) from
//     lengths[b] and the window on the device and cuts it into one contiguous
//     piece per warp of the cluster (n_split * 4 pieces), so with 64 valid
//     keys every warp gets 2 and keys outside [lo, hi) are never read. The
//     host picks n_split from S, B*KV and the SM count only (reading lengths
//     would force a sync).
//   * Loads overlap the softmax: each warp streams its piece through its own
//     ring of kStages tiles (4 KB each at f32 D=128) in shared memory with
//     16-byte cp.async (commit_group / wait_group), so the next tile is in
//     flight while the current one's scores, max, exp and V accumulation
//     run. A ring per warp needs only __syncwarp, never a block barrier,
//     inside the key loop. Two stages measured fastest: deeper rings or
//     larger tiles take more shared memory per block, fewer clusters of 8
//     fit on the card at once, and a full cache streams slower.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace repro {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kStages = 2;
constexpr int kMaxSplit = 8;        // portable cluster size
constexpr int kStageBytes = 4096;   // K+V bytes of one ring tile, at least

__device__ __forceinline__ void cp_async_16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// the cluster barrier's halves (hopper.cuh)
using sm90::cluster_arrive_relaxed;
using sm90::cluster_arrive_release;
using sm90::cluster_wait;

// A (m, l, acc) record of GMAX heads in shared memory: acc at [g * D], m at
// [GMAX * D + g], l at [GMAX * D + GMAX + g].
template <int D, int GMAX>
struct Part {
  static constexpr int FLOATS = GMAX * (D + 2);
  float* p;
  __device__ float& acc(int g, int d) const { return p[g * D + d]; }
  __device__ float& m(int g) const { return p[GMAX * D + g]; }
  __device__ float& l(int g) const { return p[GMAX * D + GMAX + g]; }
};

// Compile-time shape of one instance: D dims, up to GMAX query heads per kv
// head, KEYS keys scored together (independent shuffle chains), TILE keys per
// ring stage (a whole number of key groups: at D = 192 a lane's EPL = 6 dims
// are 24 or 12 bytes, loaded 8 or 4 bytes at a time, and 4096 bytes hold 2
// f32 or 5 bf16 key pairs, 4 bf16 ones at KEYS 4 or 2).
template <typename T, int D, int GMAX>
struct Shape {
  static constexpr int EPL = D / 32;                                // dims per lane
  static constexpr int KEYS = GMAX <= 2 ? 4 : (GMAX == 4 ? 2 : 1);
  static constexpr int ROW_BYTES = D * static_cast<int>(sizeof(T));
  static constexpr int PAIR_BYTES = 2 * ROW_BYTES;
  static constexpr int FIT = kStageBytes / PAIR_BYTES / KEYS * KEYS;
  static constexpr int TILE = FIT > KEYS ? FIT : KEYS;
  static constexpr int CHUNKS = ROW_BYTES / 16;                     // 16-byte copies a row
  static constexpr int STAGE_ELEMS = TILE * 2 * D;                  // [TILE][K, V][D]
  static constexpr int RING_BYTES = kWarps * kStages * STAGE_ELEMS * static_cast<int>(sizeof(T));
  static constexpr int PART_FLOATS = Part<D, GMAX>::FLOATS;         // acc[G][D], m[G], l[G]
  static constexpr int PART_BYTES = kWarps * PART_FLOATS * 4;
  static constexpr int MERGE_OFFSET = RING_BYTES > PART_BYTES ? RING_BYTES : PART_BYTES;
  // the ring, then its reuse for the warps' partials; then rank 0's inbox of
  // one record per block of the cluster; then the merge weights
  static constexpr int SMEM = MERGE_OFFSET + (kMaxSplit * PART_FLOATS + GMAX * (kMaxSplit + 2)) * 4;
  static_assert(ROW_BYTES % 16 == 0, "rows are copied in 16-byte pieces");
  static_assert(TILE % KEYS == 0, "a tile holds whole key groups");
};

// The merge weights of head g over the first n of N records (m, l, acc) at
// recs, stride one record: w[r] = exp(m_r - M) with M the largest m of a
// record that saw a key (l > 0; a record with l == 0 weighs 0), and their
// sum L = sum_r w[r] l_r in index order. Stored at out: w[0..N), M, L.
template <int D, int GMAX, int N>
__device__ __forceinline__ void merge_weights(float* recs, int n, int g, float* out) {
  float rm[N], rl[N];
#pragma unroll
  for (int r = 0; r < N; ++r) {   // every load issued before the first is used
    const Part<D, GMAX> pr{recs + r * Part<D, GMAX>::FLOATS};
    rm[r] = r < n ? pr.m(g) : -INFINITY;
    rl[r] = r < n ? pr.l(g) : 0.f;
  }
  float M = -INFINITY;
#pragma unroll
  for (int r = 0; r < N; ++r)
    if (rl[r] > 0.f) M = fmaxf(M, rm[r]);
  float L = 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float w = rl[r] > 0.f ? expf(rm[r] - M) : 0.f;
    L = fmaf(w, rl[r], L);
    out[r] = w;
  }
  out[N] = M;
  out[N + 1] = L;
}

// sum_r w[r] acc_r[g][d] over the first n of N records, in index order.
template <int D, int GMAX, int N>
__device__ __forceinline__ float merge_acc(float* recs, int n, int g, int d, const float* w) {
  float ra[N];
#pragma unroll
  for (int r = 0; r < N; ++r)
    ra[r] = r < n ? Part<D, GMAX>{recs + r * Part<D, GMAX>::FLOATS}.acc(g, d) : 0.f;
  float o = 0.f;
#pragma unroll
  for (int r = 0; r < N; ++r)
    if (r < n && w[r] > 0.f) o = fmaf(w[r], ra[r], o);
  return o;
}

template <typename T, int D, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ lse, int S, int H,
                        int KV, int offset, int window, float softcap, float scale, int Gc) {
  using Sh = Shape<T, D, GMAX>;
  constexpr int EPL = Sh::EPL, KEYS = Sh::KEYS, TILE = Sh::TILE;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = gridDim.x;                 // = the cluster's size
  const int split = blockIdx.x, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // this cluster's chunk of the kv head's group: query heads h0 .. h0 + G - 1
  const int chunks = gridDim.y / KV, Gt = H / KV;
  const int kvh = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * Gc;
  const int G = min(Gc, Gt - g0), h0 = kvh * Gt + g0;

  // this warp's contiguous piece [s0, s1) of the valid range [lo, hi), in
  // local key indices (global position offset + j)
  const int length = lengths[b] - offset;
  int hi = min(length, S);
  int lo = window > 0 ? max(length - window, 0) : 0;
  const bool uniform = hi <= lo;      // no valid key: softmax is uniform over S
  if (uniform) { lo = 0; hi = S; }
  const int pieces = n_split * kWarps;
  const int per = (hi - lo + pieces - 1) / pieces;
  const int s0 = min(hi, lo + (split * kWarps + warp) * per);
  const int s1 = min(hi, s0 + per);
  const int n_tiles = (s1 - s0 + TILE - 1) / TILE;
  cluster_arrive_relaxed();   // phase 0: this block runs (waited for before the merge)

  T* ring = reinterpret_cast<T*>(smem) + warp * kStages * Sh::STAGE_ELEMS;
  const size_t row = static_cast<size_t>(KV) * D;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + kvh) * D;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + kvh) * D;
  // tile i of the piece -> ring stage i % kStages, laid out [TILE][K, V][D]
  auto issue = [&](int i) {
    if (i < n_tiles) {
      T* st = ring + (i % kStages) * Sh::STAGE_ELEMS;
      const int key0 = s0 + i * TILE;
#pragma unroll
      for (int c = lane; c < TILE * 2 * Sh::CHUNKS; c += 32) {
        const int r = c / Sh::CHUNKS, ch = c % Sh::CHUNKS;   // r = 2 * key + (0 K, 1 V)
        const int key = key0 + r / 2;
        if (key < s1) {
          const T* src = ((r & 1) ? vb : kb) + static_cast<size_t>(key) * row + ch * (16 / sizeof(T));
          cp_async_16(st + r * D + ch * (16 / sizeof(T)), src);
        }
      }
    }
    cp_async_commit();   // an empty group when i >= n_tiles keeps the count
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float qr[GMAX][EPL];
  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) { acc[g][e] = 0.f; qr[g][e] = 0.f; }
    if (g < G) load_row<T, EPL>(q + ((size_t)b * H + h0 + g) * D + lane * EPL, qr[g]);
  }

  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kStages - 2>();   // this lane's copies of tile i have landed
    __syncwarp();                   // and every lane's; tile i - 1 is consumed
    issue(i + kStages - 1);         // into the stage tile i - 1 held
    const T* st = ring + (i % kStages) * Sh::STAGE_ELEMS;
    const int key0 = s0 + i * TILE;
#pragma unroll
    for (int j0 = 0; j0 < TILE; j0 += KEYS) {
      if (key0 + j0 >= s1) break;
      float kr[KEYS][EPL], vr[KEYS][EPL];
      bool ok[KEYS];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        ok[j] = key0 + j0 + j < s1;
#pragma unroll
        for (int e = 0; e < EPL; ++e) { kr[j][e] = 0.f; vr[j][e] = 0.f; }
        if (ok[j]) {   // rows past s1 were never copied: stale, not read
          load_row<T, EPL>(st + (2 * (j0 + j)) * D + lane * EPL, kr[j]);
          load_row<T, EPL>(st + (2 * (j0 + j) + 1) * D + lane * EPL, vr[j]);
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
        const float m_new = fmaxf(m[g], mx);      // finite: key j0 is always valid
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
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: its bytes become the partials

  // each warp's partial into shared memory
  float* parts = reinterpret_cast<float*>(smem);
  const Part<D, GMAX> mine{parts + warp * Sh::PART_FLOATS};
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int e = 0; e < EPL; ++e) mine.acc(g, lane * EPL + e) = acc[g][e];
    if (lane == 0) { mine.m(g) = m[g]; mine.l(g) = l[g]; }
  }
  __syncthreads();
  // per head, the block's merge weights over its warps (one thread a head)
  float* inbox = reinterpret_cast<float*>(smem + Sh::MERGE_OFFSET);
  float* wts = inbox + kMaxSplit * Sh::PART_FLOATS;   // [GMAX][kMaxSplit + 2]
  if (threadIdx.x < G)
    merge_weights<D, GMAX, kWarps>(parts, kWarps, threadIdx.x, wts + threadIdx.x * (kMaxSplit + 2));
  __syncthreads();
  cluster_wait();   // phase 0: every block of the cluster runs, rank 0's inbox exists

  // the block's merge of its warps' partials, in warp order, stored through
  // distributed shared memory into this block's slot of rank 0's inbox
  const Part<D, GMAX> slot{cluster.map_shared_rank(inbox, 0) + split * Sh::PART_FLOATS};
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    const float* w = wts + g * (kMaxSplit + 2);
    slot.acc(g, d) = merge_acc<D, GMAX, kWarps>(parts, kWarps, g, d, w);
    if (d == 0) { slot.m(g) = w[kWarps]; slot.l(g) = w[kWarps + 1]; }
  }
  cluster_arrive_release();   // phase 1: this block's record is in the inbox
  if (split != 0) return;     // no block reads the shared memory of another rank
  cluster_wait();             // phase 1: every rank's record has arrived

  // rank 0: the cluster's merge of the inbox, in rank order
  if (threadIdx.x < G)
    merge_weights<D, GMAX, kMaxSplit>(inbox, n_split, threadIdx.x,
                                      wts + threadIdx.x * (kMaxSplit + 2));
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * D; idx += kThreads) {
    const int g = idx / D, d = idx % D;
    const float* w = wts + g * (kMaxSplit + 2);
    const float L = w[kMaxSplit + 1];
    const float o = merge_acc<D, GMAX, kMaxSplit>(inbox, n_split, g, d, w);
    out[((size_t)b * H + h0 + g) * D + d] = from_float<T>(L > 0.f ? o / L : 0.f);
  }
  if (lse != nullptr && threadIdx.x < G) {
    const float* w = wts + threadIdx.x * (kMaxSplit + 2);
    lse[(size_t)b * H + h0 + threadIdx.x] =
        uniform ? -1e30f : w[kMaxSplit] + logf(w[kMaxSplit + 1]);
  }
}

// The wide route (head dims above 256, D a multiple of 64): each cluster
// takes one slice of kWideW columns of V and of the output, and computes
// the scores over the whole K row, in chunks of kWideW columns read straight
// from device memory (a lane's 8 consecutive elements a chunk; q, small and
// read by every key, through the L1). One K+V row pair is 4 KB at D 512 in
// f32 and grows with D, past what a ring stage of the kernel above holds,
// and its registers (q and acc over the whole row) grow with D too; a slice
// keeps acc at 8 floats a lane and head at any D. The price is K, read once
// per slice (ceil(D / 256) times; the slices of a kv head run side by side,
// so the repeats mostly hit the L2), and its scores, computed once per
// slice. The warps' pieces of the valid range, the merges and the cluster
// exchange are the kernel's above.
constexpr int kWideW = 256;

template <int GMAX>
struct WideShape {
  static constexpr int EPL = kWideW / 32;                            // 8 columns a lane
  static constexpr int KEYS = 4;
  static constexpr int PART_FLOATS = Part<kWideW, GMAX>::FLOATS;
  static constexpr int MERGE_OFFSET = kWarps * PART_FLOATS * 4;      // the warps' partials
  static constexpr int SMEM = MERGE_OFFSET + (kMaxSplit * PART_FLOATS + GMAX * (kMaxSplit + 2)) * 4;
};

template <typename T, int GMAX>
__global__ void __launch_bounds__(kThreads)
decode_wide_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const int* __restrict__ lengths, T* __restrict__ out, float* __restrict__ lse,
                   int S, int H, int KV, int D, int offset, int window, float softcap,
                   float scale, int Gc, int n_slices) {
  using Sh = WideShape<GMAX>;
  constexpr int EPL = Sh::EPL, KEYS = Sh::KEYS;
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_split = gridDim.x;                 // = the cluster's size
  const int split = blockIdx.x, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // grid y: (kv head, chunk of its group, slice of the columns)
  const int Gt = H / KV, per_kv = gridDim.y / KV;
  const int kvh = blockIdx.y / per_kv, rest = blockIdx.y % per_kv;
  const int g0 = (rest / n_slices) * Gc, slice = rest % n_slices;
  const int G = min(Gc, Gt - g0), h0 = kvh * Gt + g0;
  const int c0 = slice * kWideW, width = min(kWideW, D - c0);

  const int length = lengths[b] - offset;
  int hi = min(length, S);
  int lo = window > 0 ? max(length - window, 0) : 0;
  const bool uniform = hi <= lo;      // no valid key: softmax is uniform over S
  if (uniform) { lo = 0; hi = S; }
  const int pieces = n_split * kWarps;
  const int per = (hi - lo + pieces - 1) / pieces;
  const int s0 = min(hi, lo + (split * kWarps + warp) * per);
  const int s1 = min(hi, s0 + per);
  cluster_arrive_relaxed();   // phase 0: this block runs (waited for before the merge)

  const size_t row = static_cast<size_t>(KV) * D;
  const T* kb = k + (static_cast<size_t>(b) * S * KV + kvh) * D + lane * EPL;
  const T* vb = v + (static_cast<size_t>(b) * S * KV + kvh) * D + c0 + lane * EPL;
  const T* qb = q + (static_cast<size_t>(b) * H + h0) * D + lane * EPL;
  const bool vlane = lane * EPL < width;   // this lane holds columns of the slice

  float m[GMAX], l[GMAX], acc[GMAX][EPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  for (int key0 = s0; key0 < s1; key0 += KEYS) {
    bool ok[KEYS];
    float part[KEYS][GMAX], vr[KEYS][EPL];
#pragma unroll
    for (int j = 0; j < KEYS; ++j) {
      ok[j] = key0 + j < s1;
#pragma unroll
      for (int g = 0; g < GMAX; ++g) part[j][g] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) vr[j][e] = 0.f;
      if (ok[j] && vlane) load_row<T, EPL>(vb + static_cast<size_t>(key0 + j) * row, vr[j]);
    }
    // this lane's share of q.k over the whole row, chunk by chunk in order
    for (int c = 0; c < D; c += kWideW) {
      if (lane * EPL >= D - c) continue;   // past the last chunk's width
      float kr[KEYS][EPL];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[j][e] = 0.f;
        if (ok[j]) load_row<T, EPL>(kb + static_cast<size_t>(key0 + j) * row + c, kr[j]);
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        if (g >= G) continue;
        float qv[EPL];
        load_row<T, EPL>(qb + static_cast<size_t>(g) * D + c, qv);
#pragma unroll
        for (int j = 0; j < KEYS; ++j)
#pragma unroll
          for (int e = 0; e < EPL; ++e) part[j][g] = fmaf(qv[e], kr[j][e], part[j][g]);
      }
    }
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      if (g >= G) continue;
      float sc[KEYS];
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        float x = warp_sum(part[j][g]) * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        if (uniform) x = 0.f;
        sc[j] = ok[j] ? x : -INFINITY;
      }
      float mx = sc[0];
#pragma unroll
      for (int j = 1; j < KEYS; ++j) mx = fmaxf(mx, sc[j]);
      const float m_new = fmaxf(m[g], mx);      // finite: key key0 is always valid
      const float alpha = expf(m[g] - m_new);   // exp(-inf) = 0 on the first key
      float p[KEYS];
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < KEYS; ++j) {
        p[j] = ok[j] ? expf(sc[j] - m_new) : 0.f;
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

  // each warp's partial into shared memory
  float* parts = reinterpret_cast<float*>(smem);
  const Part<kWideW, GMAX> mine{parts + warp * Sh::PART_FLOATS};
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int e = 0; e < EPL; ++e) mine.acc(g, lane * EPL + e) = acc[g][e];
    if (lane == 0) { mine.m(g) = m[g]; mine.l(g) = l[g]; }
  }
  __syncthreads();
  float* inbox = reinterpret_cast<float*>(smem + Sh::MERGE_OFFSET);
  float* wts = inbox + kMaxSplit * Sh::PART_FLOATS;   // [GMAX][kMaxSplit + 2]
  if (threadIdx.x < G)
    merge_weights<kWideW, GMAX, kWarps>(parts, kWarps, threadIdx.x,
                                        wts + threadIdx.x * (kMaxSplit + 2));
  __syncthreads();
  cluster_wait();   // phase 0: every block of the cluster runs, rank 0's inbox exists

  const Part<kWideW, GMAX> slot{cluster.map_shared_rank(inbox, 0) + split * Sh::PART_FLOATS};
  for (int idx = threadIdx.x; idx < G * width; idx += kThreads) {
    const int g = idx / width, d = idx % width;
    const float* w = wts + g * (kMaxSplit + 2);
    slot.acc(g, d) = merge_acc<kWideW, GMAX, kWarps>(parts, kWarps, g, d, w);
    if (d == 0) { slot.m(g) = w[kWarps]; slot.l(g) = w[kWarps + 1]; }
  }
  cluster_arrive_release();   // phase 1: this block's record is in the inbox
  if (split != 0) return;     // no block reads the shared memory of another rank
  cluster_wait();             // phase 1: every rank's record has arrived

  if (threadIdx.x < G)
    merge_weights<kWideW, GMAX, kMaxSplit>(inbox, n_split, threadIdx.x,
                                           wts + threadIdx.x * (kMaxSplit + 2));
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * width; idx += kThreads) {
    const int g = idx / width, d = idx % width;
    const float* w = wts + g * (kMaxSplit + 2);
    const float L = w[kMaxSplit + 1];
    const float o = merge_acc<kWideW, GMAX, kMaxSplit>(inbox, n_split, g, d, w);
    out[(static_cast<size_t>(b) * H + h0 + g) * D + c0 + d] = from_float<T>(L > 0.f ? o / L : 0.f);
  }
  if (lse != nullptr && slice == 0 && threadIdx.x < G) {
    const float* w = wts + threadIdx.x * (kMaxSplit + 2);
    lse[static_cast<size_t>(b) * H + h0 + threadIdx.x] =
        uniform ? -1e30f : w[kMaxSplit] + logf(w[kMaxSplit + 1]);
  }
}

// Launch `kernel` with `smem` bytes of dynamic shared memory on the grid
// (n_split, gy, B), a cluster of n_split blocks along x.
template <typename... Params, typename... Args>
cudaError_t launch_cluster(void (*kernel)(Params...), std::atomic<uint64_t>& smem_set, int smem,
                           int n_split, int gy, int B, cudaStream_t stream, Args... args) {
  const cudaError_t attr = set_smem_once(smem_set, kernel, smem);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, gy, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = n_split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The arguments every instance takes, as the C entry gets them.
struct Call {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float* lse;
  int B, S, H, KV, D, offset, window;
  float softcap, scale;
  int n_split;
  cudaStream_t stream;
};

// How a kv head's group of G query heads is cut for the grid's y axis:
// chunks of at most Gc heads, a cluster each, all in one launch. A group up
// to 16 is one chunk on the kernel above (the instance of its size, as
// always). A larger group, and any group above 2 on the wide kernel, takes
// chunks of at most 2 heads: a multi-query layout has few kv heads, so one
// cluster a kv head would leave most SMs idle over a long cache, and each
// (key, head) costs a warp-wide reduction; small chunks spread that work
// over many clusters, each reading K/V again (mostly from L2). On an H100
// over a full 4096-key cache, chunks of 1, 2, 4 and 8 heads took 61.9,
// 53.1, 66.5 and 99.1 us at group 32, head dim 64 (100.3 us at 2 for group
// 71), and the wide kernel 418.7, 287.6, 510.2 and 821.0 us at group 32,
// head dim 512 (where each head's q is read through the L1 a key).
inline void group_chunks(int G, bool wide, int& chunks, int& Gc) {
  const int cap = !wide && G <= 16 ? 16 : 2;
  chunks = (G + cap - 1) / cap;
  Gc = (G + chunks - 1) / chunks;
}

template <typename T, int D, int GMAX>
cudaError_t launch(const Call& a, int Gc, int chunks) {
  static std::atomic<uint64_t> smem_set{0};
  return launch_cluster(decode_attention_kernel<T, D, GMAX>, smem_set, Shape<T, D, GMAX>::SMEM,
                        a.n_split, a.KV * chunks, a.B, a.stream, static_cast<const T*>(a.q),
                        static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lengths,
                        static_cast<T*>(a.out), a.lse, a.S, a.H, a.KV, a.offset, a.window,
                        a.softcap, a.scale, Gc);
}

template <typename T, int GMAX>
cudaError_t launch_wide(const Call& a, int Gc, int chunks) {
  static std::atomic<uint64_t> smem_set{0};
  const int n_slices = (a.D + kWideW - 1) / kWideW;
  if (static_cast<long long>(a.KV) * chunks * n_slices > 65535) return cudaErrorInvalidValue;
  return launch_cluster(decode_wide_kernel<T, GMAX>, smem_set, WideShape<GMAX>::SMEM, a.n_split,
                        a.KV * chunks * n_slices, a.B, a.stream, static_cast<const T*>(a.q),
                        static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lengths,
                        static_cast<T*>(a.out), a.lse, a.S, a.H, a.KV, a.D, a.offset, a.window,
                        a.softcap, a.scale, Gc, n_slices);
}

template <typename T, int D>
cudaError_t dispatch_group(const Call& a) {
  int chunks, Gc;
  group_chunks(a.H / a.KV, false, chunks, Gc);
  if (static_cast<long long>(a.KV) * chunks > 65535) return cudaErrorInvalidValue;
  if (Gc <= 1) return launch<T, D, 1>(a, Gc, chunks);
  if (Gc <= 2) return launch<T, D, 2>(a, Gc, chunks);
  if (Gc <= 4) return launch<T, D, 4>(a, Gc, chunks);
  if (Gc <= 8) return launch<T, D, 8>(a, Gc, chunks);
  return launch<T, D, 16>(a, Gc, chunks);   // group_chunks keeps Gc <= 16
}

template <typename T>
cudaError_t dispatch_wide(const Call& a) {
  int chunks, Gc;
  group_chunks(a.H / a.KV, true, chunks, Gc);
  return Gc <= 1 ? launch_wide<T, 1>(a, Gc, chunks) : launch_wide<T, 2>(a, Gc, chunks);
}

template <typename T>
cudaError_t dispatch_dim(const Call& a) {
  switch (a.D) {
    case 32: return dispatch_group<T, 32>(a);
    case 64: return dispatch_group<T, 64>(a);
    case 128: return dispatch_group<T, 128>(a);
    case 192: return dispatch_group<T, 192>(a);
    case 256: return dispatch_group<T, 256>(a);
    default: return a.D > 256 && a.D % 64 == 0 ? dispatch_wide<T>(a) : cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace repro

// C entry point. dtype: 0 = f32, 1 = bf16 (q, k, v and out share it, [...,
// D]). D: 32, 64, 128, 192, 256, or a multiple of 64 above 256 (the wide
// kernel). Dt <= D: the head dim the scores are scaled by (1 / sqrt(Dt)),
// the columns from Dt on being zeros the wrapper padded them with. lse:
// [B,H] f32 or null (not written). offset >= 0: key j is position offset + j.
// window <= 0 means no window; softcap <= 0 means no softcap. n_split (1..8)
// is the cluster size: the grid is (n_split, KV x chunks [x slices], B), one
// cluster per (slot, kv head, chunk of its group [, slice]). Returns the
// launch's error (0 on success).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* out, void* lse, int B,
                                      int S, int H, int KV, int Dt, int D, int dtype,
                                      int offset, int window, float softcap, int n_split,
                                      void* stream) {
  using namespace repro;
  if (B <= 0 || B > 65535 || S <= 0 || KV <= 0 || H % KV != 0 || offset < 0 ||
      n_split <= 0 || n_split > kMaxSplit || (dtype != 0 && dtype != 1) || Dt <= 0 || Dt > D)
    return static_cast<int>(cudaErrorInvalidValue);
  const Call a{q, k, v, static_cast<const int*>(lengths), out, static_cast<float*>(lse),
               B, S, H, KV, D, offset, window, softcap, 1.0f / sqrtf(static_cast<float>(Dt)),
               n_split, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(dtype == 0 ? dispatch_dim<float>(a) : dispatch_dim<__nv_bfloat16>(a));
}
