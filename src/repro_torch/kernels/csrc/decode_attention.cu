// Decode attention for Hopper (sm_90a): one query token per (slot, head)
// against a KV cache held at kv heads. Two routes (ops.decode_plan): the
// kernel below for head groups up to 16 at D <= 256, in one launch; the
// group route further down for larger groups and any D above 256, in one
// launch or two (its second merge).
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
//   256}, or above 256 a multiple of 64 on the group route; the wrapper
//   pads any other Dt up to the next with zero columns),
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
//     head) takes the group route, which reads K/V once for the whole group.
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

// ---------------------------------------------------------------------------
// The group route: every call with a head group above 16 at D <= 256, and
// every call with D above 256 (a multiple of 32) at any group. The kernel
// above keeps a warp's G heads in registers with lanes over head dims; that
// stops at 16 heads and 256 columns. Here the block streams its piece of
// the valid range once for all Gc heads of its chunk:
//   * K/V are read once per (slot, kv head, key piece). The ring holds
//     panels of TK keys x DC columns of K or of V (the plan's DC, at most
//     kGroupMaxCols), 16-byte cp.async into kGroupStages stages, so the next
//     panels are in flight while one is consumed: per tile of TK keys the K
//     panels of its column chunks, then its V panels. q is staged in shared
//     memory once, as stored, with panel 0.
//   * Each score is computed once, with threads over (heads, keys), never a
//     warp reduction per (key, head). Tile mode: a thread owns HU heads x 4
//     keys of the tile and a group of CS column groups; its partial q.k runs
//     over the K panels of the tile in column order, the CS partials of a
//     score are summed in group order, and the tile's online softmax of a
//     head (max, rescale, sum of p in key order) is a fixed butterfly over
//     the lanes that hold its keys. Row mode, where a tile has at most
//     kGroupRowScores scores (small groups, wide rows): a score a thread
//     slot, its columns cut into ranges over the block's warps, the ranges'
//     partials summed in range order.
//   * V and the output are accumulated over all D columns in the block:
//     acc [Gc][D] f32 in shared memory, each (HU heads x 4 columns) owned by
//     one thread over a panel (alpha, then p V in key order).
//   * Head chunks only where acc does not fit: Gc D <= kGroupAccFloats
//     (16384, 64 KB), so a group is one chunk up to 256 heads at D 64, 32
//     at D 512, 16 at D 1024 (ops.decode_plan; the chunks on grid y).
//   * Enough blocks for the card: n_clu clusters of `cluster` blocks (at
//     most kGroupMaxCluster) per (slot, kv head, chunk), one contiguous key
//     piece a block, each piece at least a tile (a short valid range takes
//     the first pieces only).
//     Ranks 1 .. cluster - 1 store their (acc, m, l) into rank 0's inbox
//     through distributed shared memory and exit; rank 0 merges in rank
//     order. Where the valid range spans several clusters, each rank 0
//     writes its record (M, L, o) to the scratch `part` (allocated by the
//     wrapper) and decode_group_merge_kernel merges the records in range
//     order; where it lies in cluster 0 alone, cluster 0 writes the output
//     and the second merge returns at once. No atomics: the same bits on
//     every call.
// What bounds it: bytes at a full cache and small groups (each valid K/V
// row once); at large groups the f32 CUDA-core arithmetic (4 Gc D flops a
// key) fed from shared memory (a 4 x 4 register tile reads 2 floats a
// product: the shared-memory wavefronts, not the FMA units, set the pace);
// at 64 keys latency: two dependent round trips to memory (lengths, then
// the rows), the tile's barriers and the merges.
constexpr int kGroupThreads = 256;
constexpr int kGroupStages = 5;          // panels of the ring
constexpr int kGroupMaxCluster = 2;      // a cluster's blocks at most (ops.GROUP_CLUSTER)
constexpr int kGroupMaxSmem = 232448;    // 227 KB: what one block may have
constexpr int kGroupMaxCS = 16;          // column groups of a score at most
constexpr int kGroupAccFloats = 16384;   // Gc x D accumulators a block at most
constexpr int kGroupMaxRecords = 1024;   // clusters per (slot, kv head, chunk) at most
constexpr int kGroupMaxCols = 256;       // columns of a ring panel at most
constexpr int kGroupRowScores = 64;      // scores a tile in row mode at most

// Heads a thread takes at once: 1 for a chunk of 1 or 2, else 4 (the chunk
// padded to a multiple of 4 with zero q rows).
__host__ __device__ constexpr int group_hu(int Gc) { return Gc <= 2 ? 1 : 4; }

// The column groups of a score: as many as leave no thread of the block
// without a (heads x keys) tile to score, at most kGroupMaxCS and DC / 4.
__host__ __device__ inline int group_cs(int Gp, int HU, int TK, int DC) {
  const int tiles = Gp / HU * (TK / 4);
  int cs = 1;
  while (cs * 2 * tiles <= kGroupThreads && cs * 2 <= kGroupMaxCS && cs * 2 <= DC / 4) cs *= 2;
  return cs;
}

// The arguments of the group kernels: the C entry's, the plan's included.
struct GroupArgs {
  const void *q, *k, *v;
  const int* lengths;
  void* out;
  float* lse;
  float* part;   // [B][KV x chunks][n_clu][group_rec(Gc, D)] f32, read only when n_clu > 1
  int S, H, KV, D, offset, window;
  float softcap, scale;
  int Gc, chunks, cluster, n_clu, TK, DC;
};

// Floats of a cluster's record in `part`: o [Gc][D], then M [Gc] and L
// [Gc], padded to a multiple of 4 (16-byte stores of o).
__host__ __device__ constexpr int group_rec(int Gc, int D) { return (Gc * (D + 2) + 3) & ~3; }

// Shared memory of one block (float offsets, each a multiple of 4): q
// [Gp] rows of D elements as stored and 16 bytes of pad, acc [Gp][D] f32,
// the tile's scores / p [TK][Gp], the column groups' partial scores (a
// float a thread at least: row mode's), m, l, alpha [Gp], the inbox of
// cluster - 1 records (acc [Gp][D], m, l [Gp], padded to a multiple of 4)
// that the other ranks store into rank 0's; then the ring of kGroupStages
// panels of TK rows of DC elements and 16 bytes of pad (rows 16 bytes
// apart in the banks).
struct GroupLayout {
  int q, qrow, acc, sc, red, m, l, al, inbox, irec, ring, row, panel, bytes;
  __host__ __device__ static int up4(int n) { return (n + 3) & ~3; }
  __host__ __device__ GroupLayout(int Gp, int D, int TK, int DC, int CS, int cluster, int el) {
    q = 0;
    qrow = D * el + 16;   // bytes
    acc = q + Gp * qrow / 4;
    sc = acc + up4(Gp * D);
    red = sc + up4(TK * Gp);
    m = red + (CS * TK * Gp > kGroupThreads ? up4(CS * TK * Gp) : kGroupThreads);
    l = m + up4(Gp);
    al = l + up4(Gp);
    inbox = al + up4(Gp);
    irec = up4(Gp * (D + 2));
    ring = (inbox + (cluster - 1) * irec) * 4;   // bytes
    row = DC * el + 16;
    panel = TK * row;
    bytes = ring + kGroupStages * panel;
  }
};

// The valid range of a slot, as the kernel above derives it: [lo, hi) in
// local key indices; with no valid key the whole cache, uniformly. It is cut
// into contiguous pieces of `per` keys, at least a tile each, so a short
// range takes the first pieces only; `one` when they all lie in cluster 0,
// which then writes the output itself (the second merge has nothing to do).
struct ValidRange {
  int lo, hi, per;
  bool uniform, one;
  __device__ ValidRange(const GroupArgs& a, int b, int pieces) {
    const int length = a.lengths[b] - a.offset;
    hi = min(length, a.S);
    lo = a.window > 0 ? max(length - a.window, 0) : 0;
    uniform = hi <= lo;   // no valid key: softmax is uniform over S
    if (uniform) { lo = 0; hi = a.S; }
    per = max((hi - lo + pieces - 1) / pieces, a.TK);
    one = a.n_clu == 1 || (hi - lo + per - 1) / per <= a.cluster;
  }
};

template <typename T, int HU>
__global__ void __launch_bounds__(kGroupThreads, 2)
decode_group_kernel(const GroupArgs a) {
  constexpr int NT = kGroupThreads;
  constexpr int EV = 16 / static_cast<int>(sizeof(T));   // elements of a 16-byte copy
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  const int c = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());
  const int pieces = gridDim.x, piece = blockIdx.x, clu = piece / c, b = blockIdx.z;
  // this block's chunk of the kv head's group: query heads h0 .. h0 + G - 1
  const int kvh = blockIdx.y / a.chunks, g0 = (blockIdx.y % a.chunks) * a.Gc;
  const int Gt = a.H / a.KV, G = min(a.Gc, Gt - g0), h0 = kvh * Gt + g0;
  const int Gp = (a.Gc + HU - 1) / HU * HU;
  const int D = a.D, TK = a.TK, DC = a.DC;
  const int nch = (D + DC - 1) / DC;   // column chunks of a row
  const int CS = group_cs(Gp, HU, TK, DC);
  const GroupLayout L(Gp, D, TK, DC, CS, c, sizeof(T));
  float* f = reinterpret_cast<float*>(smem);
  unsigned char* qs = smem + 4 * L.q;
  float *acc = f + L.acc, *sc = f + L.sc, *red = f + L.red;
  float *mm = f + L.m, *ll = f + L.l, *al = f + L.al;
  unsigned char* ring = smem + L.ring;

  // this block's contiguous piece [s0, s1) of the valid range
  const ValidRange vr(a, b, pieces);
  if (vr.one && clu > 0) return;   // the whole range lies in cluster 0
  const int s0 = min(vr.hi, vr.lo + piece * vr.per), s1 = min(vr.hi, s0 + vr.per);
  const int n_panels = (s1 - s0 + TK - 1) / TK * 2 * nch;
  if (c > 1) cluster_arrive_relaxed();   // phase 0: this block runs (waited for before the merge)

  // panel p: tile p / (2 nch); its K column chunks, then its V ones
  const size_t row = static_cast<size_t>(a.KV) * D;
  const T* kb = static_cast<const T*>(a.k) + (static_cast<size_t>(b) * a.S * a.KV + kvh) * D;
  const T* vb = static_cast<const T*>(a.v) + (static_cast<size_t>(b) * a.S * a.KV + kvh) * D;
  auto issue = [&](int p) {
    if (p < n_panels) {
      const int i = p / (2 * nch), r = p % (2 * nch), c0 = (r % nch) * DC;
      const int key0 = s0 + i * TK, nk = min(TK, s1 - key0);
      const int cpr = min(DC, D - c0) / EV;   // 16-byte copies a row, at most NT
      const T* src = (r < nch ? kb : vb) + static_cast<size_t>(key0) * row + c0;
      unsigned char* st = ring + (p % kGroupStages) * L.panel;
      const int step = NT / cpr, ch = tid % cpr;   // rows copied at once; this thread's piece
      for (int j = tid / cpr; j < nk && tid < step * cpr; j += step)
        cp_async_16(st + j * L.row + ch * 16, src + j * row + ch * EV);
    }
    cp_async_commit();   // an empty group past the last panel keeps the count
  };
  // q's rows by cp.async in panel 0's group (zeros past the chunk's G)
  const T* qb = static_cast<const T*>(a.q) + (static_cast<size_t>(b) * a.H + h0) * D;
  for (int x = tid; x < Gp * (D / EV); x += NT) {
    const int g = x / (D / EV), ch = x - g * (D / EV);
    unsigned char* dst = qs + g * L.qrow + ch * 16;
    if (g < G)
      cp_async_16(dst, qb + static_cast<size_t>(g) * D + ch * EV);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
  }
#pragma unroll
  for (int p = 0; p < kGroupStages - 1; ++p) issue(p);
  for (int x = tid; x < Gp * D / 4; x += NT)
    reinterpret_cast<float4*>(acc)[x] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int g = tid; g < Gp; g += NT) {
    mm[g] = -INFINITY;
    ll[g] = 0.f;
  }

  // this thread's score tile: heads hu HU .. + HU - 1, keys ku + KU e (e < 4;
  // neighbouring threads on neighbouring rows), column groups cs + CS n
  const int KU = TK / 4, tiles = Gp / HU * KU;
  const bool scorer = tid < tiles * CS;
  const int cs = tid % CS, ku = (tid / CS) % KU, hu = tid / CS / KU;
  float s[HU][4];
  // row mode, where a tile holds few scores (small groups, wide rows): a
  // thread a (key, head), the whole row's q.k its own
  const bool rows = Gp * TK <= kGroupRowScores && TK <= 32;
  const int RS = (Gp * TK + 31) / 32 * 32, RW = NT / RS;   // score slots; column ranges
  const int ru = tid % RS, rg = tid / RS;
  float srow[16];
  for (int p = 0; p < n_panels; ++p) {
    cp_async_wait<kGroupStages - 2>();   // this thread's copies of panel p have landed
    __syncthreads();                     // and every thread's; panel p - 1 is consumed
    issue(p + kGroupStages - 1);         // into the stage panel p - 1 held
    const int i = p / (2 * nch), r = p % (2 * nch), c0 = (r % nch) * DC;
    const int w4 = min(DC, D - c0) / 4;   // 4-column groups of the panel
    const int nk = min(TK, s1 - (s0 + i * TK));
    const unsigned char* st = ring + (p % kGroupStages) * L.panel;
    if (r < nch && rows) {
      // a K panel, row mode: score u = (key u % TK, head u / TK) of the
      // tile in RS slots, the chunk's columns cut into RW contiguous
      // ranges, a warp group each; a thread's q.k over its range in 16
      // partial sums (column 4 f + x to sum 4 (f mod 4) + x), carried over
      // the tile's K panels in column order
      if (ru < Gp * TK) {
        if (r == 0) {
#pragma unroll
          for (int x = 0; x < 16; ++x) srow[x] = 0.f;
        }
        const int f0 = rg * (w4 / RW), f1 = f0 + w4 / RW;   // w4 is a multiple of 8
        const T* kr = reinterpret_cast<const T*>(st + (ru % TK) * L.row);
        const T* qr = reinterpret_cast<const T*>(qs + (ru / TK) * L.qrow) + c0;
        for (int f4 = f0; f4 < f1; f4 += 4) {   // w4 is a multiple of 8: RW divides it
          float kx[4][4], qx[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (f4 + u < f1) {
              load_row<T, 4>(kr + 4 * (f4 + u), kx[u]);
              load_row<T, 4>(qr + 4 * (f4 + u), qx[u]);
            } else {
#pragma unroll
              for (int x = 0; x < 4; ++x) kx[u][x] = qx[u][x] = 0.f;
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int x = 0; x < 4; ++x) srow[4 * u + x] = fmaf(qx[u][x], kx[u][x], srow[4 * u + x]);
        }
      }
      if (r == nch - 1) {
        // the ranges' partial scores into shared memory, summed in range
        // order by the first group
        if (ru < Gp * TK) {
          float t[8];
#pragma unroll
          for (int x = 0; x < 8; ++x) t[x] = srow[x] + srow[x + 8];   // a fixed tree of the 16 sums
#pragma unroll
          for (int x = 0; x < 4; ++x) t[x] += t[x + 4];
          red[rg * RS + ru] = (t[0] + t[1]) + (t[2] + t[3]);
        }
        __syncthreads();
      }
      if (r == nch - 1 && tid < RS) {
        // the tile's online softmax: a head's TK keys on TK neighbouring
        // lanes, reduced by a fixed butterfly (each pairwise sum commutes:
        // every lane holds the same bits); no block barrier until the V
        // panel's
        const bool mine = tid < Gp * TK;
        const int j = tid % TK, g = tid / TK;
        float raw = 0.f;
        for (int w = 0; w < RW; ++w) raw += red[w * RS + tid];
        float y = raw * a.scale;
        if (a.softcap > 0.f) y = a.softcap * tanhf(y / a.softcap);
        if (vr.uniform) y = 0.f;
        const float x = mine && j < nk ? y : -INFINITY;
        float mx = x;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1)
          if (o < TK) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_old = mine ? mm[g] : -INFINITY;
        const float m_new = fmaxf(m_old, mx);   // finite: key 0 of a tile is valid
        const float pj = expf(x - m_new);       // 0 past the tile's keys
        float psum = pj;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1)
          if (o < TK) psum += __shfl_xor_sync(0xffffffffu, psum, o);
        if (mine) {
          sc[j * Gp + g] = pj;
          if (j == 0) {   // every lane of the head has read m_old (the butterflies)
            const float alpha = expf(m_old - m_new);   // 0 on the first tile
            ll[g] = ll[g] * alpha + psum;
            mm[g] = m_new;
            al[g] = alpha;
          }
        }
      }   // the next panel's barrier publishes p, alpha, m and l
    } else if (r < nch) {
      // a K panel, tile mode: this thread's partial q.k over its columns of
      // the chunk (rows from nk on are stale: their scores are masked below)
      if (scorer) {
        if (r == 0) {
#pragma unroll
          for (int h = 0; h < HU; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[h][e] = 0.f;
        }
#pragma unroll 2
        for (int f4 = cs; f4 < w4; f4 += CS) {
          float kx[4][4], qx[HU][4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            load_row<T, 4>(reinterpret_cast<const T*>(st + (ku + KU * e) * L.row) + 4 * f4, kx[e]);
#pragma unroll
          for (int h = 0; h < HU; ++h)
            load_row<T, 4>(reinterpret_cast<const T*>(qs + (hu * HU + h) * L.qrow) + c0 + 4 * f4, qx[h]);
#pragma unroll
          for (int h = 0; h < HU; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
#pragma unroll
              for (int x = 0; x < 4; ++x) s[h][e] = fmaf(qx[h][x], kx[e][x], s[h][e]);
        }
      }
      if (r == nch - 1) {
        // the tile's scores, by the thread of each score tile (tid < tiles):
        // the column groups' partials summed in group order, then the
        // online softmax of its heads over the tile. A head's TK keys lie
        // on KU neighbouring lanes of one warp (4 a lane), reduced by a
        // fixed butterfly (each pairwise sum commutes: every lane holds the
        // same bits); no block barrier until the V panel's
        if (CS > 1) {
          if (scorer) {
#pragma unroll
            for (int h = 0; h < HU; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) red[((h * 4 + e) * CS + cs) * tiles + tid / CS] = s[h][e];
          }
          __syncthreads();
          if (tid < tiles) {
#pragma unroll
            for (int h = 0; h < HU; ++h)
#pragma unroll
              for (int e = 0; e < 4; ++e) s[h][e] = 0.f;
#pragma unroll 4
            for (int y = 0; y < CS; ++y)   // the loads of four groups together
#pragma unroll
              for (int h = 0; h < HU; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[h][e] += red[((h * 4 + e) * CS + y) * tiles + tid];
          }
        }
        if (tid < (tiles + 31) / 32 * 32) {   // whole warps: a butterfly takes every lane
          const bool mine = tid < tiles;       // a score tile's thread; the rest idle along
          const int rku = tid % KU, rhu = tid / KU;
          float x[HU][4], mx[HU], m_old[HU], m_new[HU], psum[HU];
#pragma unroll
          for (int h = 0; h < HU; ++h) {
            mx[h] = -INFINITY;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float y = s[h][e] * a.scale;
              if (a.softcap > 0.f) y = a.softcap * tanhf(y / a.softcap);
              if (vr.uniform) y = 0.f;
              x[h][e] = mine && rku + KU * e < nk ? y : -INFINITY;
              mx[h] = fmaxf(mx[h], x[h][e]);
            }
          }
#pragma unroll
          for (int o = 1; o < 16; o <<= 1)   // KU <= 16: the heads' butterflies side by side
            if (o < KU) {
#pragma unroll
              for (int h = 0; h < HU; ++h) mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], o));
            }
#pragma unroll
          for (int h = 0; h < HU; ++h) {
            m_old[h] = mine ? mm[rhu * HU + h] : -INFINITY;
            m_new[h] = fmaxf(m_old[h], mx[h]);   // finite: key 0 of a tile is valid
            psum[h] = 0.f;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              x[h][e] = expf(x[h][e] - m_new[h]);   // p: 0 past the tile's keys
              psum[h] += x[h][e];
            }
          }
#pragma unroll
          for (int o = 1; o < 16; o <<= 1)
            if (o < KU) {
#pragma unroll
              for (int h = 0; h < HU; ++h) psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], o);
            }
          if (mine) {
#pragma unroll
            for (int h = 0; h < HU; ++h) {
              const int g = rhu * HU + h;
#pragma unroll
              for (int e = 0; e < 4; ++e) sc[(rku + KU * e) * Gp + g] = x[h][e];
              if (rku == 0) {   // every lane of the head has read m_old (the butterflies)
                const float alpha = expf(m_old[h] - m_new[h]);   // 0 on the first tile
                ll[g] = ll[g] * alpha + psum[h];
                mm[g] = m_new[h];
                al[g] = alpha;
              }
            }
          }
        }   // the next panel's barrier publishes p, alpha, m and l
      }
    } else {
      // a V panel: acc = acc alpha + p V over its columns, key by key
      const int units = Gp / HU * w4;
      for (int u = tid; u < units; u += NT) {
        const int cu = u % w4, hv = u / w4, d = c0 + 4 * cu;
        float o[HU][4];
#pragma unroll
        for (int h = 0; h < HU; ++h) {
          load_row<float, 4>(acc + (hv * HU + h) * D + d, o[h]);
          const float alpha = al[hv * HU + h];
#pragma unroll
          for (int e = 0; e < 4; ++e) o[h][e] *= alpha;
        }
#pragma unroll 4
        for (int j = 0; j < nk; ++j) {
          float vv[4], pp[HU];
          load_row<T, 4>(reinterpret_cast<const T*>(st + j * L.row) + 4 * cu, vv);
          load_row<float, HU>(sc + j * Gp + hv * HU, pp);
#pragma unroll
          for (int h = 0; h < HU; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[h][e] = fmaf(pp[h], vv[e], o[h][e]);
        }
#pragma unroll
        for (int h = 0; h < HU; ++h)
          *reinterpret_cast<float4*>(acc + (hv * HU + h) * D + d) =
              make_float4(o[h][0], o[h][1], o[h][2], o[h][3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const size_t orow = static_cast<size_t>(b) * a.H + h0;
  T* out = static_cast<T*>(a.out) + orow * D;
  if (c == 1 && vr.one) {   // the block held the whole valid range
    for (int x = tid; x < G * D; x += NT) {
      const float l = ll[x / D];
      out[x] = from_float<T>(l > 0.f ? acc[x] / l : 0.f);
    }
    if (a.lse != nullptr)
      for (int g = tid; g < G; g += NT) a.lse[orow + g] = vr.uniform ? -1e30f : mm[g] + logf(ll[g]);
    return;
  }

  // the cluster's merge: ranks 1 .. c - 1 store their (acc, m, l) into
  // rank 0's inbox through distributed shared memory and exit; rank 0 merges
  // its own and the inbox's in rank order (stores, not loads, cross the
  // cluster: no block waits on a remote round trip)
  if (c > 1) {
    cluster_wait();   // phase 0: every rank runs, rank 0's inbox exists
    if (rank != 0) {
      float* box = cluster.map_shared_rank(f + L.inbox, 0) + (rank - 1) * L.irec;
      for (int x = tid; x < G * D / 4; x += NT)
        reinterpret_cast<float4*>(box)[x] = reinterpret_cast<const float4*>(acc)[x];
      for (int g = tid; g < G; g += NT) {
        box[Gp * D + g] = mm[g];
        box[Gp * D + Gp + g] = ll[g];
      }
    }
    cluster_arrive_release();   // phase 1: this rank's record is in the inbox
    if (rank != 0) return;      // no block reads the shared memory of another rank
    cluster_wait();             // phase 1: every rank's record has arrived
  }
  const int REC = group_rec(a.Gc, D);
  float* rec = vr.one ? nullptr
                      : a.part + ((static_cast<size_t>(b) * gridDim.y + blockIdx.y) * a.n_clu + clu) * REC;
  const float* box = f + L.inbox;
  for (int x = tid; x < G * D / 4; x += NT) {
    const int g = 4 * x / D;
    // record r: this block's own (r = 0), else inbox slot r - 1
    auto rec_m = [&](int r) { return r == 0 ? mm[g] : box[(r - 1) * L.irec + Gp * D + g]; };
    auto rec_l = [&](int r) { return r == 0 ? ll[g] : box[(r - 1) * L.irec + Gp * D + Gp + g]; };
    float M = -INFINITY;
    for (int r = 0; r < c; ++r)
      if (rec_l(r) > 0.f) M = fmaxf(M, rec_m(r));
    float Lsum = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < c; ++r) {
      const float lr = rec_l(r), w = lr > 0.f ? expf(rec_m(r) - M) : 0.f;   // no key: weight 0
      Lsum = fmaf(w, lr, Lsum);
      if (w > 0.f) {
        const float4 y = reinterpret_cast<const float4*>(r == 0 ? acc : box + (r - 1) * L.irec)[x];
        o[0] = fmaf(w, y.x, o[0]);
        o[1] = fmaf(w, y.y, o[1]);
        o[2] = fmaf(w, y.z, o[2]);
        o[3] = fmaf(w, y.w, o[3]);
      }
    }
    const bool first = 4 * x == g * D;   // the head's first 4 columns: its lse or (M, L)
    if (vr.one) {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[4 * x + e] = from_float<T>(Lsum > 0.f ? o[e] / Lsum : 0.f);
      if (first && a.lse != nullptr) a.lse[orow + g] = vr.uniform ? -1e30f : M + logf(Lsum);
    } else {
      *reinterpret_cast<float4*>(rec + 4 * x) = make_float4(o[0], o[1], o[2], o[3]);
      if (first) {
        rec[a.Gc * D + g] = M;
        rec[a.Gc * D + a.Gc + g] = Lsum;
      }
    }
  }
}

// The second merge (n_clu > 1): the clusters' records (M, L, o) of one
// (slot, kv head, chunk), in range order. A block per head: the records'
// (M, L) into shared memory, the weights and their sum L in record order;
// then threads over (4 columns, a share of the records: record k to share
// k mod P), each share summed in record order and the shares in share order.
template <typename T>
__global__ void __launch_bounds__(kGroupThreads)
decode_group_merge_kernel(const GroupArgs a) {
  constexpr int NT = kGroupThreads;
  __shared__ float ms[kGroupMaxRecords], ws[kGroupMaxRecords];
  __shared__ float4 shares[NT];
  const int tid = threadIdx.x, b = blockIdx.z, g = blockIdx.x;
  const int kvh = blockIdx.y / a.chunks, g0 = (blockIdx.y % a.chunks) * a.Gc;
  const int Gt = a.H / a.KV, G = min(a.Gc, Gt - g0), h0 = kvh * Gt + g0;
  const ValidRange vr(a, b, a.cluster * a.n_clu);
  if (g >= G || vr.one) return;   // cluster 0 wrote the output
  const int D = a.D, D4 = D / 4, n = a.n_clu, REC = group_rec(a.Gc, D);
  const float* rec = a.part + (static_cast<size_t>(b) * gridDim.y + blockIdx.y) * n * REC;
  for (int k = tid; k < n; k += NT) {
    ms[k] = rec[static_cast<size_t>(k) * REC + a.Gc * D + g];
    ws[k] = rec[static_cast<size_t>(k) * REC + a.Gc * D + a.Gc + g];   // L_k, for now
  }
  __syncthreads();
  float M = -INFINITY;
  for (int k = 0; k < n; ++k)
    if (ws[k] > 0.f) M = fmaxf(M, ms[k]);
  float Lsum = 0.f;
  for (int k = 0; k < n; ++k) Lsum = fmaf(ws[k] > 0.f ? expf(ms[k] - M) : 0.f, ws[k], Lsum);
  __syncthreads();   // every thread has read L_k
  for (int k = tid; k < n; k += NT) ws[k] = ws[k] > 0.f ? expf(ms[k] - M) : 0.f;
  __syncthreads();
  const size_t orow = static_cast<size_t>(b) * a.H + h0 + g;
  T* out = static_cast<T*>(a.out) + orow * D;
  const int P = D4 >= NT ? 1 : NT / D4;   // shares of the records
  for (int d4 = tid % min(D4, NT); d4 < D4; d4 += NT) {
    const int share = tid / min(D4, NT);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (share < P) {
#pragma unroll 4
      for (int k = share; k < n; k += P) {
        const float w = ws[k];
        if (w > 0.f) {
          const float4 y = *reinterpret_cast<const float4*>(rec + static_cast<size_t>(k) * REC + g * D + 4 * d4);
          o.x = fmaf(w, y.x, o.x);
          o.y = fmaf(w, y.y, o.y);
          o.z = fmaf(w, y.z, o.z);
          o.w = fmaf(w, y.w, o.w);
        }
      }
    }
    if (P > 1) {
      shares[tid] = o;
      __syncthreads();
      if (share != 0) continue;   // P > 1: one pass, no barrier after this
      o = shares[d4];
      for (int s2 = 1; s2 < P; ++s2) {
        const float4 y = shares[s2 * D4 + d4];
        o.x += y.x;
        o.y += y.y;
        o.z += y.z;
        o.w += y.w;
      }
    }
    const float ov[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) out[4 * d4 + e] = from_float<T>(Lsum > 0.f ? ov[e] / Lsum : 0.f);
  }
  if (tid == 0 && a.lse != nullptr) a.lse[orow] = vr.uniform ? -1e30f : M + logf(Lsum);
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

// The arguments every instance of the kernel above takes, as the C entry
// gets them.
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

template <typename T, int D, int GMAX>
cudaError_t launch(const Call& a, int G) {
  static std::atomic<uint64_t> smem_set{0};
  return launch_cluster(decode_attention_kernel<T, D, GMAX>, smem_set, Shape<T, D, GMAX>::SMEM,
                        a.n_split, a.KV, a.B, a.stream, static_cast<const T*>(a.q),
                        static_cast<const T*>(a.k), static_cast<const T*>(a.v), a.lengths,
                        static_cast<T*>(a.out), a.lse, a.S, a.H, a.KV, a.offset, a.window,
                        a.softcap, a.scale, G);
}

// A group up to 16 on the instance of its size; a larger one takes the
// group route (repro_decode_group).
template <typename T, int D>
cudaError_t dispatch_group(const Call& a) {
  const int G = a.H / a.KV;
  if (G <= 1) return launch<T, D, 1>(a, G);
  if (G <= 2) return launch<T, D, 2>(a, G);
  if (G <= 4) return launch<T, D, 4>(a, G);
  if (G <= 8) return launch<T, D, 8>(a, G);
  if (G <= 16) return launch<T, D, 16>(a, G);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_dim(const Call& a) {
  switch (a.D) {
    case 32: return dispatch_group<T, 32>(a);
    case 64: return dispatch_group<T, 64>(a);
    case 128: return dispatch_group<T, 128>(a);
    case 192: return dispatch_group<T, 192>(a);
    case 256: return dispatch_group<T, 256>(a);
    default: return cudaErrorInvalidValue;   // above 256: the group route
  }
}

// The group kernel of HU on the grid (cluster x n_clu, KV x chunks, B), a
// cluster of `cluster` blocks along x, then the second merge when n_clu > 1.
template <typename T, int HU>
cudaError_t launch_group(const GroupArgs& g, int B, int cluster, cudaStream_t stream) {
  static std::atomic<uint64_t> attrs_set{0};
  auto kernel = decode_group_kernel<T, HU>;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(attrs_set.load(std::memory_order_acquire) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kGroupMaxSmem);
    if (err != cudaSuccess) return err;
    attrs_set.fetch_or(bit, std::memory_order_release);
  }
  const int Gp = (g.Gc + HU - 1) / HU * HU;
  const GroupLayout L(Gp, g.D, g.TK, g.DC, group_cs(Gp, HU, g.TK, g.DC), cluster,
                      static_cast<int>(sizeof(T)));
  if (L.bytes > kGroupMaxSmem || Gp / HU * (g.TK / 4) > kGroupThreads) return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * g.n_clu, g.KV * g.chunks, B);
  cfg.blockDim = dim3(kGroupThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, g);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err != cudaSuccess || g.n_clu == 1) return err;
  const dim3 grid(g.Gc, g.KV * g.chunks, B);
  decode_group_merge_kernel<T><<<grid, kGroupThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hu(const GroupArgs& g, int B, int cluster, cudaStream_t stream) {
  return group_hu(g.Gc) == 1 ? launch_group<T, 1>(g, B, cluster, stream)
                             : launch_group<T, 4>(g, B, cluster, stream);
}

}  // namespace
}  // namespace repro

// C entry points. dtype: 0 = f32, 1 = bf16 (q, k, v and out share it, [...,
// D]). Dt <= D: the head dim the scores are scaled by (1 / sqrt(Dt)), the
// columns from Dt on being zeros the wrapper padded them with. lse: [B,H]
// f32 or null (not written). offset >= 0: key j is position offset + j.
// window <= 0 means no window; softcap <= 0 means no softcap. Each returns
// the launch's error (0 on success).
//
// The kernel above: a head group up to 16 at D 32, 64, 128, 192 or 256.
// n_split (1..8) is the cluster size: the grid is (n_split, KV, B), one
// cluster per (slot, kv head).
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

// The group route (ops.decode_plan gives every plan argument): D a multiple
// of 32; Gc heads a chunk, `chunks` chunks a group (each holding a head);
// `cluster` (1..2) blocks a cluster and n_clu clusters per (slot, kv head,
// chunk), the key range cut into cluster x n_clu pieces; TK (4, 8, 16, 32,
// 64) keys a tile, DC (32..256, a multiple of 32, at most D) columns a panel.
// part: the scratch of the clusters' records, [B][KV x chunks][n_clu]
// [repro_decode_group_record(Gc, D)] f32, needed when n_clu > 1.
extern "C" int repro_decode_group(const void* q, const void* k, const void* v,
                                  const void* lengths, void* out, void* lse, void* part, int B,
                                  int S, int H, int KV, int Dt, int D, int dtype, int offset,
                                  int window, float softcap, int Gc, int chunks, int cluster,
                                  int n_clu, int TK, int DC, void* stream) {
  using namespace repro;
  const int G = KV > 0 ? H / KV : 0;
  const bool tk_ok = TK == 4 || TK == 8 || TK == 16 || TK == 32 || TK == 64;
  if (B <= 0 || B > 65535 || S <= 0 || KV <= 0 || H % KV != 0 || offset < 0 ||
      (dtype != 0 && dtype != 1) || Dt <= 0 || Dt > D || D % 32 != 0 || Gc <= 0 ||
      chunks <= 0 || static_cast<long long>(Gc) * chunks < G ||
      static_cast<long long>(Gc) * (chunks - 1) >= G ||
      static_cast<long long>(KV) * chunks > 65535 || Gc * D > kGroupAccFloats ||
      cluster <= 0 || cluster > kGroupMaxCluster || n_clu <= 0 || n_clu > kGroupMaxRecords ||
      static_cast<long long>(cluster) * n_clu > 65535 || (n_clu > 1 && part == nullptr) ||
      !tk_ok || DC < 32 || DC > kGroupMaxCols || DC % 32 != 0 || DC > D)
    return static_cast<int>(cudaErrorInvalidValue);
  const GroupArgs g{q, k, v, static_cast<const int*>(lengths), out, static_cast<float*>(lse),
                    static_cast<float*>(part), S, H, KV, D, offset, window, softcap,
                    1.0f / sqrtf(static_cast<float>(Dt)), Gc, chunks, cluster, n_clu, TK, DC};
  const auto st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dtype == 0 ? dispatch_hu<float>(g, B, cluster, st)
                                     : dispatch_hu<__nv_bfloat16>(g, B, cluster, st));
}

// The group route's layout, which the wrapper sizes from (queries, not
// launches): the dynamic shared memory of a group kernel block (GroupLayout)
// in bytes, for dtype 0 = f32, 1 = bf16; and the floats of one cluster's
// record in `part` (group_rec). -1 where the arguments are out of range.
extern "C" int repro_decode_group_smem(int Gc, int D, int TK, int DC, int cluster, int dtype) {
  using namespace repro;
  if (Gc <= 0 || D <= 0 || D % 32 != 0 || TK < 4 || TK % 4 != 0 || DC < 32 || DC % 32 != 0 ||
      cluster <= 0 || cluster > kGroupMaxCluster || (dtype != 0 && dtype != 1))
    return -1;
  const int HU = group_hu(Gc), Gp = (Gc + HU - 1) / HU * HU;
  return GroupLayout(Gp, D, TK, DC, group_cs(Gp, HU, TK, DC), cluster, dtype == 0 ? 4 : 2).bytes;
}

extern "C" int repro_decode_group_record(int Gc, int D) {
  using namespace repro;
  return Gc <= 0 || D <= 0 ? -1 : group_rec(Gc, D);
}
