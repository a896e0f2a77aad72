// Flash attention above head dim 256 on Hopper's tensor cores (sm_90a): the
// kernels of flash_attention_f32tc.cuh with a tile's head dim split over a
// thread block cluster of N ranks, N set at launch, for built head dims 320
// to 1024 (split_of: N x DH with DH in {128, 96, 64} and N <= 8), in f32
// (split-f32 products) and bf16 (one TF32 product, bf16 outputs). The
// design, numerics and bounds are in flash_attention_f32tc.cuh.
//
// Replaces: src/repro/kernels/flash_attention.py, `_kernel` / `flash_attention`
// (the Pallas TPU kernel, which blocks over any head dim) for head dims 320
// to 1024: internlm2-1.8b's width over the launchers' four heads (d_model
// 2048, head dim 512; repro_torch.launch.train / serve --d-model 2048) and
// d_model 1280 (head dim 320). Above 1024, flash_attention_wide.cu.
#include "flash_attention_f32tc.cuh"

namespace repro {
namespace {

// DH, the element type and the softcap as template arguments; the cluster
// size from D at run time.
template <bool kBackward, typename T>
cudaError_t dispatch_cluster(const Args& a, int D, cudaStream_t st) {
  const SplitDH sp = split_of(D);
  if (D <= 256 || sp.n == 0) return cudaErrorInvalidValue;
  const bool cap = a.softcap > 0.f;
#define REPRO_CLUSTER_CASE(DH)                                                      \
  case DH:                                                                          \
    if (kBackward)                                                                  \
      return cap ? launch_backward<DH, 0, T, true>(a, sp.n, st)                     \
                 : launch_backward<DH, 0, T, false>(a, sp.n, st);                   \
    return cap ? launch_forward<DH, 0, T, true>(a, sp.n, st)                        \
               : launch_forward<DH, 0, T, false>(a, sp.n, st);
  switch (sp.dh) {
    REPRO_CLUSTER_CASE(64)
    REPRO_CLUSTER_CASE(96)
    REPRO_CLUSTER_CASE(128)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_CLUSTER_CASE
}

template <bool kBackward>
cudaError_t dispatch(const Args& a, int D, int dtype, cudaStream_t st) {
  if (dtype == 0) return dispatch_cluster<kBackward, float>(a, D, st);
  if (dtype == 1) return dispatch_cluster<kBackward, __nv_bfloat16>(a, D, st);
  return cudaErrorInvalidValue;
}

// The most clusters of the widest kernel of (D, dtype) the card holds at
// once (the forward's, or with backward the dk/dv and dq launches' fewer),
// after setting the kernels' shared memory; 0 if one cannot be scheduled.
template <int DH, typename T>
int clusters_of(int n, bool backward) {
  if (!backward) {
    constexpr int smem = fwd_smem<DH, 0>();
    const auto k = fwd_kernel<DH, 0, T, false>();
    static std::atomic<uint64_t> set{0};
    if (set_smem_once(set, k, smem) != cudaSuccess) return 0;
    return max_active_clusters(k, smem, n);
  }
  constexpr bool kOne = kOneOf<T>;
  constexpr int s1 = BwdRing<DH, 0, false, kOne>::SMEM, s2 = BwdRing<DH, 0, true, kOne>::SMEM;
  const auto k1 = dkdv_kernel<DH, 0, T, false>();
  const auto k2 = dq_kernel<DH, 0, T, false>();
  static std::atomic<uint64_t> set1{0}, set2{0};
  if (set_smem_once(set1, k1, s1) != cudaSuccess || set_smem_once(set2, k2, s2) != cudaSuccess)
    return 0;
  const int c1 = max_active_clusters(k1, s1, n), c2 = max_active_clusters(k2, s2, n);
  return c1 < c2 ? c1 : c2;
}

template <typename T>
int clusters_dh(int D, bool backward) {
  const SplitDH sp = split_of(D);
  if (D <= 256 || sp.n == 0) return 0;
  switch (sp.dh) {
    case 64: return clusters_of<64, T>(sp.n, backward);
    case 96: return clusters_of<96, T>(sp.n, backward);
    case 128: return clusters_of<128, T>(sp.n, backward);
    default: return 0;
  }
}

}  // namespace
}  // namespace repro

// The cluster size (ranks) that head dim D takes here, 0 if none.
extern "C" int repro_flash_cluster_ranks(int D) {
  return D > 256 ? repro::split_of(D).n : 0;
}

// cudaOccupancyMaxActiveClusters of the cluster kernels at built head dim D
// in dtype (0 f32, 1 bf16): the forward's (backward = 0) or the lesser of
// the backward's two launches (backward = 1); 0 when none can be scheduled
// or D is not a cluster width.
extern "C" int repro_flash_cluster_occupancy(int D, int dtype, int backward) {
  using namespace repro;
  if (sm90::bind_context() != cudaSuccess) return 0;
  if (dtype == 0) return clusters_dh<float>(D, backward != 0);
  if (dtype == 1) return clusters_dh<__nv_bfloat16>(D, backward != 0);
  return 0;
}

// Bytes of the workspace at this shape: the prep launch's hi and lo copies
// (f32) or hi copies (bf16) of the forward (backward = 0) or the backward.
extern "C" long long repro_flash_cluster_workspace(int B, int Sq, int Sk, int H, int KV, int D,
                                                   int dtype, int backward) {
  size_t off[repro::kBwdParts];
  return static_cast<long long>(
      repro::workspace_parts(B, Sq, Sk, H, KV, D, backward != 0, dtype == 1, off));
}

// C entry points, f32 (dtype 0) or bf16 (dtype 1): q, k, v, out, dout, dq,
// dk, dv are [..., Dt] of that type; lse, delta f32. D: the built head dim,
// one split_of takes above 256 (320 to 1024), Dt <= D, the prep launch
// padding Dt up to it with zero columns; the scale is 1 / sqrt(Dt). As
// repro_flash_attention_f32tc / _bwd otherwise; work:
// repro_flash_cluster_workspace bytes, 256-byte aligned.
extern "C" int repro_flash_attention_cluster(const void* q, const void* k, const void* v,
                                             void* out, float* lse, float* work, int B, int Sq,
                                             int Sk, int H, int KV, int Dt, int D, int dtype,
                                             int causal, int window, float softcap,
                                             void* stream) {
  using namespace repro;
  if (!shape_ok(B, Sq, Sk, H, KV, Dt, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = out, a.lse_out = lse, a.work = work;
  a.B = B, a.Sq = Sq, a.Sk = Sk, a.H = H, a.KV = KV, a.Dt = Dt;
  a.causal = causal, a.window = window, a.softcap = softcap;
  return static_cast<int>(dispatch<false>(a, D, dtype, static_cast<cudaStream_t>(stream)));
}

extern "C" int repro_flash_attention_cluster_bwd(const void* q, const void* k, const void* v,
                                                 const void* out, const void* dout,
                                                 const float* lse, float* delta, void* dq,
                                                 void* dk, void* dv, float* work, int B, int Sq,
                                                 int Sk, int H, int KV, int Dt, int D, int dtype,
                                                 int causal, int window, float softcap,
                                                 void* stream) {
  using namespace repro;
  if (!shape_ok(B, Sq, Sk, H, KV, Dt, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q, a.k = k, a.v = v, a.out = out, a.dout = dout, a.lse = lse;
  a.delta = delta, a.dq = dq, a.dk = dk, a.dv = dv, a.work = work;
  a.B = B, a.Sq = Sq, a.Sk = Sk, a.H = H, a.KV = KV, a.Dt = Dt;
  a.causal = causal, a.window = window, a.softcap = softcap;
  return static_cast<int>(dispatch<true>(a, D, dtype, static_cast<cudaStream_t>(stream)));
}
