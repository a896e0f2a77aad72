// Flash attention in f32 on Hopper's tensor cores (sm_90a), head dims up to
// 256: the forward and its deterministic backward with split-f32 ("3xTF32")
// wgmma products. The design, numerics and bounds are in
// flash_attention_f32tc.cuh; this file builds its instances for head dims
// 32, 64 and 128 (one block a tile), 192 and 256 (a cluster pair a tile),
// and their C entry points. flash_attention_f32tc_cluster.cu builds the
// instances above 256.
//
// Replaces: src/repro/kernels/flash_attention.py, `_kernel` / `flash_attention`
// (the Pallas TPU kernel) for f32 operands at head dims up to 256.
#include "flash_attention_f32tc.cuh"

namespace repro {
namespace {

// D and the softcap as template arguments.
template <bool kBackward>
cudaError_t dispatch(const Args& a, int D, cudaStream_t st) {
  const bool cap = a.softcap > 0.f;
#define REPRO_F32TC_CASE(DD)                                                          \
  case DD: {                                                                          \
    constexpr SplitDH sp = split_of(DD);                                              \
    if (kBackward)                                                                    \
      return cap ? launch_backward<sp.dh, sp.n, float, true>(a, sp.n, st)             \
                 : launch_backward<sp.dh, sp.n, float, false>(a, sp.n, st);           \
    return cap ? launch_forward<sp.dh, sp.n, float, true>(a, sp.n, st)                \
               : launch_forward<sp.dh, sp.n, float, false>(a, sp.n, st);              \
  }
  switch (D) {
    REPRO_F32TC_CASE(32)
    REPRO_F32TC_CASE(64)
    REPRO_F32TC_CASE(128)
    REPRO_F32TC_CASE(192)
    REPRO_F32TC_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_F32TC_CASE
}

}  // namespace
}  // namespace repro

// Bytes of the workspace the forward (backward = 0) or the backward
// (backward = 1) takes at this shape: the hi/lo copies of the prep launch.
extern "C" long long repro_flash_f32tc_workspace(int B, int Sq, int Sk, int H, int KV, int D,
                                                 int backward) {
  size_t off[repro::kBwdParts];
  return static_cast<long long>(
      repro::workspace_parts(B, Sq, Sk, H, KV, D, backward != 0, false, off));
}

// C entry points, f32 only. Dt: the operands' head dim (q, k, v, out, dout,
// dq, dk, dv are [..., Dt]); D in {32, 64, 128, 192, 256}, Dt <= D: the
// kernels' head dim, the prep launch padding Dt up to it with zero columns;
// the scale is 1 / sqrt(Dt). The forward writes out and, when lse is
// non-null, lse [B,H,Sq]; the backward writes dq, dk, dv and delta [B,H,Sq]
// (scratch). work: repro_flash_f32tc_workspace bytes at D, 256-byte aligned.
// causal is 0 or 1; window <= 0 means none; softcap <= 0 means none.
// Each launches its kernels on `stream` in order and returns the first error
// (cudaGetLastError() after each launch; cudaErrorInvalidValue for a shape
// it does not take or a tensor map cuTensorMapEncodeTiled refuses).
extern "C" int repro_flash_attention_f32tc(const float* q, const float* k, const float* v,
                                           float* out, float* lse, float* work, int B, int Sq,
                                           int Sk, int H, int KV, int Dt, int D, int causal,
                                           int window, float softcap, void* stream) {
  using namespace repro;
  if (!shape_ok(B, Sq, Sk, H, KV, Dt, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q, a.k = k, a.v = v, a.o = out, a.lse_out = lse, a.work = work;
  a.B = B, a.Sq = Sq, a.Sk = Sk, a.H = H, a.KV = KV, a.Dt = Dt;
  a.causal = causal, a.window = window, a.softcap = softcap;
  return static_cast<int>(dispatch<false>(a, D, static_cast<cudaStream_t>(stream)));
}

extern "C" int repro_flash_attention_f32tc_bwd(const float* q, const float* k, const float* v,
                                               const float* out, const float* dout,
                                               const float* lse, float* delta, float* dq,
                                               float* dk, float* dv, float* work, int B, int Sq,
                                               int Sk, int H, int KV, int Dt, int D, int causal,
                                               int window, float softcap, void* stream) {
  using namespace repro;
  if (!shape_ok(B, Sq, Sk, H, KV, Dt, D)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.q = q, a.k = k, a.v = v, a.out = out, a.dout = dout, a.lse = lse;
  a.delta = delta, a.dq = dq, a.dk = dk, a.dv = dv, a.work = work;
  a.B = B, a.Sq = Sq, a.Sk = Sk, a.H = H, a.KV = KV, a.Dt = Dt;
  a.causal = causal, a.window = window, a.softcap = softcap;
  return static_cast<int>(dispatch<true>(a, D, static_cast<cudaStream_t>(stream)));
}
