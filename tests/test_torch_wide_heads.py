"""Head dims above 256 and head groups above 16, on the CPU.

The card takes them: flash attention up to head dim 1024 on the split-f32
kernels over a cluster of N ranks (``flash_variant`` "cluster":
``csrc/flash_attention_f32tc_cluster.cu``, at the next of
``ops.CLUSTER_WIDTHS``), above it on CUDA-core kernels (``flash_variant``
"cuda_core": ``csrc/flash_attention_wide.cu``, the head dim rounded up to a
multiple of 64), decode on the decode kernel's wide instance (a multiple of
64), and decode cuts a head group above 16 into chunks, one cluster each. Here the port's
plain versions (what the wrappers run for CPU tensors) stand against the
JAX package: its Pallas flash and decode kernels in interpret mode and its
oracles at head dims 320 and 512 and at groups 1 to 48, ``jax.vjp`` for the
flash backward; then the model at ``reduced(internlm2-1.8b)`` with head dim
512 (d_model 1024 over 2 heads), 320 (d_model 1280 over 4) and a group of
32 (32 heads over one kv head), its weights bridged from JAX, within 2e-5;
then ``repro_torch.launch.train.run_training`` at d_model 1280 beside
``repro.launch.train.run_training`` from the same initial state. Last, what
the kernel route decides before any launch: the built widths above 256, the
"cluster" and "cuda_core" variants, every group accepted, what still raises (head dim 0,
``H % KV != 0``, float16), and the shape-only route's outputs and reported
work. The kernels are held to their plain versions on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 2.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import loss as JLoss  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS, reduced as t_reduced  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training import loss as TLoss  # noqa: E402
from tests.test_torch_isolation import _claims_cuda  # noqa: E402

pytestmark = pytest.mark.timeout(300)

TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(x, dt):
    return jnp.asarray(x, JDT[dt]), torch.from_numpy(x).to(TDT[dt])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _close_to_max(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the plain versions against the JAX kernels
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, S, H, KV, D, causal, window, softcap, dtype, block): head dims 512
    # and 320 at groups 1, 2 and 24; causal, window, softcap, non-causal
    (1, 64, 2, 1, 512, True, None, None, "f32", 32),
    (1, 64, 4, 2, 320, True, 24, 50.0, "f32", 32),
    (1, 32, 24, 1, 320, False, None, None, "f32", 32),
    (1, 64, 2, 2, 512, True, None, 30.0, "bf16", 64),
    (1, 32, 24, 1, 512, True, 16, None, "bf16", 32),
    (1, 48, 4, 2, 320, True, None, None, "bf16", 16),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_jax_pallas(case):
    B, S, H, KV, D, causal, window, softcap, dt, blk = case
    rng = np.random.default_rng(21)
    q, k, v = _np(rng, (B, S, H, D)), _np(rng, (B, S, KV, D)), _np(rng, (B, S, KV, D))
    kw = dict(causal=causal, window=window, softcap=softcap)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    jk_h, jv_h = (jnp.repeat(x, H // KV, axis=2) for x in (jk, jv))
    got = ops.flash_attention(tq, tk, tv, **kw)
    assert got.dtype == TDT[dt] and got.shape == (B, S, H, D)
    got = got.float().numpy()
    _close(got, jops.flash_attention(jq, jk_h, jv_h, block_q=blk, block_k=blk,
                                     **kw), TOL[dt])
    _close(got, jref.flash_attention_ref(jq, jk_h, jv_h, **kw), TOL[dt])


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (1, 40, 40, 4, 2, 512, True, None, None),
    (1, 24, 40, 4, 1, 320, False, None, 30.0),
    (1, 40, 40, 24, 1, 320, True, 16, 50.0),
])
def test_flash_backward_plain_matches_jax_vjp(case):
    """The plain backward (``ops.FlashAttention``'s on CPU tensors) against
    jax.vjp of JAX's oracle, each gradient within 2e-5 of its largest
    magnitude."""
    B, Sq, Sk, H, KV, D, causal, window, softcap = case
    rng = np.random.default_rng(22)
    q, k, v, do = (_np(rng, s) for s in ((B, Sq, H, D), (B, Sk, KV, D),
                                          (B, Sk, KV, D), (B, Sq, H, D)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))

    def jf(a, b, c):
        return jref.flash_attention_ref(a, jnp.repeat(b, H // KV, axis=2),
                                        jnp.repeat(c, H // KV, axis=2), **kw)
    _, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    for g, w in zip(got, vjp(jnp.asarray(do))):
        assert g.shape == w.shape
        _close_to_max(g.numpy(), w, TOL["f32"])


DECODE_CASES = [
    # (B, S, H, KV, D, window, softcap, dtype, block, lengths): head dims 512
    # and 320; groups 24, 32 and 48 over one kv head (multi-query), group 32
    # at head dim 512; ragged lengths, window, softcap
    (2, 64, 4, 2, 512, None, None, "f32", 32, [64, 9]),
    (3, 96, 4, 2, 320, 40, 50.0, "f32", 32, [1, 77, 96]),
    (2, 64, 2, 1, 512, None, None, "bf16", 64, [30, 64]),
    (2, 64, 24, 1, 64, None, None, "f32", 32, [64, 20]),
    (2, 64, 32, 1, 64, 16, 30.0, "f32", 32, [64, 40]),
    (2, 64, 48, 1, 64, None, None, "bf16", 64, [5, 64]),
    (2, 64, 32, 1, 512, None, None, "f32", 64, [33, 64]),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax_pallas(case):
    B, S, H, KV, D, window, softcap, dt, blk, lens = case
    rng = np.random.default_rng(23)
    q, k, v = _np(rng, (B, H, D)), _np(rng, (B, S, KV, D)), _np(rng, (B, S, KV, D))
    lengths = np.asarray(lens, np.int32)
    kw = dict(window=window, softcap=softcap)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dt), _pair(k, dt), _pair(v, dt)
    jk_h, jv_h = (jnp.repeat(x, H // KV, axis=2) for x in (jk, jv))
    got = ops.decode_attention(tq, tk, tv, torch.from_numpy(lengths), **kw)
    assert got.dtype == TDT[dt] and got.shape == (B, H, D)
    got = got.float().numpy()
    jl = jnp.asarray(lengths)
    _close(got, jops.decode_attention(jq, jk_h, jv_h, jl, block_k=blk, **kw),
           TOL[dt])
    _close(got, jref.decode_attention_ref(jq, jk_h, jv_h, jl, **kw), TOL[dt])


# ---------------------------------------------------------------------------
# the model: head dims 512 and 320, and a head group of 32
# ---------------------------------------------------------------------------

MODELS = {
    # name: reduced(internlm2-1.8b, ...) arguments and the head dim and group
    "dh512": (dict(d_model=1024, n_layers=2, n_heads=2), 512, 2),
    "dh320": (dict(d_model=1280, n_layers=2, n_heads=4), 320, 2),
    "group32": (dict(d_model=256, n_layers=2, n_heads=32, n_kv_heads=1), 8, 32),
}


def _model(name):
    """(JAX config, port config, JAX params, bridged port params)."""
    kw, dh, group = MODELS[name]
    cfg = reduced(ARCHS["internlm2-1.8b"], **kw)
    tcfg = t_reduced(T_ARCHS["internlm2-1.8b"], **kw)
    assert cfg.d_head == tcfg.d_head == dh
    assert cfg.n_heads // cfg.n_kv_heads == group
    params = JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, tcfg, params, bridge.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _tokens(cfg, B=2, S=24, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", list(MODELS))
def test_forward_matches_jax(name):
    cfg, tcfg, params, tp = _model(name)
    toks = _tokens(cfg, S=32)
    want, _ = JM.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                         JM.Runtime(attn_impl="xla", q_chunk=16))
    got, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (2, 32, cfg.eff_vocab)
    _close(got.numpy(), want, 2e-5)


@pytest.mark.parametrize("name", ["dh512", "dh320"])
def test_loss_grads_match_jax(name):
    """The loss and every parameter's gradient (the port's flash backward on
    the CPU, JAX's XLA attention differentiated), within 2e-5."""
    cfg, tcfg, params, tp = _model(name)
    tp.requires_grad_(True)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab, (2, 17)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rt = JM.Runtime(attn_impl="xla", remat="none", q_chunk=16,
                    shard_activations=False)
    (want, _), want_g = jax.value_and_grad(JLoss.loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, cfg, rt)
    got, _ = TLoss.loss_fn(tp, {k: torch.from_numpy(v) for k, v in batch.items()},
                           tcfg, TM.Runtime(remat="none"))
    _close(got.detach().numpy(), want, 2e-5)
    grads = torch.autograd.grad(got, list(tp.parameters()))
    wl = jax.tree.leaves(jax.tree.map(np.asarray, want_g))
    gl = jax.tree.leaves(bridge.params_to_jax(_with_leaves(tp, grads), tcfg))
    assert len(wl) == len(gl)
    for a, b in zip(gl, wl):
        assert np.shape(a) == np.shape(b)
        _close(a, b, 2e-5)


def _with_leaves(params, leaves):
    """A copy of ``params`` (a port parameter module) whose leaves are
    ``leaves``, in ``parameters()`` order."""
    import copy
    out = copy.deepcopy(params)
    with torch.no_grad():
        for p, x in zip(out.parameters(), leaves):
            p.copy_(x)
    return out


@pytest.mark.parametrize("name", list(MODELS))
def test_decode_steps_match_jax(name):
    """Decode steps on a bridged cache: logits within 2e-5 at every step,
    and the caches after the last."""
    cfg, tcfg, params, tp = _model(name)
    B, S = 2, 16
    cache = JM.init_cache(cfg, B, S, jnp.float32)
    tcache = bridge.cache_from_jax(jax.tree.map(np.asarray, cache), "cpu")
    toks = _tokens(cfg, B=B, S=10, seed=6)
    step_fn = jax.jit(lambda p, c, t, q: JM.decode_step(p, c, t, q, cfg,
                                                         JM.Runtime()))
    for step in range(10):
        pos = np.array([step, step + 3], np.int32)
        want, cache = step_fn(params, cache, jnp.asarray(toks[:, step]),
                              jnp.asarray(pos))
        got, tcache = TM.decode_step(tp, tcache, torch.from_numpy(toks[:, step]),
                                     torch.from_numpy(pos), tcfg)
        _close(got.numpy(), want, 2e-5)
    for c, tc in zip(cache, tcache):
        for leaf in c:
            _close(tc[leaf].numpy(), c[leaf], 2e-5)


@pytest.mark.timeout(600)   # two short runs at d_model 1280 (~40 M params)
def test_run_training_at_d_model_1280_matches_jax(tmp_path, monkeypatch):
    """``repro_torch.launch.train.run_training`` at d_model 1280 (head dim
    320 over the launcher's four heads), one layer, three steps, from
    JAX's initial state bridged in, beside ``repro.launch.train``'s run:
    the same batches (the LOG.io pipelines are copies), the losses within
    2e-5 of each other's."""
    from repro.launch import train as JT
    from repro.training.optimizer import OptHParams as JOpt
    from repro.training.step import init_train_state as j_init
    from repro_torch.launch import train as TT

    kw = dict(steps=3, seq_len=32, batch_size=2, ckpt_every=3, seed=0,
              d_model=1280, n_layers=1, verbose=False)
    jcfg = reduced(ARCHS["internlm2-1.8b"], d_model=1280, n_layers=1,
                   vocab=2048, d_ff=4 * 1280, n_heads=4)
    assert jcfg.d_head == 320
    state = jax.tree.map(np.asarray, j_init(
        jax.random.PRNGKey(0), jcfg, JOpt(lr=1e-3, warmup=20),
        dtype=jnp.float32))
    monkeypatch.setattr(TT, "init_train_state",
                        lambda gen, cfg, hp, dtype, device:
                        bridge.train_state_from_jax(state, cfg, device))
    got = TT.run_training(ckpt_dir=str(tmp_path / "t"), device="cpu", **kw)
    want = JT.run_training(ckpt_dir=str(tmp_path / "j"), **kw)
    assert got["steps"] == want["steps"] == 3
    _close(got["losses"], want["losses"], 2e-5)


# ---------------------------------------------------------------------------
# what the kernel route decides before any launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_built_head_dims_above_256_are_wide(dtype):
    """Above 256 every head dim is built at the next multiple of 64 for
    decode, in both dtypes; flash takes it to the next width a cluster of
    at most 8 ranks of 128, 96 or 64 columns splits ("cluster", up to 1024:
    704, 832 and 960 run at 768, 896 and 1024) and above 1024 to the next
    multiple of 64 on the "cuda_core" variant; up to 256 the instances
    stay."""
    assert ops.CLUSTER_WIDTHS == (320, 384, 448, 512, 576, 640, 768, 896,
                                  1024)
    for D in range(257, 1100):
        built = ops.built_head_dim(dtype, D)
        assert built % 64 == 0 and D <= built < D + 64, D
        flash = ops.flash_built_head_dim(dtype, D)
        if D <= 1024:
            assert flash == min(w for w in ops.CLUSTER_WIDTHS if w >= built), D
            assert ops.flash_variant(dtype, D) == "cluster"
        else:
            assert flash == built and ops.flash_variant(dtype, D) == "cuda_core"
    assert [ops.built_head_dim(dtype, D) for D in (320, 512, 704, 1024, 4097)] \
        == [320, 512, 704, 1024, 4160]
    assert [ops.flash_built_head_dim(dtype, D)
            for D in (300, 512, 576, 704, 832, 960, 1024, 4097)] \
        == [320, 512, 576, 768, 896, 1024, 1024, 4160]
    assert ops.flash_variant(dtype, 256) not in ("cluster", "cuda_core")
    assert ops.built_head_dim(dtype, 256) == ops.flash_built_head_dim(dtype, 256) == 256


class _Launched(Exception):
    pass


def _refuse(*args, **kwargs):
    raise _Launched("launcher reached")


@pytest.mark.parametrize("H, KV, D", [(24, 1, 64), (32, 1, 512), (71, 1, 64),
                                      (48, 2, 320), (34, 2, 192)])
def test_every_head_group_reaches_the_launcher(monkeypatch, H, KV, D):
    """A tensor that claims the card at a group above 16 (and a head dim
    above 256) passes every check and reaches the launch, in both
    wrappers and the backward."""
    monkeypatch.setattr(ops, "_launch_flash_attention", _refuse)
    monkeypatch.setattr(ops, "_launch_decode_attention", _refuse)
    monkeypatch.setattr(build, "load", _refuse)
    q4, k = torch.randn(1, 8, H, D), torch.randn(1, 8, KV, D)
    q3, lengths = torch.randn(1, H, D), torch.tensor([5], dtype=torch.int32)
    cuda = [_claims_cuda(t) for t in (q4, k, q3, lengths)]
    before = dict(ops.LAUNCHES)
    with pytest.raises(_Launched):
        ops.flash_attention(cuda[0], cuda[1], cuda[1])
    with pytest.raises(_Launched):
        ops.decode_attention(cuda[2], cuda[1], cuda[1], cuda[3])
    with pytest.raises(_Launched):
        ops.flash_attention_backward(cuda[0], cuda[1], cuda[1], cuda[0],
                                     _claims_cuda(torch.zeros(1, H, 8)),
                                     cuda[0])
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("H, KV, D, dtype, match", [
    (4, 2, 0, torch.float32, "head dim 0"),
    (6, 4, 64, torch.float32, "multiple of kv heads"),
    (4, 2, 512, torch.float16, "float16"),
])
def test_what_still_raises(H, KV, D, dtype, match):
    """Only head dim 0, ``H % KV != 0`` and a dtype without a kernel raise,
    before any launch, in both wrappers and the backward."""
    q4 = _claims_cuda(torch.randn(1, 8, H, D).to(dtype))
    k = _claims_cuda(torch.randn(1, 8, KV, D).to(dtype))
    q3 = _claims_cuda(torch.randn(1, H, D).to(dtype))
    lengths = _claims_cuda(torch.tensor([5], dtype=torch.int32))
    before = dict(ops.LAUNCHES)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention(q4, k, k)
    with pytest.raises(ValueError, match=match):
        ops.decode_attention(q3, k, k, lengths)
    with pytest.raises(ValueError, match=match):
        ops.flash_attention_backward(q4, k, k, q4,
                                     _claims_cuda(torch.zeros(1, H, 8)), q4)
    assert ops.LAUNCHES == before


def test_meta_route_reports_the_wide_work(monkeypatch):
    """On ``meta`` operands at D = 320 (built 320) the wrappers give
    outputs at D and report the work: flash on the cluster route computes
    each score once (4 D a kept pair forward, 10 D backward) as split-f32
    ("tf32x3") in f32 and one TF32 product ("tf32") in bf16; decode's group
    route computes each score once (4 D a key) on the CUDA cores. At D =
    1088 flash's CUDA-core route counts the scores once per slice of 128
    columns (nine), decode still once. At group 32 over one kv head (D =
    64) the kernels' usual work."""
    seen = []
    monkeypatch.setattr(ops, "COST_HOOK", lambda *a: seen.append(a))
    B, S = 2, 16
    pairs = ops.kept_pairs(S, S, True, None)
    for dtype, H, KV, D, fwd, bwd, dec, rate in (
            (torch.float32, 4, 2, 320, 4 * 320, 10 * 320, 4 * 320, "tf32x3"),
            (torch.bfloat16, 4, 2, 320, 4 * 320, 10 * 320, 4 * 320, "tf32"),
            (torch.float32, 2, 1, 1088, (2 * 9 + 2) * 1088,
             (8 * 9 + 6) * 1088, 4 * 1088, "f32"),
            (torch.bfloat16, 2, 1, 1088, (2 * 9 + 2) * 1088,
             (8 * 9 + 6) * 1088, 4 * 1088, "f32"),
            (torch.float32, 32, 1, 64, 4 * 64, 10 * 64, 4 * 64, "tf32x3"),
            (torch.bfloat16, 32, 1, 64, 4 * 64, 10 * 64, 4 * 64, "bf16")):
        f32 = dtype == torch.float32
        seen.clear()
        q = torch.empty(B, S, H, D, device="meta", dtype=dtype)
        k = torch.empty(B, S, KV, D, device="meta", dtype=dtype)
        out, lse = ops.flash_attention_forward(q, k, k, True, None, None,
                                               want_lse=True)
        assert out.shape == q.shape and out.device.type == "meta"
        assert lse.shape == (B, H, S)
        grads = ops.flash_attention_backward(q, k, k, out, lse, q)
        assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
        dec_out = ops.decode_attention(
            q[:, 0].contiguous(), k, k,
            torch.empty(B, dtype=torch.int32, device="meta"))
        assert dec_out.shape == (B, H, D)
        f = (4 if f32 else 2) * B   # bytes of an element times the batch
        qb, kb = f * S * H * D, f * S * KV * D
        assert seen == [
            ("flash_attention", fwd * B * H * pairs, rate, qb + 2 * kb,
             qb + 4 * B * H * S),
            ("flash_attention_backward", bwd * B * H * pairs, rate,
             3 * qb + 2 * kb + 4 * B * H * S, qb + 2 * kb),
            ("decode_attention", dec * B * H * S, "f32",
             f * H * D + 2 * kb + 4 * B, f * H * D),
        ]
