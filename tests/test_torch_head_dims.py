"""Head dims the card's attention kernels take: 192 natively, any other up
to 256 on the next built instance (``ops.built_head_dim``), on the CPU.

The port's plain versions (what the wrappers run for CPU tensors) against
the JAX package at D = 192 and at a padded width (48): its Pallas flash and
decode kernels in interpret mode and their oracles, as
``tests/test_torch_kernels.py`` holds them at the other head dims; then
the model at d_model 768 over 4 heads (head dim 192, as
``examples/train_e2e.py --big`` and ``repro.launch.serve --d-model 768``
give it): ``forward``, the loss's gradients and decode steps of
``reduced(internlm2-1.8b, d_model=768, n_layers=2)``, its weights bridged
from JAX (``repro_torch.bridge``), at the tolerances of
``tests/test_torch_model.py`` and ``tests/test_torch_training.py`` (2e-5).
Then what the kernel route decides before any launch: the built width for
every head dim 1..256 in both dtypes and above it (the wide route, at the
next multiple of 64), what the route takes on the card (a head dim above
256, a head group above 16) and what still raises (head dim 0, ``H % KV !=
0``, float16), and the shape-only route's outputs and reported work at a
padded width. The kernels themselves are held at these head dims on the
card by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py`` phase 2;
``tests/test_torch_wide_heads.py`` holds the wide route's head dims and the
large groups against JAX.
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
# the plain versions against the JAX kernels at D = 192 and 48
# ---------------------------------------------------------------------------

FLASH_CASES = [
    # (B, S, H, KV, D, causal, window, softcap, dtype, block)
    (2, 64, 4, 2, 192, True, None, None, "f32", 32),     # --big's form
    (1, 128, 4, 2, 192, True, 48, 50.0, "f32", 64),
    (1, 64, 4, 4, 192, False, None, None, "bf16", 64),
    (2, 64, 8, 2, 48, True, None, None, "f32", 32),
    (1, 100, 4, 2, 48, True, 24, 30.0, "f32", 100),
    (1, 64, 4, 2, 48, True, None, None, "bf16", 64),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_plain_matches_jax_pallas(case):
    B, S, H, KV, D, causal, window, softcap, dt, blk = case
    rng = np.random.default_rng(11)
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


DECODE_CASES = [
    # (B, S, H, KV, D, window, softcap, dtype, block, lengths)
    (4, 128, 4, 2, 192, None, None, "f32", 64, [1, 17, 128, 40]),
    (2, 64, 12, 2, 192, 32, 30.0, "f32", 32, [64, 50]),   # head group 6
    (2, 64, 4, 2, 192, None, None, "bf16", 64, [9, 64]),
    (3, 96, 8, 2, 48, 40, 50.0, "f32", 32, [1, 77, 96]),
    (2, 64, 4, 4, 48, None, None, "bf16", 64, [64, 5]),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax_pallas(case):
    B, S, H, KV, D, window, softcap, dt, blk, lens = case
    rng = np.random.default_rng(12)
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


@pytest.mark.parametrize("case", [
    # (B, Sq, Sk, H, KV, D, causal, window, softcap)
    (2, 64, 64, 4, 2, 192, True, None, None),
    (1, 50, 50, 4, 2, 192, True, 16, 50.0),
    (1, 40, 40, 8, 2, 48, True, None, None),
    (2, 20, 45, 4, 1, 48, False, None, 30.0),
])
def test_flash_backward_plain_matches_jax_vjp(case):
    """The plain backward (``ops.FlashAttention``'s on CPU tensors) against
    jax.vjp of JAX's oracle, each gradient within 2e-5 of its largest
    magnitude."""
    B, Sq, Sk, H, KV, D, causal, window, softcap = case
    rng = np.random.default_rng(13)
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


# ---------------------------------------------------------------------------
# the model at d_model 768 over 4 heads (head dim 192)
# ---------------------------------------------------------------------------

def _wide():
    """(JAX config, port config, JAX params, bridged port params) of
    reduced(internlm2-1.8b, d_model=768, n_layers=2): 4 heads, 2 kv heads,
    head dim 192."""
    cfg = reduced(ARCHS["internlm2-1.8b"], d_model=768, n_layers=2)
    tcfg = t_reduced(T_ARCHS["internlm2-1.8b"], d_model=768, n_layers=2)
    assert cfg.d_head == tcfg.d_head == 192
    params = JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    return cfg, tcfg, params, bridge.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _tokens(cfg, B=2, S=24, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("jax_attn", ["xla", "pallas"])
def test_wide_forward_matches_jax(jax_attn):
    cfg, tcfg, params, tp = _wide()
    toks = _tokens(cfg, S=32)
    want, _ = JM.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                         JM.Runtime(attn_impl=jax_attn, q_chunk=8))
    got, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    assert got.shape == (2, 32, cfg.eff_vocab)
    _close(got.numpy(), want, 2e-5)


def test_wide_loss_grads_match_jax():
    """The loss and every parameter's gradient (the port's flash backward on
    the CPU, JAX's XLA attention differentiated), within 2e-5."""
    cfg, tcfg, params, tp = _wide()
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
    got_g = bridge.params_to_jax(_with_leaves(tp, grads), tcfg)
    wl = jax.tree.leaves(jax.tree.map(np.asarray, want_g))
    gl = jax.tree.leaves(got_g)
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


def test_wide_decode_steps_match_jax():
    """Decode steps on a bridged cache: logits within 2e-5 at every step,
    and the caches after the last."""
    cfg, tcfg, params, tp = _wide()
    B, S = 2, 16
    cache = JM.init_cache(cfg, B, S, jnp.float32)
    tcache = bridge.cache_from_jax(jax.tree.map(np.asarray, cache), "cpu")
    toks = _tokens(cfg, B=B, S=12, seed=6)
    step_fn = jax.jit(lambda p, c, t, q: JM.decode_step(p, c, t, q, cfg,
                                                         JM.Runtime()))
    for step in range(12):
        pos = np.array([step, step + 3], np.int32)
        want, cache = step_fn(params, cache, jnp.asarray(toks[:, step]),
                              jnp.asarray(pos))
        got, tcache = TM.decode_step(tp, tcache, torch.from_numpy(toks[:, step]),
                                     torch.from_numpy(pos), tcfg)
        _close(got.numpy(), want, 2e-5)
    for c, tc in zip(cache, tcache):
        for leaf in c:
            _close(tc[leaf].numpy(), c[leaf], 2e-5)


# ---------------------------------------------------------------------------
# what the kernel route decides before any launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_built_head_dim_for_every_head_dim(dtype):
    """1..32 -> 32, 33..64 -> 64, 65..128 -> 128, 129..192 -> 192,
    193..256 -> 256, the same in both dtypes, and every flash variant by
    dtype alone; above 256 the next multiple of 64 on the "cluster" variant
    (257 -> 320, 320 -> 320, 512 -> 512); 0 raises."""
    want = {range(1, 33): 32, range(33, 65): 64, range(65, 129): 128,
            range(129, 193): 192, range(193, 257): 256}
    for dims, built in want.items():
        for D in dims:
            assert ops.built_head_dim(dtype, D) == built, D
            assert ops.flash_variant(dtype, D) == (
                "tensor_core" if dtype == torch.bfloat16 else "split_f32")
    assert ops.HEAD_DIMS == (32, 64, 128, 192, 256)
    for D, built in ((257, 320), (320, 320), (512, 512)):
        assert ops.built_head_dim(dtype, D) == built
        assert ops.flash_variant(dtype, D) == "cluster"
    for D in (0, -1):
        with pytest.raises(ValueError, match="head dim"):
            ops.built_head_dim(dtype, D)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_variant(dtype, D)
    with pytest.raises(ValueError):
        ops.built_head_dim(torch.float16, 64)


class _Launched(Exception):
    pass


def _refuse(*args, **kwargs):
    raise _Launched("launcher reached")


@pytest.mark.parametrize("H, KV, D, dtype, match", [
    # what the route takes now: a head dim above 256, a head group above 16
    (4, 2, 320, torch.float32, None),
    (34, 2, 192, torch.float32, None),
    (34, 2, 48, torch.bfloat16, None),
    # what still raises, its message naming the limit
    (4, 2, 0, torch.float32, "head dim 0"),
    (6, 4, 64, torch.float32, "multiple of kv heads"),
    (4, 2, 64, torch.float16, "float16"),
])
def test_kernel_route_still_refuses_past_its_limits(monkeypatch, H, KV, D,
                                                    dtype, match):
    """On the card (a tensor that claims CUDA) the wrappers take every
    head dim from 1 and every head group (the call reaches the launch),
    and raise before any launch only for head dim 0, a q head count that is
    not a multiple of the kv heads', or a dtype without a kernel."""
    monkeypatch.setattr(ops, "_launch_flash_attention", _refuse)
    monkeypatch.setattr(ops, "_launch_decode_attention", _refuse)
    monkeypatch.setattr(build, "load", _refuse)
    q4, k = torch.randn(1, 8, H, D).to(dtype), torch.randn(1, 8, KV, D).to(dtype)
    q3, lengths = torch.randn(1, H, D).to(dtype), torch.tensor([5], dtype=torch.int32)
    cuda = [_claims_cuda(t) for t in (q4, k, q3, lengths)]
    before = dict(ops.LAUNCHES)
    def raises():
        return (pytest.raises(_Launched) if match is None
                else pytest.raises(ValueError, match=match))
    with raises():
        ops.flash_attention(cuda[0], cuda[1], cuda[1])
    with raises():
        ops.decode_attention(cuda[2], cuda[1], cuda[1], cuda[3])
    with raises():
        ops.flash_attention_backward(cuda[0], cuda[1], cuda[1], cuda[0],
                                     _claims_cuda(torch.zeros(1, H, 8)),
                                     cuda[0])
    assert ops.LAUNCHES == before


def test_meta_route_reports_the_built_width(monkeypatch):
    """On ``meta`` operands at D = 48 (the dry-run's shape-only route) the
    wrappers give outputs at D and report the work of the D = 64 instance:
    its products over the padded width and its padded operands' bytes."""
    seen = []
    monkeypatch.setattr(ops, "COST_HOOK", lambda *a: seen.append(a))
    B, S, H, KV, D, built = 2, 16, 4, 2, 48, 64
    q = torch.empty(B, S, H, D, device="meta")
    k = torch.empty(B, S, KV, D, device="meta")
    out, lse = ops.flash_attention_forward(q, k, k, True, None, None,
                                           want_lse=True)
    assert out.shape == q.shape and out.device.type == "meta"
    assert lse.shape == (B, H, S)
    grads = ops.flash_attention_backward(q, k, k, out, lse, q)
    assert [g.shape for g in grads] == [q.shape, k.shape, k.shape]
    dec = ops.decode_attention(q[:, 0].contiguous(), k, k,
                               torch.empty(B, dtype=torch.int32, device="meta"))
    assert dec.shape == (B, H, D)
    pairs = ops.kept_pairs(S, S, True, None)
    f = 4 * B   # bytes of an f32 element times the batch
    qb, kb = f * S * H * built, f * S * KV * built   # padded q and k, v
    assert seen == [
        ("flash_attention", 4 * B * H * built * pairs, "tf32x3",
         qb + 2 * kb, qb + 4 * B * H * S),
        ("flash_attention_backward", 10 * B * H * built * pairs, "tf32x3",
         3 * qb + 2 * kb + 4 * B * H * S, qb + 2 * kb),
        ("decode_attention", 4 * B * H * S * built, "f32",
         4 * B * H * built + 2 * kb + 4 * B, 4 * B * H * built),
    ]


def test_pad_and_cut_helpers():
    """The padded route's operands: zero columns up to the built width, the
    tensor itself where it has that width; outputs cut back contiguous."""
    x = torch.randn(2, 3, 4, 48)
    p = ops._pad_head(x, 64)
    assert p.shape == (2, 3, 4, 64) and p.is_contiguous()
    assert torch.equal(p[..., :48], x) and not p[..., 48:].any()
    assert ops._pad_head(x, 48) is x
    c = ops._cut_head(p, 48)
    assert c.is_contiguous() and torch.equal(c, x)
    assert ops._cut_head(x, 48) is x
