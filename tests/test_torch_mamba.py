"""The port's Mamba mixer and falcon-mamba model against the JAX package, on
the CPU.

Weights are made by the JAX package (``init_mamba`` / ``init_params``) and
bridged into the port through numpy; inputs come from a numpy seed. The JAX
side runs the ``scan_impl="pallas"`` branch (the Pallas selective scan in
interpret mode) and, where it applies (S > 256, S % 256 == 0), the chunked
branch. The port runs both its scan paths, which on CPU tensors are the
plain loop. Tolerances: rtol = atol = 2e-5 in f32 (summation order only),
2e-2 in bf16 (the two frameworks round bf16 at other places).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import layers as JL, model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers as TL, model as TM  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
KEY = jax.random.PRNGKey(0)
ARCH = "falcon-mamba-7b"


def _configs():
    """Reduced falcon-mamba: d_model 64, 2 layers (d_inner 128, d_state 8,
    dt_rank 4, vocab 512)."""
    return (reduced(get_config(ARCH), d_model=64, n_layers=2),
            t_reduced(t_get_config(ARCH), d_model=64, n_layers=2))


def _close(got, want, tol=TOL["float32"]):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _mixer(cfg, tcfg):
    p, _ = JL.init_mamba(KEY, cfg, jnp.float32)
    tp = TL.MambaParams(tcfg, torch.float32, "cpu")
    for name, leaf in jax.tree.map(np.asarray, p).items():
        with torch.no_grad():
            getattr(tp, name).copy_(bridge.to_torch(leaf, "cpu"))
    return p, tp


def test_mamba_leaves_and_init():
    """Leaf shapes are JAX's; dt_bias, A_log and D stay f32 in a bf16 model;
    the port's init sets them to JAX's values (to 1e-6: the two libraries'
    f32 logs differ in the last bit)."""
    cfg, tcfg = _configs()
    p, _ = JL.init_mamba(KEY, cfg, jnp.bfloat16)
    tp = TL.MambaParams(tcfg, torch.bfloat16, "cpu")
    TL.init_mamba(tp, torch.Generator().manual_seed(0), tcfg)
    for name, leaf in p.items():
        t = getattr(tp, name)
        assert tuple(t.shape) == leaf.shape, name
        assert str(t.dtype).endswith(str(leaf.dtype)), name
    for name in ("dt_bias", "A_log", "D"):
        assert getattr(tp, name).dtype == torch.float32
        np.testing.assert_allclose(getattr(tp, name).numpy(), np.asarray(p[name]),
                                   rtol=1e-6, atol=0)


@pytest.mark.parametrize("S,jax_impl", [(16, "pallas"), (512, "pallas"),
                                        (512, "chunked"), (1024, "chunked")])
def test_apply_mamba_matches_jax(S, jax_impl):
    cfg, tcfg = _configs()
    p, tp = _mixer(cfg, tcfg)
    x = np.random.default_rng(1).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    want = JL.apply_mamba(p, jnp.asarray(x), cfg, scan_impl=jax_impl)
    for impl in TL.SCAN_IMPLS:
        got = TL.apply_mamba(tp, torch.from_numpy(x), tcfg, scan_impl=impl)
        assert got.shape == (2, S, cfg.d_model)
        _close(got.numpy(), want)


def test_apply_mamba_bf16_fused_matches_jax():
    """bf16 weights and input at S = 512: the fused route (u, Bc and Cc in
    bf16, converted in the scan) against JAX's chunked branch, 2e-2."""
    cfg, tcfg = _configs()
    p, _ = JL.init_mamba(KEY, cfg, jnp.bfloat16)
    tp = TL.MambaParams(tcfg, torch.bfloat16, "cpu")
    for name, leaf in jax.tree.map(np.asarray, p).items():
        with torch.no_grad():
            getattr(tp, name).copy_(bridge.to_torch(leaf, "cpu"))
    x = np.random.default_rng(4).standard_normal((2, 512, cfg.d_model))
    xj = jnp.asarray(x, jnp.bfloat16)
    want = JL.apply_mamba(p, xj, cfg, scan_impl="chunked")
    got = TL.apply_mamba(tp, bridge.to_torch(np.asarray(xj), "cpu"), tcfg)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), TOL["bfloat16"])


@pytest.mark.parametrize("S,route", [(256, "materialised"), (520, "materialised"),
                                     (16, "materialised"), (512, "fused"),
                                     (768, "fused")])
def test_mamba_route_follows_jax_branch_rule(S, route, monkeypatch):
    """JAX chunks where S > 256 and S % 256 == 0 (``MAMBA_CHUNK``); the port
    takes the fused scan exactly there, the materialised scan elsewhere,
    under either ``scan_impl``."""
    assert TL.MAMBA_CHUNK == JL.MAMBA_CHUNK
    assert TL.chunked(S) == (route == "fused")
    _, tcfg = _configs()
    tp = TL.MambaParams(tcfg, torch.float32, "cpu")
    TL.init_mamba(tp, torch.Generator().manual_seed(0), tcfg)
    x = torch.randn(1, S, tcfg.d_model, generator=torch.Generator().manual_seed(1))
    seen = []
    for name in ("selective_scan_fused_ref", "selective_scan_ref"):
        fn = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _f=fn, _n=name, **k:
                            seen.append(_n) or _f(*a, **k))
    want = {"fused": "selective_scan_fused_ref",
            "materialised": "selective_scan_ref"}[route]
    for impl in TL.SCAN_IMPLS:
        seen.clear()
        TL.apply_mamba(tp, x, tcfg, scan_impl=impl)
        assert seen == [want], impl


@pytest.mark.parametrize("S", [16, 512, 1024])
def test_apply_mamba_grad_matches_jax(S, monkeypatch):
    """The mixer's gradient (every param leaf and the input) of a weighted
    sum of its output, through the port's kernel route (on the CPU the
    plain backward of ``ops.SelectiveScan``, the reverse loop, at S = 16;
    of ``ops.SelectiveScanFused``, the chunked reverse loop, at S = 512 and
    1024) against ``jax.grad`` of JAX's chunked path (the associative scan
    at S <= 256), which JAX trains through: within 2e-5 of each leaf's
    largest magnitude. Exactly one backward of the route's scan ran."""
    cfg, tcfg = _configs()
    p, tp = _mixer(cfg, tcfg)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def jloss(params, xx):
        return jnp.sum(JL.apply_mamba(params, xx, cfg, scan_impl="chunked")
                       * jnp.asarray(w))
    want_p, want_x = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    calls = {"selective_scan_backward_ref": [],
             "selective_scan_fused_backward_ref": []}
    for name, seen in calls.items():
        plain_bwd = getattr(ref, name)
        monkeypatch.setattr(ref, name, lambda *a, _f=plain_bwd, _s=seen:
                            _s.append(1) or _f(*a))
    tp.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    out = TL.apply_mamba(tp, tx, tcfg, scan_impl="kernel")
    names = sorted(want_p)
    leaves = [getattr(tp, n) for n in names] + [tx]
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), leaves)
    # the scan's gradient came from its route's backward
    ran = ("selective_scan_fused_backward_ref" if TL.chunked(S)
           else "selective_scan_backward_ref")
    assert calls == {name: [1] if name == ran else [] for name in calls}
    for name, g, want in zip(names + ["x"], got,
                             [want_p[n] for n in names] + [want_x]):
        want = np.asarray(want, np.float32)
        scale = max(float(np.abs(want).max()), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   rtol=TOL["float32"], atol=TOL["float32"],
                                   err_msg=name)


def test_apply_mamba_decode_matches_jax():
    """Steps of the one-token mixer on a carried state: the port writes the
    conv tail and the SSM state in place; outputs and states agree."""
    cfg, tcfg = _configs()
    p, tp = _mixer(cfg, tcfg)
    rng = np.random.default_rng(2)
    B, dc, di, ds = 3, cfg.mamba.d_conv, cfg.d_inner, cfg.mamba.d_state
    conv = rng.standard_normal((B, dc - 1, di)).astype(np.float32)
    ssm = rng.standard_normal((B, di, ds)).astype(np.float32)
    tconv, tssm = torch.from_numpy(conv.copy()), torch.from_numpy(ssm.copy())
    for _ in range(4):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        out, conv, ssm = JL.apply_mamba_decode(p, jnp.asarray(x), cfg,
                                               jnp.asarray(conv), jnp.asarray(ssm))
        tout, tconv2, tssm2 = TL.apply_mamba_decode(tp, torch.from_numpy(x),
                                                    tcfg, tconv, tssm)
        assert tconv2 is tconv and tssm2 is tssm           # written in place
        _close(tout.numpy(), out)
        _close(tconv.numpy(), conv)
        _close(tssm.numpy(), ssm)


def _model(dtype="float32"):
    cfg, tcfg = _configs()
    params = JM.init_params(KEY, cfg, getattr(jnp, dtype))
    return cfg, tcfg, params, bridge.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _tokens(cfg, B=2, S=24, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax_pallas(dtype):
    cfg, tcfg, params, tp = _model(dtype)
    assert tp.layers[0].mamba.A_log.dtype == torch.float32
    toks = _tokens(cfg, S=32)
    want, _ = JM.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                         JM.Runtime(scan_impl="pallas"))
    for impl in TL.SCAN_IMPLS:
        got, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                              TM.Runtime(scan_impl=impl))
        assert got.shape == (2, 32, cfg.vocab) and got.dtype == torch.float32
        assert float(aux) == 0.0
        _close(got.numpy(), want, TOL[dtype])


def test_decode_steps_match_jax():
    """Eight decode_step calls from a zero cache: the logits and the conv and
    SSM caches after every step."""
    cfg, tcfg, params, tp = _model()
    B = 2
    cache = JM.init_cache(cfg, B, 16, jnp.float32)
    tcache = TM.init_cache(tcfg, B, 16, torch.float32, "cpu")
    assert sorted(tcache[0]) == ["conv", "ssm"]
    for c, tc in zip(cache, tcache):
        for leaf in ("conv", "ssm"):
            assert tuple(tc[leaf].shape) == c[leaf].shape
            assert str(tc[leaf].dtype).endswith(str(c[leaf].dtype))
    toks = _tokens(cfg, B=B, S=8, seed=6)
    step_fn = jax.jit(lambda p, c, t, q: JM.decode_step(p, c, t, q, cfg,
                                                         JM.Runtime()))
    for step in range(8):
        pos = np.full((B,), step, np.int32)
        want, cache = step_fn(params, cache, jnp.asarray(toks[:, step]),
                              jnp.asarray(pos))
        got, tcache = TM.decode_step(tp, tcache, torch.from_numpy(toks[:, step]),
                                     torch.from_numpy(pos), tcfg)
        _close(got.numpy(), want)
        for c, tc in zip(cache, tcache):
            for leaf in ("conv", "ssm"):
                _close(tc[leaf].numpy(), c[leaf])


def test_init_cache_keeps_ssm_f32():
    _, tcfg = _configs()
    cache = TM.init_cache(tcfg, 3, 10, torch.bfloat16, "cpu")
    assert cache[0]["conv"].dtype == torch.bfloat16
    assert cache[0]["conv"].shape == (tcfg.n_blocks, 3, tcfg.mamba.d_conv - 1,
                                      tcfg.d_inner)
    assert cache[0]["ssm"].dtype == torch.float32
    assert cache[0]["ssm"].shape == (tcfg.n_blocks, 3, tcfg.d_inner,
                                     tcfg.mamba.d_state)


def test_init_params_count():
    _, tcfg = _configs()
    p = TM.init_params(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
    assert sum(t.numel() for t in p.parameters()) == tcfg.param_count()
    assert all(layer.mamba.D.dtype == torch.float32 for layer in p.layers)
    assert not hasattr(p.layers[0], "attn")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    cfg, tcfg = _configs()
    params = jax.tree.map(np.asarray, JM.init_params(KEY, cfg, getattr(jnp, dtype)))
    back = bridge.params_to_jax(bridge.params_from_jax(params, tcfg, "cpu"), tcfg)
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    cache = jax.tree.map(np.asarray, JM.init_cache(cfg, 2, 8, getattr(jnp, dtype)))
    rng = np.random.default_rng(7)
    for leaf in ("conv", "ssm"):
        cache[0][leaf] = rng.standard_normal(cache[0][leaf].shape).astype(
            cache[0][leaf].dtype)
    cback = bridge.cache_to_jax(bridge.cache_from_jax(cache, "cpu"))
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(cback)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("leaf,to", [("A_log", "bfloat16"), ("in_proj", "float32")])
def test_bridge_refuses_a_dtype_mismatch(leaf, to):
    """A bf16 model's f32 leaf handed over as bf16, or a bf16 leaf handed over
    as f32: the bridge raises instead of casting."""
    cfg, tcfg = _configs()
    params = jax.tree.map(np.asarray, JM.init_params(KEY, cfg, jnp.bfloat16))
    mamba = params["blocks"][0]["mamba"]
    mamba[leaf] = np.asarray(jnp.asarray(mamba[leaf], getattr(jnp, to)))
    with pytest.raises(ValueError, match=f"{leaf} has dtype"):
        bridge.params_from_jax(params, tcfg, "cpu")
