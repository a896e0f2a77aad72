"""The port's layers and dense decoder against the JAX package, on the CPU.

Weights are made by the JAX package (``init_params`` / ``init_attention`` /
``init_mlp``) and bridged into the port through numpy, inputs come from a
numpy seed, and both sides run in f32. The port runs its default
``attn_impl="kernel"``, which on CPU tensors is the plain version of each
kernel. Tolerance: rtol = atol = 2e-5, the f32 tolerance of the kernel
tests; the layers differ only in summation order.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import layers as JL, model as JM  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS, reduced as t_reduced  # noqa: E402
from repro_torch.models import layers as TL, model as TM  # noqa: E402

TOL = 2e-5
KEY = jax.random.PRNGKey(0)
CONFIGS = ["internlm2-1.8b", "qwen3-32b", "gemma2-9b", "starcoder2-7b-padded",
           "chameleon-34b", "grok-1-314b", "arctic-480b",
           "jamba-1.5-large-398b"]


def _configs(name):
    """(JAX config, port config): the reduced configs of
    tests/test_archs_smoke.py, its padded starcoder2 (heads 4 -> 6, vocab
    512 -> 520), and "-split2": the MoE experts split in two
    (``expert_split=2``, which ``reduced`` drops)."""
    base = name.replace("-padded", "").replace("-split2", "")
    full, t_full = ARCHS[base], T_ARCHS[base]
    n = 2 * len(full.block) if len(full.block) == 1 else len(full.block)
    cfg, tcfg = reduced(full, n_layers=n), t_reduced(t_full, n_layers=n)
    if name.endswith("-padded"):
        pad = dict(pad_heads_to=6, pad_vocab_to=520)
        cfg, tcfg = dataclasses.replace(cfg, **pad), dataclasses.replace(tcfg, **pad)
    if name.endswith("-split2"):
        cfg, tcfg = (dataclasses.replace(
            c, moe=dataclasses.replace(c.moe, expert_split=2)) for c in (cfg, tcfg))
    return cfg, tcfg


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _load(module, np_tree):
    """Copy a JAX layer's param dict (numpy leaves) into a port module."""
    for name, leaf in np_tree.items():
        with torch.no_grad():
            getattr(module, name).copy_(bridge.to_torch(np.asarray(leaf), "cpu"))


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_are_copies(name):
    cfg, tcfg = _configs(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    assert cfg.param_count() == tcfg.param_count()
    assert cfg.eff_heads == tcfg.eff_heads and cfg.eff_vocab == tcfg.eff_vocab


def test_all_registered_configs_are_copies():
    assert sorted(ARCHS) == sorted(T_ARCHS)
    for name in ARCHS:
        assert dataclasses.asdict(ARCHS[name]) == dataclasses.asdict(T_ARCHS[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    want = JL.rms_norm(jnp.asarray(x, dtype), jnp.asarray(scale, dtype), 1e-6)
    got = TL.rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)),
                      torch.from_numpy(scale).to(getattr(torch, dtype)), 1e-6)
    assert str(got.dtype).endswith(dtype)
    _close(got.float().numpy(), want, 2e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_splits_halves(theta):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    pos = np.arange(7)[None, :] + np.array([[0], [100]])
    want = JL.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = TL.rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    _close(got.numpy(), want)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_apply_mlp(act):
    cfg, tcfg = _configs("internlm2-1.8b")
    p, _ = JL.init_mlp(KEY, cfg, jnp.float32)
    tp = TL.MLPParams(tcfg, torch.float32, "cpu")
    _load(tp, jax.tree.map(np.asarray, p))
    x = np.random.default_rng(2).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    _close(TL.apply_mlp(tp, torch.from_numpy(x), act).numpy(),
           JL.apply_mlp(p, jnp.asarray(x), act))


@pytest.mark.parametrize("name", CONFIGS)
def test_apply_attention(name):
    cfg, tcfg = _configs(name)
    for spec, tspec in zip(cfg.block, tcfg.block):
        p, _ = JL.init_attention(KEY, cfg, spec.attn, jnp.float32)
        tp = TL.AttentionParams(tcfg, tspec.attn, torch.float32, "cpu")
        _load(tp, jax.tree.map(np.asarray, p))
        x = np.random.default_rng(3).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
        pos = np.arange(20)[None, :]
        want = JL.apply_attention(p, jnp.asarray(x), spec.attn, cfg,
                                  jnp.asarray(pos), q_chunk=4)
        for impl in TL.ATTN_IMPLS:
            got = TL.apply_attention(tp, torch.from_numpy(x), tspec.attn, tcfg,
                                     torch.from_numpy(pos), attn_impl=impl)
            _close(got.numpy(), want)


@pytest.mark.parametrize("name", CONFIGS)
def test_apply_attention_decode(name):
    """Several steps on one cache, past its length (pos >= S): the port
    writes in place, JAX blends a one-hot; outputs and caches agree."""
    cfg, tcfg = _configs(name)
    spec, tspec = cfg.block[0], tcfg.block[0]
    p, _ = JL.init_attention(KEY, cfg, spec.attn, jnp.float32)
    tp = TL.AttentionParams(tcfg, tspec.attn, torch.float32, "cpu")
    _load(tp, jax.tree.map(np.asarray, p))
    rng = np.random.default_rng(4)
    B, S = 2, 8
    shape = (B, S, cfg.n_kv_heads, cfg.d_head)
    ck = cv = jnp.zeros(shape, jnp.float32)
    tck, tcv = torch.zeros(shape), torch.zeros(shape)
    for step in range(12):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        pos = np.array([step, step + 5], np.int32)
        out, ck, cv = JL.apply_attention_decode(p, jnp.asarray(x), spec.attn,
                                                cfg, ck, cv, jnp.asarray(pos))
        tout, tck2, tcv2 = TL.apply_attention_decode(
            tp, torch.from_numpy(x), tspec.attn, tcfg, tck, tcv,
            torch.from_numpy(pos))
        assert tck2 is tck and tcv2 is tcv          # written in place
        _close(tout.numpy(), out)
        _close(tck.numpy(), ck)
        _close(tcv.numpy(), cv)


def _jax_and_port_params(name):
    cfg, tcfg = _configs(name)
    params = JM.init_params(KEY, cfg, jnp.float32)
    return cfg, tcfg, params, bridge.params_from_jax(
        jax.tree.map(np.asarray, params), tcfg, "cpu")


def _tokens(cfg, B=2, S=24, seed=5):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(np.int32)


@pytest.mark.parametrize("name", CONFIGS + ["grok-1-314b-split2"])
def test_forward_logits_match_jax_xla(name):
    """Logits within 2e-5 and the MoE aux loss (0 without MoE; the sum over
    the MoE layers) within 1e-6."""
    cfg, tcfg, params, tp = _jax_and_port_params(name)
    toks = _tokens(cfg)
    want, want_aux = JM.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                                JM.Runtime(q_chunk=8))
    for impl in TL.ATTN_IMPLS:
        got, aux = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg,
                              TM.Runtime(attn_impl=impl))
        assert got.shape == (2, 24, cfg.eff_vocab) and got.dtype == torch.float32
        assert aux.dtype == torch.float32 and aux.shape == ()
        assert abs(float(aux) - float(want_aux)) <= 1e-6
        assert (float(aux) > 0) == (cfg.moe is not None)
        _close(got.numpy(), want)


@pytest.mark.parametrize("name", ["internlm2-1.8b", "qwen3-32b", "gemma2-9b"])
def test_forward_logits_match_jax_pallas(name):
    """The unpadded configs also agree with the JAX flash kernel (interpret
    mode). The padded one is held to the XLA path only: ``_pallas_attn``
    skips the padded-head mask."""
    cfg, tcfg, params, tp = _jax_and_port_params(name)
    toks = _tokens(cfg, S=32)
    want, _ = JM.forward(params, {"tokens": jnp.asarray(toks)}, cfg,
                         JM.Runtime(attn_impl="pallas"))
    got, _ = TM.forward(tp, {"tokens": torch.from_numpy(toks)}, tcfg)
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", CONFIGS + ["grok-1-314b-split2"])
def test_decode_steps_match_jax(name):
    """Multi-step decode_step on a bridged cache, the positions running past
    the cache length S (pos >= S): the JAX code writes at pos % S and masks
    with absolute positions, and the port matches it there too (for the
    windowed gemma2 layers up to where no key is valid any more). MoE
    layers run ``apply_moe`` on the step's B tokens on both sides; jamba's
    Mamba layers carry conv and SSM caches."""
    cfg, tcfg, params, tp = _jax_and_port_params(name)
    B, S = 2, 16
    cache = JM.init_cache(cfg, B, S, jnp.float32)
    tcache = bridge.cache_from_jax(jax.tree.map(np.asarray, cache), "cpu")
    toks = _tokens(cfg, B=B, S=24, seed=6)
    step_fn = jax.jit(lambda p, c, t, q: JM.decode_step(p, c, t, q, cfg,
                                                         JM.Runtime()))
    for step in range(24):
        pos = np.array([step, step + 5], np.int32)
        want, cache = step_fn(params, cache, jnp.asarray(toks[:, step]),
                              jnp.asarray(pos))
        got, tcache = TM.decode_step(tp, tcache, torch.from_numpy(toks[:, step]),
                                     torch.from_numpy(pos), tcfg)
        assert got.shape == (B, cfg.eff_vocab)
        _close(got.numpy(), want)
    for c, tc in zip(cache, tcache):
        assert sorted(c) == sorted(tc)
        for leaf in c:
            _close(tc[leaf].numpy(), c[leaf])


def test_init_params_shapes_and_count():
    _, tcfg = _configs("gemma2-9b")
    g = torch.Generator().manual_seed(0)
    p = TM.init_params(g, tcfg, torch.float32, "cpu")
    assert sum(t.numel() for t in p.parameters()) == tcfg.param_count()
    assert not hasattr(p, "unembed")          # gemma2 ties its embeddings
    assert all(not t.requires_grad for t in p.parameters())
    assert float(p.final_norm.abs().sum()) == 0.0
    again = TM.init_params(torch.Generator().manual_seed(0), tcfg,
                           torch.float32, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))
    cache = TM.init_cache(tcfg, 3, 10, torch.float32, "cpu")
    assert len(cache) == len(tcfg.block)
    assert cache[0]["k"].shape == (tcfg.n_blocks, 3, 10, tcfg.n_kv_heads, tcfg.d_head)
    assert cache[0]["v"].dtype == torch.float32 and not cache[0]["v"].any()


@pytest.mark.parametrize("name", ["grok-1-314b-split2", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_init_params_moe_leaves(name):
    """MoE layers: the config's parameter count, an f32 router in a bf16
    model, ``init_moe``'s scales (1/sqrt(d) for router, w1, w3; 1/sqrt(d_ff)
    for w2) and seeded repeatability."""
    _, tcfg = _configs(name)
    p = TM.init_params(torch.Generator().manual_seed(0), tcfg, torch.bfloat16, "cpu")
    assert sum(t.numel() for t in p.parameters()) == tcfg.param_count()
    kinds = tcfg.layer_kinds()
    for layer, spec in zip(p.layers, kinds):
        assert hasattr(layer, "moe") == (spec.ffn in ("moe", "moe_dense"))
        assert hasattr(layer, "mlp") == (spec.ffn in ("dense", "moe_dense"))
    moe = next(layer.moe for layer in p.layers if hasattr(layer, "moe"))
    E, sp = tcfg.moe.n_experts, tcfg.moe.expert_split
    d, f = tcfg.d_model, tcfg.d_ff
    assert moe.router.dtype == torch.float32 and moe.router.shape == (d, E)
    assert moe.w1.shape == moe.w3.shape == (E * sp, d, f // sp)
    assert moe.w2.shape == (E * sp, f // sp, d) and moe.w2.dtype == torch.bfloat16
    for leaf, scale in ((moe.router, d), (moe.w1, d), (moe.w3, d), (moe.w2, f)):
        std = float(leaf.float().std()) * scale ** 0.5
        assert 0.9 < std < 1.1, std
    again = TM.init_params(torch.Generator().manual_seed(0), tcfg, torch.bfloat16,
                           "cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    cfg, tcfg = _configs("qwen3-32b")
    params = jax.tree.map(np.asarray, JM.init_params(KEY, cfg, getattr(jnp, dtype)))
    tp = bridge.params_from_jax(params, tcfg, "cpu")
    back = bridge.params_to_jax(tp, tcfg)
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    cache = jax.tree.map(np.asarray, JM.init_cache(cfg, 2, 8, getattr(jnp, dtype)))
    cache[0]["k"] = (np.random.default_rng(7).standard_normal(cache[0]["k"].shape)
                     .astype(cache[0]["k"].dtype))
    cback = bridge.cache_to_jax(bridge.cache_from_jax(cache, "cpu"))
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(cback)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name", ["grok-1-314b-split2", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_bridge_round_trip_keeps_the_f32_router(name):
    """A bf16 MoE model: its router leaves are f32 on both sides, and the
    round trip keeps every leaf's bits and dtype."""
    cfg, tcfg = _configs(name)
    params = jax.tree.map(np.asarray, JM.init_params(KEY, cfg, jnp.bfloat16))
    tp = bridge.params_from_jax(params, tcfg, "cpu")
    moe = [m for n, m in tp.named_modules() if n.endswith(".moe")]
    assert len(moe) == sum(s.ffn in ("moe", "moe_dense") for s in tcfg.layer_kinds())
    assert all(m.router.dtype == torch.float32 and m.w1.dtype == torch.bfloat16
               for m in moe)
    back = bridge.params_to_jax(tp, tcfg)
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bridge_rejects_a_mismatched_config():
    cfg, tcfg = _configs("internlm2-1.8b")
    params = jax.tree.map(np.asarray, JM.init_params(KEY, cfg, jnp.float32))
    wrong = dataclasses.replace(tcfg, d_ff=tcfg.d_ff * 2)
    with pytest.raises(ValueError, match="shape"):
        bridge.params_from_jax(params, wrong, "cpu")
