"""The port's encoder-decoder (seamless-m4t-large-v2) against the JAX
package, on the CPU.

Reduced seamless: d_model 64, 2 encoder and 2 decoder layers, 4 heads and 2
kv heads of 16 dims (a head dim only the plain versions take), vocab 512.
Weights come from the JAX init and are bridged; frames, tokens and cross
K/V come from numpy seeds. The JAX side runs XLA attention (its encoder and
cross-attention always do, whatever ``attn_impl`` says); the port runs each
of its routes, whose kernel wrappers take the plain versions for CPU
tensors. Tolerance: rtol = atol = 2e-5 (f32), as in
tests/test_torch_model.py: the two sides differ in summation order only.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config, reduced  # noqa: E402
from repro.models import layers as JL, model as JM  # noqa: E402
from repro.serving import SlotServer as JSlotServer  # noqa: E402
from repro.training import optimizer as JO, step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as t_get_config, reduced as t_reduced  # noqa: E402
from repro_torch.models import layers as TL, model as TM  # noqa: E402
from repro_torch.serving import SlotServer  # noqa: E402
from tests.test_torch_serving import _drive  # noqa: E402

TOL = 2e-5
KEY = jax.random.PRNGKey(0)
ARCH = "seamless-m4t-large-v2"
S = 24   # decoder tokens; the encoder's Ss is S or not


def _configs():
    kw = dict(d_model=64, n_layers=2)
    return reduced(get_config(ARCH), **kw), t_reduced(t_get_config(ARCH), **kw)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _model(dtype=jnp.float32):
    cfg, tcfg = _configs()
    params = JM.init_params(KEY, cfg, dtype)
    return cfg, tcfg, params, bridge.params_from_jax(_np(params), tcfg, "cpu")


def _inputs(cfg, Ss, B=2, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, Ss, cfg.d_model)).astype(np.float32)
    return tokens, frames


def test_init_params_leaves_and_count():
    """Encoder layers (norm1, attn, norm2, mlp) and its final norm, a
    cross-attention in every decoder layer, the config's parameter count,
    zero norms and seeded repeatability."""
    _, tcfg = _configs()
    p = TM.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32, "cpu")
    assert sum(t.numel() for t in p.parameters()) == tcfg.param_count()
    assert len(p.encoder.layers) == tcfg.n_enc_layers
    for layer in p.encoder.layers:
        assert {n for n, _ in layer.named_children()} == {"attn", "mlp"}
        assert not hasattr(layer, "cross")
        assert float(layer.norm1.abs().sum() + layer.norm2.abs().sum()) == 0.0
    for layer in p.layers:
        assert layer.cross.wq.shape == layer.attn.wq.shape
        assert float(layer.norm_cross.abs().sum()) == 0.0
        std = float(layer.cross.wk.std()) * tcfg.d_model ** 0.5
        assert 0.8 < std < 1.2, std
    assert float(p.encoder.final_norm.abs().sum()) == 0.0
    again = TM.init_params(torch.Generator().manual_seed(0), tcfg, torch.float32,
                           "cpu")
    assert all(torch.equal(a, b) for a, b in zip(p.parameters(), again.parameters()))


@pytest.mark.parametrize("impl", TL.ATTN_IMPLS)
def test_cross_attention_layer_matches_jax(impl):
    """``apply_attention`` with ``kv_override``: k and v from a memory of
    another length through wk/wv, no RoPE, no mask."""
    cfg, tcfg = _configs()
    spec = cfg.block[0].attn
    p, _ = JL.init_attention(jax.random.PRNGKey(1), cfg, spec, jnp.float32)
    tp = TL.AttentionParams(tcfg, tcfg.block[0].attn, torch.float32, "cpu")
    for name, leaf in _np(p).items():
        with torch.no_grad():
            getattr(tp, name).copy_(bridge.to_torch(leaf, "cpu"))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    pos, mpos = np.arange(S)[None], np.arange(37)[None]
    want = JL.apply_attention(p, jnp.asarray(x), spec, cfg, jnp.asarray(pos),
                              kv_override=(jnp.asarray(mem), jnp.asarray(mpos)),
                              causal=False, q_chunk=8)
    got = TL.apply_attention(tp, torch.from_numpy(x), tcfg.block[0].attn, tcfg,
                             torch.from_numpy(pos),
                             kv_override=(torch.from_numpy(mem),
                                          torch.from_numpy(mpos)),
                             causal=False, attn_impl=impl)
    _close(got.numpy(), want)


@pytest.mark.parametrize("Ss", [S, 40])
def test_encode_matches_jax(Ss):
    cfg, tcfg, params, tp = _model()
    _, frames = _inputs(cfg, Ss)
    want, want_pos = JM._encode(params, jnp.asarray(frames), cfg,
                                JM.Runtime(q_chunk=8))
    got, pos = TM._encode(tp, torch.from_numpy(frames), tcfg, TM.Runtime())
    assert got.shape == (2, Ss, cfg.d_model)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    _close(got.numpy(), want)


@pytest.mark.parametrize("impl", TL.ATTN_IMPLS)
@pytest.mark.parametrize("Ss", [S, 40])
def test_forward_matches_jax(Ss, impl):
    """Logits with frames of the decoder's length and of another."""
    cfg, tcfg, params, tp = _model()
    tokens, frames = _inputs(cfg, Ss)
    want, want_aux = JM.forward(params, {"tokens": jnp.asarray(tokens),
                                         "frames": jnp.asarray(frames)},
                                cfg, JM.Runtime(q_chunk=8))
    got, aux = TM.forward(tp, {"tokens": torch.from_numpy(tokens),
                               "frames": torch.from_numpy(frames)}, tcfg,
                          TM.Runtime(attn_impl=impl))
    assert got.shape == (2, S, cfg.eff_vocab) and got.dtype == torch.float32
    assert float(aux) == float(want_aux) == 0.0
    _close(got.numpy(), want)


def test_forward_casts_frames_to_the_model_dtype():
    """bf16 weights: f32 frames enter the encoder cast to bf16, as in the
    JAX code, so they give the same bits as frames made bf16 beforehand."""
    _, tcfg, _, tp = _model(jnp.bfloat16)
    tokens, frames = _inputs(tcfg, 40)
    tokens, frames = torch.from_numpy(tokens), torch.from_numpy(frames)
    got, _ = TM.forward(tp, {"tokens": tokens, "frames": frames}, tcfg)
    want, _ = TM.forward(tp, {"tokens": tokens, "frames": frames.bfloat16()},
                         tcfg)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_forward_without_frames_raises_as_jax():
    cfg, tcfg, params, tp = _model()
    tokens, _ = _inputs(cfg, S)
    with pytest.raises(KeyError, match="frames"):
        JM.forward(params, {"tokens": jnp.asarray(tokens)}, cfg, JM.Runtime())
    with pytest.raises(KeyError, match="frames"):
        TM.forward(tp, {"tokens": torch.from_numpy(tokens)}, tcfg)


def _cache(cfg, B, Sc, cross_len, cross):
    cache = _np(JM.init_cache(cfg, B, Sc, jnp.float32, cross_len=cross_len))
    if cross == "random":
        rng = np.random.default_rng(8)
        for c in cache:
            for leaf in ("xk", "xv"):
                c[leaf] = rng.standard_normal(c[leaf].shape).astype(np.float32)
    return cache


@pytest.mark.parametrize("impl", TL.ATTN_IMPLS)
@pytest.mark.parametrize("cross", ["zero", "random"])
def test_decode_steps_match_jax(cross, impl):
    """decode_step over 20 steps, past the cache length (16), with the
    cross K/V cache zero (as serving leaves it) and random (values through
    the cross path): logits each step and every cache leaf at the end, xk
    and xv unchanged."""
    cfg, tcfg, params, tp = _model()
    B, Sc, cross_len = 2, 16, 12
    cache = _cache(cfg, B, Sc, cross_len, cross)
    xk0 = [c["xk"].copy() for c in cache]
    tcache = bridge.cache_from_jax(cache, "cpu")
    cache = jax.tree.map(jnp.asarray, cache)
    toks = np.random.default_rng(6).integers(0, cfg.vocab, (B, 20)).astype(np.int32)
    step_fn = jax.jit(lambda p, c, t, q: JM.decode_step(p, c, t, q, cfg,
                                                         JM.Runtime()))
    rt = TM.Runtime(attn_impl=impl)
    for step in range(20):
        pos = np.array([step, step + 3], np.int32)
        want, cache = step_fn(params, cache, jnp.asarray(toks[:, step]),
                              jnp.asarray(pos))
        got, tcache = TM.decode_step(tp, tcache, torch.from_numpy(toks[:, step]),
                                     torch.from_numpy(pos), tcfg, rt)
        assert got.shape == (B, cfg.eff_vocab)
        _close(got.numpy(), want)
    for c, tc, x0 in zip(cache, tcache, xk0):
        assert sorted(c) == sorted(tc) == ["k", "v", "xk", "xv"]
        assert tc["xk"].shape == (tcfg.n_blocks, B, cross_len, tcfg.n_kv_heads,
                                  tcfg.d_head)
        np.testing.assert_array_equal(tc["xk"].numpy(), x0)
        for leaf in c:
            _close(tc[leaf].numpy(), c[leaf])


@pytest.mark.parametrize("impl", TL.ATTN_IMPLS)
def test_cross_decode_over_zero_keys_adds_exactly_zero(impl):
    """The pinned reference behaviour: nothing fills the cross cache, so
    cross-attention averages ``cross_len`` zero values and adds 0, on both
    sides."""
    cfg, tcfg, params, tp = _model()
    layer = tp.layers[0]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 1, cfg.d_model)).astype(np.float32))
    zeros = torch.zeros((3, 10, tcfg.n_kv_heads, tcfg.d_head))
    out, k, v = TL.apply_attention_decode(
        layer.cross, x, tcfg.block[0].attn, tcfg, zeros, zeros.clone(),
        torch.tensor([0, 4, 30], dtype=torch.int32), cross=True, attn_impl=impl)
    assert torch.equal(out, torch.zeros_like(out))
    assert not k.any() and not v.any()
    jp = jax.tree.map(lambda a: a[0], params["blocks"][0]["cross"])
    jz = jnp.zeros((3, 10, cfg.n_kv_heads, cfg.d_head))
    want, _, _ = JL.apply_attention_decode(jp, jnp.asarray(x.numpy()),
                                           cfg.block[0].attn, cfg, jz, jz,
                                           jnp.asarray([0, 4, 30]), cross=True)
    assert not np.asarray(want).any()


def test_slot_server_streams_equal_jax_and_cross_cache_stays_zero():
    """5 requests x 14 tokens on 3 slots (positions pass max_len 12), cross
    K/V of ``rt.cross_len`` = 16 keys a slot on both sides: equal greedy
    streams, and xk/xv still zero after the run (the pin: the JAX package
    never fills them, so seamless serves without its encoder)."""
    cfg, tcfg, params, tp = _model()
    want = _drive(JSlotServer(params, cfg, JM.Runtime(cross_len=16), n_slots=3,
                              max_len=12), requests=5, tokens=14)
    server = SlotServer(tp, tcfg, TM.Runtime(cross_len=16), n_slots=3, max_len=12)
    got = _drive(server, requests=5, tokens=14)
    assert sorted(got) == list(range(5))
    assert got == want
    for c in server.cache:
        assert c["xk"].shape[2] == 16
        assert not c["xk"].any() and not c["xv"].any()
        assert c["k"].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip_is_exact(dtype):
    """Encoder and cross leaves (params) and xk/xv (cache), bit for bit."""
    cfg, tcfg = _configs()
    params = _np(JM.init_params(KEY, cfg, getattr(jnp, dtype)))
    assert sorted(params["encoder"]) == ["final_norm", "layers"]
    tp = bridge.params_from_jax(params, tcfg, "cpu")
    names = {n for n, _ in tp.named_parameters()}
    assert "encoder.layers.1.attn.wq" in names and "layers.1.cross.wo" in names
    back = bridge.params_to_jax(tp, tcfg)
    flat, tree = jax.tree.flatten(params)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree == tree_back
    for a, b in zip(flat, flat_back):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))
    cache = _cache(cfg, 2, 8, 6, "random")
    cback = bridge.cache_to_jax(bridge.cache_from_jax(cache, "cpu"))
    for a, b in zip(jax.tree.leaves(cache), jax.tree.leaves(cback)):
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_train_state_bridge_round_trips():
    """Params and AdamW moments with the encoder's and the cross leaves."""
    cfg, tcfg = _configs()
    hp = JO.OptHParams()
    state = _np(JS.init_train_state(jax.random.PRNGKey(2), cfg, hp, jnp.float32))
    rng = np.random.default_rng(4)
    state["opt"]["m"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(a.dtype), state["opt"]["m"])
    t_state = bridge.train_state_from_jax(state, tcfg, "cpu")
    assert t_state["opt"]["m"].encoder.layers[0].mlp.w1.any()
    back = bridge.train_state_to_jax(t_state, tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
