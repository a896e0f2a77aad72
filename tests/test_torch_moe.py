"""The port's MoE FFN against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_moe`` and are bridged into the
port's ``MoEParams`` through numpy; inputs come from a numpy seed. JAX runs
unjitted, so a patched ``MOE_TOKEN_CHUNK`` is read at call time. Configs are
the reduced ones of tests/test_archs_smoke.py (4 experts, top-2); grok also
at ``expert_split=2``, set on both sides (``reduced`` builds a fresh
``MoESpec`` and drops the field).

Tolerances: rtol = atol = 2e-5 in f32 and 2e-2 in bf16 (the kernel tests'),
1e-6 for the aux loss; ``moe_capacity`` exactly.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS, reduced as t_reduced  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
AUX_TOL = 1e-6
CASES = [("grok-1-314b", 1), ("grok-1-314b", 2), ("arctic-480b", 1)]


def _configs(name, split=1):
    cfg, tcfg = reduced(ARCHS[name]), t_reduced(T_ARCHS[name])
    if split != 1:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, expert_split=split))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, expert_split=split))
    return cfg, tcfg


def _params(cfg, tcfg, dtype, router=None, seed=0):
    """JAX ``init_moe`` params (with ``router`` swapped in when given) and
    their port copy."""
    p, _ = JL.init_moe(jax.random.PRNGKey(seed), cfg, getattr(jnp, dtype))
    if router is not None:
        p = dict(p, router=jnp.asarray(router))
    tp = TL.MoEParams(tcfg, getattr(torch, dtype), "cpu")
    for name, leaf in jax.tree.map(np.asarray, p).items():
        with torch.no_grad():
            getattr(tp, name).copy_(bridge.to_torch(leaf, "cpu"))
    return p, tp


def _both(p, tp, cfg, tcfg, x, dtype, fn="apply_moe"):
    want, want_aux = getattr(JL, fn)(p, jnp.asarray(x, getattr(jnp, dtype)), cfg)
    got, got_aux = getattr(TL, fn)(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                                   tcfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    assert got_aux.dtype == torch.float32 and got_aux.shape == ()
    return (got.float().numpy(), np.asarray(want, np.float32),
            float(got_aux), float(want_aux))


def _close(got, want, tol):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("capacity_factor", [1.0, 1.25, 2.0])
def test_moe_capacity_matches_jax(capacity_factor):
    for name in ("grok-1-314b", "arctic-480b", "jamba-1.5-large-398b"):
        for experts, top_k in ((ARCHS[name].moe.n_experts, 2), (4, 2), (16, 1),
                               (128, 4)):
            spec = dict(n_experts=experts, top_k=top_k,
                        capacity_factor=capacity_factor)
            cfg = dataclasses.replace(
                ARCHS[name], moe=dataclasses.replace(ARCHS[name].moe, **spec))
            tcfg = dataclasses.replace(
                T_ARCHS[name], moe=dataclasses.replace(T_ARCHS[name].moe, **spec))
            for T in (1, 4, 31, 100, 128, 4096, 65_536, 131_072):
                c = TL.moe_capacity(T, tcfg)
                assert c == JL.moe_capacity(T, cfg), (name, spec, T)
                assert c % 32 == 0 and c >= 32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name, split", CASES)
def test_moe_block_matches_jax(name, split, dtype):
    """``_moe_block`` and ``apply_moe`` (one block at T = 48) on 48 tokens."""
    cfg, tcfg = _configs(name, split)
    p, tp = _params(cfg, tcfg, dtype)
    x = np.random.default_rng(1).standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    for fn in ("_moe_block", "apply_moe"):
        got, want, got_aux, want_aux = _both(p, tp, cfg, tcfg, x, dtype, fn)
        _close(got, want, TOL[dtype])
        assert abs(got_aux - want_aux) <= AUX_TOL


@pytest.mark.parametrize("name, split", CASES)
def test_moe_decode_shape_matches_jax(name, split):
    """[B, 1, d], as ``decode_step`` calls it: capacity 32 from T = B."""
    cfg, tcfg = _configs(name, split)
    p, tp = _params(cfg, tcfg, "float32", seed=2)
    x = np.random.default_rng(2).standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    got, want, got_aux, want_aux = _both(p, tp, cfg, tcfg, x, "float32")
    _close(got, want, TOL["float32"])
    assert abs(got_aux - want_aux) <= AUX_TOL


def _skewed(cfg, seed=3, T=128):
    """Inputs and a router that send every token to expert 0 first (a large
    constant coordinate that only expert 0's router column reads); the
    second expert is random."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, T, cfg.d_model)).astype(np.float32)
    x[..., 0] = 10.0
    router = (rng.standard_normal((cfg.d_model, cfg.moe.n_experts))
              / np.sqrt(cfg.d_model)).astype(np.float32)
    router[0, :] = 0.0
    router[0, 0] = 5.0
    return x, router


@pytest.mark.parametrize("split", [1, 2])
def test_moe_overflow_matches_jax_slot0_behaviour(split):
    """T = 128, C = 96, every token routed to expert 0: 32 assignments
    are dropped past capacity, and (the pinned JAX behaviour) slot 0 of
    expert 0 is left empty, so token 0 also gets nothing from expert 0:
    its output is its second expert's alone."""
    cfg, tcfg = _configs("grok-1-314b", split)
    x, router = _skewed(cfg)
    assert TL.moe_capacity(128, tcfg) == 96
    p, tp = _params(cfg, tcfg, "float32", router=router)
    got, want, got_aux, want_aux = _both(p, tp, cfg, tcfg, x, "float32")
    _close(got, want, TOL["float32"])
    assert abs(got_aux - want_aux) <= AUX_TOL

    xf = torch.from_numpy(x[0])
    _, top_w, top_e = TL.moe_route(tp, xf, tcfg)   # [128, 2 * split]
    first = list(range(split))                       # expert 0's shards
    assert bool((top_e[:, first] == torch.arange(split)).all())
    E = cfg.moe.n_experts * split
    counts, _, slot_valid, _, kept = TL.moe_slots(top_e, E, 96)
    assert int(counts[first].min()) == 128
    assert not bool(slot_valid.reshape(E, 96)[first, 0].any())
    assert not bool(kept[0, first].any())                   # token 0, expert 0
    assert bool(kept[1:96, first].all()) and not bool(kept[96:, first].any())

    def expert_out(t, cols):
        """Token t's output from its assignments ``cols`` alone, each
        product ``y * w`` added in column order as the combine adds."""
        out = 0.0
        for c in cols:
            i = int(top_e[t, c])
            one = SimpleNamespace(**{n: getattr(tp, n)[i:i + 1]
                                     for n in ("w1", "w3", "w2")})
            out = out + TL.moe_experts(one, xf[t][None, None], tcfg.act)[0, 0] * top_w[t, c]
        return out.numpy()

    second = list(range(split, 2 * split))
    for t in (0, 100, 127):   # slot 0's token, and two dropped past C
        _close(got[0, t], expert_out(t, second), TOL["float32"])
    with_first = expert_out(0, first + second)
    assert np.abs(got[0, 0] - with_first).max() > 100 * TOL["float32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ties_break_toward_the_lower_expert(dtype):
    """Zero input rows give uniform probs: ``lax.top_k`` picks experts 0
    and 1, and so must the port (counts, and so capacity and aux, depend on
    it)."""
    cfg, tcfg = _configs("grok-1-314b")
    p, tp = _params(cfg, tcfg, dtype)
    x = np.random.default_rng(4).standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    x[0, :7] = 0.0
    x[1, 13] = 0.0
    top_e = TL.moe_route(tp, torch.from_numpy(x[0]).to(getattr(torch, dtype)),
                         tcfg)[2]
    assert top_e[:7].tolist() == [[0, 1]] * 7
    got, want, got_aux, want_aux = _both(p, tp, cfg, tcfg, x, dtype)
    _close(got, want, TOL[dtype])
    assert abs(got_aux - want_aux) <= AUX_TOL
    assert not np.abs(got[0, :7]).any()


@pytest.mark.parametrize("name, split", CASES)
def test_moe_token_chunks_match_jax(name, split, monkeypatch):
    """T = 128 over MOE_TOKEN_CHUNK = 64 (patched on both sides): two
    blocks, each with its own capacity; aux is their mean."""
    monkeypatch.setattr(JL, "MOE_TOKEN_CHUNK", 64)
    monkeypatch.setattr(TL, "MOE_TOKEN_CHUNK", 64)
    cfg, tcfg = _configs(name, split)
    x, router = _skewed(cfg, seed=5)
    p, tp = _params(cfg, tcfg, "float32", router=router)
    got, want, got_aux, want_aux = _both(p, tp, cfg, tcfg, x.reshape(2, 64, -1),
                                         "float32")
    _close(got, want, TOL["float32"])
    assert abs(got_aux - want_aux) <= AUX_TOL
    # each chunk of 64 holds (C = 64 at T = 64: nothing dropped) where one
    # block of 128 (C = 96) would drop 32 of expert 0's assignments
    parts = [TL._moe_block(tp, torch.from_numpy(x[:, i * 64:(i + 1) * 64]), tcfg)
             for i in range(2)]
    assert abs(got_aux - float(torch.stack([a for _, a in parts]).mean())) <= AUX_TOL
    whole, _ = TL._moe_block(tp, torch.from_numpy(x), tcfg)
    assert np.abs(whole.numpy().reshape(got.shape) - got).max() > 100 * TOL["float32"]


def test_moe_block_is_bitwise_repeatable_and_differentiable():
    """Two calls give the same bits; the router, the experts and the input
    all get gradients (the dispatch's gathers carry them)."""
    cfg, tcfg = _configs("grok-1-314b", 2)
    _, tp = _params(cfg, tcfg, "float32")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    a = TL.apply_moe(tp, x, tcfg)
    b = TL.apply_moe(tp, x, tcfg)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    tp.requires_grad_(True)
    x.requires_grad_(True)
    out, aux = TL.apply_moe(tp, x, tcfg)
    grads = torch.autograd.grad(out.square().sum() + aux,
                                [x] + list(tp.parameters()))
    assert all(bool(g.abs().sum() > 0) for g in grads)


@pytest.mark.parametrize("name", ["grok-1-314b", "arctic-480b"])
def test_moe_decode_matches_jax(name):
    """``apply_moe_decode`` (each token through its top-k experts' weights,
    gathered densely, no capacity) on 4 tokens of one step and on 2 x 3
    tokens, in f32; with a zero row (uniform probs: ties toward the lower
    expert id)."""
    cfg, tcfg = _configs(name)
    p, tp = _params(cfg, tcfg, "float32")
    rng = np.random.default_rng(7)
    for shape in ((4, 1, cfg.d_model), (2, 3, cfg.d_model)):
        x = rng.standard_normal(shape).astype(np.float32)
        x[0, 0] = 0.0
        want = JL.apply_moe_decode(p, jnp.asarray(x), cfg)
        got = TL.apply_moe_decode(tp, torch.from_numpy(x), tcfg)
        assert got.dtype == torch.float32 and got.shape == x.shape
        _close(got.numpy(), np.asarray(want), TOL["float32"])
