"""The port's low-precision training against the JAX package's, on the CPU:
``training.quant`` (the per-row int8 ``QTensor``), AdamW with bf16 and int8
moments, bf16 gradient accumulation, ``compress_grads``, a bf16 train step,
and the bridge and checkpoint round trips of bf16 and int8 moments.

Both sides start from one state: JAX's ``init_train_state(PRNGKey(seed))``
bridged into the port (``bridge.train_state_from_jax``); batches come from
a numpy seed. The JAX step runs its XLA attention (``attn_impl="xla"``),
the port its default, whose flash wrapper takes the plain forward and
backward on CPU tensors.

Tolerances, each with its reason:

* ``quant``: bitwise (the same f32 division, add, and round half to even).
* f32 values (loss, grad norm, f32 params) after one step: rtol = atol =
  2e-5, as ``tests/test_torch_training.py``: the sides differ in summation
  order only. AdamW's ``eps`` is 1e-6 there and here, for its reason: at
  1e-8 a gradient of rounding size (~1e-9, where the true gradient cancels
  to ~0) takes a step of up to 0.2 lr.
* A value stored in bf16 or int8 (a moment, a bf16-accumulated gradient)
  rounds an f32 value that the two sides may hold one f32 ulp apart, so it
  may land one rounding step apart: a bf16 moment within one bf16 ulp of
  its leaf's largest magnitude (2^-7 of it); an int8 moment within one
  quantization step (its row's scale) after dequantization. Such a flip
  moves the next update by up to a few percent of lr, so after the first
  step only the loss and grad norm are held at 2e-5 (their differences stay
  at rounding size), not every parameter.
* The bf16 train step (bf16 params, f32 moments): loss, grad norm and
  params at rtol = atol = 2e-2, the bf16 tolerance of
  ``tests/test_kernels.py``: the two sides round bf16 activations at other
  points (JAX's XLA attention in bf16, the port's plain flash in f32).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import optimizer as JO, quant as JQ, step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import CheckpointStore  # noqa: E402
from repro_torch.checkpoint.store import to_host  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS, reduced as t_reduced  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training import optimizer as TO, quant as TQ, step as TS  # noqa: E402

pytestmark = pytest.mark.timeout(300)

TOL = 2e-5
BF16_TOL = 2e-2
BF16_ULP = 2.0 ** -7   # bf16's spacing relative to a value's leading bit
RT = JM.Runtime(attn_impl="xla", scan_impl="chunked", remat="none", q_chunk=16,
                shard_activations=False)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _f32(x):
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _configs(name, n_layers=2):
    return (reduced(ARCHS[name], n_layers=n_layers),
            t_reduced(T_ARCHS[name], n_layers=n_layers))


def _hps(**kw):
    return (JO.OptHParams(lr=1e-3, warmup=2, eps=1e-6, **kw),
            TO.OptHParams(lr=1e-3, warmup=2, eps=1e-6, **kw))


def _batch(rng, cfg, accum, mb=2, S=16):
    toks = rng.integers(0, cfg.vocab, (accum, mb, S + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _moments_close(got, want, moment_dtype):
    """One moment tree (JAX layout) against another, as the module
    docstring states for each moment dtype."""
    gl = jax.tree.leaves(got, is_leaf=JQ.is_qtensor)
    wl = jax.tree.leaves(want, is_leaf=JQ.is_qtensor)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        if moment_dtype == "int8":
            assert a.q.dtype == b.q.dtype == np.int8
            _close(a.scale, b.scale, TOL)
            step = np.asarray(b.scale, np.float32)
            diff = np.abs(_f32(JQ.dequant(a)) - _f32(JQ.dequant(b)))
            assert (diff <= step * (1 + TOL) + 1e-30).all()
        elif moment_dtype == "bfloat16":
            assert a.dtype == b.dtype == jnp.bfloat16
            scale = max(float(np.abs(_f32(b)).max()), 1e-30)
            np.testing.assert_allclose(_f32(a) / scale, _f32(b) / scale,
                                       rtol=0, atol=BF16_ULP)
        else:
            _close(a, b, TOL)


# ---- quant -----------------------------------------------------------------


@pytest.mark.parametrize("shape", [(100,), (33, 77), (4, 5, 6), (64, 256)])
def test_quant_is_bitwise_jax(shape):
    """q and scale bit for bit, including a row of zeros (scale 1e-20)."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(shape) * 3).astype(np.float32)
    if len(shape) > 1:
        x[(0,) * (len(shape) - 1)] = 0.0
    want = JQ.quant(jnp.asarray(x))
    got = TQ.quant(torch.from_numpy(x))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    assert np.array_equal(got.q.numpy(), np.asarray(want.q))
    assert np.array_equal(got.scale.numpy().view(np.int32),
                          np.asarray(want.scale).view(np.int32))
    assert np.array_equal(TQ.dequant(got).numpy().view(np.int32),
                          np.asarray(JQ.dequant(want)).view(np.int32))


@pytest.mark.parametrize("shape", [(100,), (33, 77), (4, 5, 6)])
def test_quant_roundtrip_error_bounded(shape):
    """Mirror of tests/test_training_units.py's: the error of a round trip
    is bounded by each row's max / 127."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.standard_normal(shape) * 3).astype(np.float32))
    back = TQ.dequant(TQ.quant(x))
    assert back.shape == x.shape
    row_scale = x.abs().amax(-1, keepdim=True)
    assert bool(((back - x).abs() <= row_scale / 127 + 1e-6).all())


def test_quant_shape_preserving():
    q = TQ.qzeros_like(torch.zeros((35, 7168)))
    assert q.q.shape == (35, 7168) and q.q.dtype == torch.int8
    assert q.scale.shape == (35, 1) and q.scale.dtype == torch.float32
    assert TQ.is_qtensor(q) and not TQ.is_qtensor(q.q)


# ---- AdamW -----------------------------------------------------------------


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_descends(moment_dtype):
    """Mirror of tests/test_training_units.py's: 30 steps on sum(w^2) bring
    the loss below 1 with moments of each dtype."""
    hp = TO.OptHParams(lr=0.1, warmup=1, weight_decay=0.0,
                       moment_dtype=moment_dtype)
    params = torch.nn.Module()
    params.w = torch.nn.Parameter(torch.tensor([1.0, -2.0, 3.0]))
    opt = TO.init_opt_state(params, hp)
    leaf = TO.moment_leaves(opt["m"])[0]
    assert (leaf.q.dtype if moment_dtype == "int8" else leaf.dtype) == \
        TO.MOMENT_DTYPES[moment_dtype]
    for _ in range(30):
        (g,) = torch.autograd.grad(params.w.square().sum(), [params.w])
        TO.adamw_update([params.w], [g], opt, hp)
    assert float(params.w.detach().square().sum()) < 1.0
    assert int(opt["count"]) == 30


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_adamw_update_by_row_slices_is_bitwise_whole(moment_dtype,
                                                     monkeypatch):
    """A leaf above ``ADAMW_CHUNK`` elements is updated a slice of rows at
    a time: the same bits as the whole leaf at once, for params and moments
    of each dtype (a 3-d, a 2-d with a ragged last slice, and a 1-d leaf)."""
    hp = TO.OptHParams(lr=0.1, warmup=1, moment_dtype=moment_dtype)
    g = torch.Generator().manual_seed(0)
    shapes = [(5, 6, 7), (13, 11), (50,)]
    out = []
    for chunk in (TO.ADAMW_CHUNK, 40):
        monkeypatch.setattr(TO, "ADAMW_CHUNK", chunk)
        g.manual_seed(0)
        params = torch.nn.Module()
        for i, shape in enumerate(shapes):
            params.register_parameter(
                f"w{i}", torch.nn.Parameter(torch.randn(shape, generator=g)))
        opt = TO.init_opt_state(params, hp)
        leaves = list(params.parameters())
        for _ in range(3):
            TO.adamw_update(leaves, [torch.randn(x.shape, generator=g)
                                     for x in leaves], opt, hp)
        moments = [y for key in ("m", "v")
                   for x in TO.moment_leaves(opt[key])
                   for y in ((x.q, x.scale) if TQ.is_qtensor(x) else (x,))]
        out.append([x.detach() for x in leaves] + moments)
    assert len(TO._row_slices(leaves[0])) == 5     # 42-element rows
    assert len(TO._row_slices(leaves[1])) == 5     # 3 rows a slice, 13 rows
    assert all(torch.equal(a, b) for a, b in zip(*out))


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "int8"])
def test_adamw_update_matches_jax(moment_dtype):
    """One update from random moments stored in ``moment_dtype``: params at
    2e-5, moments as the module docstring states."""
    cfg, tcfg = _configs("internlm2-1.8b")
    hp, t_hp = _hps(moment_dtype=moment_dtype)
    state = JS.init_train_state(jax.random.PRNGKey(1), cfg, hp, jnp.float32)
    rng = np.random.default_rng(1)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)  # noqa: E731
    store = (JQ.quant if moment_dtype == "int8"
             else lambda x: x.astype(jnp.bfloat16))
    state["opt"]["m"] = jax.tree.map(lambda p: store(0.01 * noise(p)),
                                     state["params"])
    state["opt"]["v"] = jax.tree.map(lambda p: store(1e-4 * jnp.abs(noise(p))),
                                     state["params"])
    state["opt"]["count"] = jnp.asarray(4, jnp.int32)
    grads = jax.tree.map(lambda p: 0.05 * noise(p), state["params"])
    t_state = bridge.train_state_from_jax(_np_tree(state), tcfg, "cpu")
    t_grads = bridge.params_from_jax(_np_tree(grads), tcfg, "cpu")
    params, opt, gn = JO.adamw_update(state["params"], grads, state["opt"], hp)
    _, _, t_gn = TO.adamw_update(list(t_state["params"].parameters()),
                                 list(t_grads.parameters()), t_state["opt"],
                                 t_hp)
    got = bridge.train_state_to_jax(t_state, tcfg, qtensor=JQ.QTensor)
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(_np_tree(params))):
        _close(a, b, TOL)
    for key in ("m", "v"):
        _moments_close(got["opt"][key], _np_tree(opt[key]), moment_dtype)
    assert int(got["opt"]["count"]) == int(opt["count"]) == 5
    _close(t_gn.numpy(), gn, TOL)


def test_unknown_dtype_names_raise():
    for kw in (dict(moment_dtype="float16"), dict(grad_accum_dtype="int8")):
        with pytest.raises(ValueError):
            TO.OptHParams(**kw)


# ---- train steps -----------------------------------------------------------


def _run_both(name, hp_kw, accum, compress, dtype, steps=3):
    """``steps`` JAX and port train steps from one bridged state; yields
    (step index, JAX metrics, port metrics, JAX state, port state)."""
    cfg, tcfg = _configs(name)
    hp, t_hp = _hps(**hp_kw)
    state = JS.init_train_state(jax.random.PRNGKey(0), cfg, hp, dtype)
    t_state = bridge.train_state_from_jax(_np_tree(state), tcfg, "cpu")
    step = jax.jit(JS.make_train_step(cfg, hp, RT, compress_grads=compress))
    t_step = TS.make_train_step(tcfg, t_hp, TM.Runtime(remat="none"),
                                compress_grads=compress)
    rng = np.random.default_rng(3)
    for i in range(steps):
        batch = _batch(rng, cfg, accum)
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        t_state, t_metrics = t_step(t_state, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        yield i, metrics, t_metrics, state, t_state, tcfg


LOWPREC_STEPS = {
    # the _BIG preset's optimizer (bf16 moments, bf16 accumulation), accum 2
    "bf16-accum": (dict(moment_dtype="bfloat16", grad_accum_dtype="bfloat16"),
                   2, False),
    "compress-grads": ({}, 2, True),
    "int8-moments": (dict(moment_dtype="int8"), 1, False),
}


@pytest.mark.parametrize("case", sorted(LOWPREC_STEPS))
def test_low_precision_train_step_matches_jax(case):
    """Three f32-param steps of reduced internlm2 with the optimizer
    variant; loss and grad norm every step, params and moments after the
    first (module docstring)."""
    hp_kw, accum, compress = LOWPREC_STEPS[case]
    md = hp_kw.get("moment_dtype", "float32")
    for i, m, tm, state, t_state, tcfg in _run_both(
            "internlm2-1.8b", hp_kw, accum, compress, jnp.float32):
        for key in ("loss", "grad_norm", "ce"):
            _close(tm[key].detach().numpy(), m[key], TOL)
        if i == 0:
            got = bridge.train_state_to_jax(t_state, tcfg, qtensor=JQ.QTensor)
            want = _np_tree(state)
            assert int(got["step"]) == int(want["step"]) == 1
            for a, b in zip(jax.tree.leaves(got["params"]),
                            jax.tree.leaves(want["params"])):
                _close(a, b, TOL)
            for key in ("m", "v"):
                _moments_close(got["opt"][key], want["opt"][key], md)


def test_grad_compression_roundtrip_small_error():
    """Mirror of tests/test_training_units.py's: one step with
    ``compress_grads`` moves the params within 2% of their max from the
    step without it (two port states bridged from one JAX init)."""
    tcfg = t_reduced(T_ARCHS["internlm2-1.8b"], d_model=64, n_layers=2,
                     vocab=128)
    hp = TO.OptHParams(lr=1e-3)
    init = TS.init_train_state(torch.Generator().manual_seed(0), tcfg, hp,
                               torch.float32, "cpu")
    host = to_host(init)
    toks = torch.arange(2 * 2 * 17).reshape(2, 2, 17) % tcfg.vocab
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    out = {}
    for compress in (False, True):
        state = TS.train_state_from_host(host, tcfg, "cpu")
        state, metrics = TS.make_train_step(
            tcfg, hp, TM.Runtime(remat="none"), compress_grads=compress)(
            state, batch)
        out[compress] = (list(state["params"].parameters())[1].detach(),
                         float(metrics["loss"]))
    w1, w2 = out[False][0], out[True][0]
    rel = float((w1 - w2).abs().max() / (w1.abs().max() + 1e-9))
    assert 0 < rel < 0.02
    assert np.isfinite(out[True][1])


@pytest.mark.parametrize("name", ["internlm2-1.8b", "gemma2-9b"])
def test_bf16_train_step_matches_jax(name):
    """bf16 params (``init_train_state``'s default dtype) and the default
    optimizer (f32 moments and accumulation) on reduced internlm2 and
    gemma2 (softcaps, a local window, tied embeddings): loss, grad norm and
    params at the bf16 tolerance for two steps, f32 moments on both sides.
    (The moments are not held element by element: they are images of bf16
    gradients, which the two sides round at other points.)"""
    for i, m, tm, state, t_state, tcfg in _run_both(
            name, {}, 1, False, jnp.bfloat16, steps=2):
        for key in ("loss", "grad_norm"):
            _close(tm[key].detach().numpy(), m[key], BF16_TOL)
        got = bridge.train_state_to_jax(t_state, tcfg)
        want = _np_tree(state)
        for a, b in zip(jax.tree.leaves(got["params"]),
                        jax.tree.leaves(want["params"])):
            assert a.dtype == b.dtype
            _close(a, b, BF16_TOL)
        assert all(a.dtype == b.dtype == np.float32 for key in ("m", "v")
                   for a, b in zip(jax.tree.leaves(got["opt"][key]),
                                   jax.tree.leaves(want["opt"][key])))


# ---- round trips -----------------------------------------------------------


def _jax_state_with_moments(name, moment_dtype, dtype=jnp.bfloat16):
    """A JAX train state whose moments are non-zero: one AdamW update."""
    cfg, tcfg = _configs(name)
    hp, _ = _hps(moment_dtype=moment_dtype)
    state = JS.init_train_state(jax.random.PRNGKey(2), cfg, hp, dtype)
    rng = np.random.default_rng(5)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype),
        state["params"])
    params, opt, _ = JO.adamw_update(state["params"], grads, state["opt"], hp)
    return {"params": params, "opt": opt, "step": state["step"] + 1}, tcfg


ROUND_TRIPS = [(name, md) for name in ("internlm2-1.8b", "falcon-mamba-7b")
               for md in ("bfloat16", "int8")]


def _leaves_equal(a, b):
    la = jax.tree.leaves(a, is_leaf=JQ.is_qtensor)
    lb = jax.tree.leaves(b, is_leaf=JQ.is_qtensor)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        for u, w in ((x.q, y.q), (x.scale, y.scale)) if JQ.is_qtensor(x) else ((x, y),):
            u, w = np.asarray(u), np.asarray(w)
            assert u.dtype == w.dtype and u.shape == w.shape
            assert np.array_equal(u.reshape(-1).view(np.uint8),
                                  w.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("name, moment_dtype", ROUND_TRIPS)
def test_bridge_round_trips_low_precision_moments(name, moment_dtype):
    """bf16 params with bf16 or int8 (JAX ``QTensor``) moments -> port ->
    JAX, bit for bit (falcon-mamba: its f32 ``A_log``, ``D`` and
    ``dt_bias`` beside bf16 moments of them)."""
    state, tcfg = _jax_state_with_moments(name, moment_dtype)
    state = _np_tree(state)
    t_state = bridge.train_state_from_jax(state, tcfg, "cpu")
    m = TO.moment_leaves(t_state["opt"]["m"])
    if moment_dtype == "int8":
        assert all(TQ.is_qtensor(x) for x in m) and any(bool(x.q.any()) for x in m)
    else:
        assert all(x.dtype == torch.bfloat16 for x in m)
    back = bridge.train_state_to_jax(t_state, tcfg, qtensor=JQ.QTensor)
    assert (jax.tree.structure(back, is_leaf=JQ.is_qtensor)
            == jax.tree.structure(state, is_leaf=JQ.is_qtensor))
    _leaves_equal(back, state)


@pytest.mark.parametrize("name, moment_dtype", ROUND_TRIPS)
def test_checkpoint_round_trips_low_precision_moments(tmp_path, name,
                                                      moment_dtype):
    """``CheckpointStore`` save and ``train_state_from_host`` of a port state
    with bf16 params and bf16 or int8 moments: every leaf bit for bit."""
    state, tcfg = _jax_state_with_moments(name, moment_dtype)
    t_state = bridge.train_state_from_jax(_np_tree(state), tcfg, "cpu")
    store = CheckpointStore(str(tmp_path))
    store.save(t_state, 1)
    step, host = store.latest()
    assert step == 1
    back = TS.train_state_from_host(host, tcfg, "cpu")
    _leaves_equal(bridge.train_state_to_jax(back, tcfg, qtensor=JQ.QTensor),
                  bridge.train_state_to_jax(t_state, tcfg, qtensor=JQ.QTensor))
    assert back["params"].embed.requires_grad


def test_init_train_state_makes_the_moment_dtype():
    """The port's own init: bf16 params, moments of each dtype (int8 as
    zero ``QTensor``s in the parameters' shapes)."""
    _, tcfg = _configs("internlm2-1.8b")
    for md in ("float32", "bfloat16", "int8"):
        hp = TO.OptHParams(moment_dtype=md)
        state = TS.init_train_state(torch.Generator().manual_seed(0), tcfg, hp,
                                    device="cpu")
        assert state["params"].embed.dtype == torch.bfloat16
        names = [n for n, _ in state["params"].named_parameters()]
        m = state["opt"]["m"]
        if md == "int8":
            assert list(m) == names
            for (_, p), x in zip(state["params"].named_parameters(), m.values()):
                assert x.q.shape == p.shape and not x.q.any()
                assert x.scale.shape == p.shape[:-1] + (1,)
        else:
            assert all(t.dtype == TO.MOMENT_DTYPES[md] and not t.requires_grad
                       for t in m.parameters())
