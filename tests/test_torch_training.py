"""The port's loss, AdamW and train step against the JAX package's, on the
CPU.

Both sides start from the same state: the JAX package's
``init_train_state(PRNGKey(seed))`` in f32, bridged into the port
(``bridge.train_state_from_jax``); batches come from a numpy seed. The JAX
step runs its XLA attention (``attn_impl="xla"``, the path it
differentiates); the port runs its default, whose flash wrapper on CPU
tensors takes the plain forward and the plain backward
(``ref.flash_attention_backward_ref``) inside ``ops.FlashAttention``.

Tolerance: rtol = atol = 2e-5 (f32) for the loss, one AdamW update, and the
train step's loss, grad norm, params and moments after 1 and 3 steps: the
two sides differ in summation order only (the global norm also sums its
leaves in another order). Both sides use AdamW's ``eps = 1e-6`` here: at
the default 1e-8 a gradient of rounding size (~1e-9, where the true
gradient cancels to ~0; its sign is the rounding's) takes a step of up to
0.2 lr, and one element of 65,536 in an MLP weight moved by 1.0e-4.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS, reduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.training import loss as JLoss, optimizer as JO, step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS, reduced as t_reduced  # noqa: E402
from repro_torch.training import loss as TLoss, optimizer as TO, step as TS  # noqa: E402
from tests.test_torch_model import _configs as _model_configs  # noqa: E402

pytestmark = pytest.mark.timeout(300)

HP = JO.OptHParams(lr=1e-3, warmup=2, eps=1e-6)
T_HP = TO.OptHParams(lr=1e-3, warmup=2, eps=1e-6)
TOL = 2e-5


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _close_trees(got, want, tol):
    gl, wl = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert np.shape(a) == np.shape(b)
        _close(a, b, tol)


def _configs(name):
    """The reduced configs of tests/test_archs_smoke.py; "-padded" gives
    test_torch_model.py's padded variant (heads and vocab padded)."""
    if name.endswith("-padded"):
        return _model_configs(name)
    full, t_full = ARCHS[name], T_ARCHS[name]
    n = 2 * len(full.block) if len(full.block) == 1 else len(full.block)
    return reduced(full, n_layers=n), t_reduced(t_full, n_layers=n)


def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((2, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (2, 7)).astype(np.int32)
    labels[0, :3] = -1
    for lab in (labels, np.full_like(labels, -1)):
        want = JLoss.cross_entropy(jnp.asarray(logits), jnp.asarray(lab))
        got = TLoss.cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab))
        _close(got.numpy(), want, TOL)


def test_adamw_update_matches_jax():
    cfg, tcfg = _configs("internlm2-1.8b")
    state = JS.init_train_state(jax.random.PRNGKey(1), cfg, HP, jnp.float32)
    rng = np.random.default_rng(1)
    noise = lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32)
    state["opt"]["m"] = jax.tree.map(lambda p: 0.01 * noise(p), state["params"])
    state["opt"]["v"] = jax.tree.map(lambda p: 1e-4 * jnp.abs(noise(p)),
                                     state["params"])
    state["opt"]["count"] = jnp.asarray(4, jnp.int32)
    grads = jax.tree.map(lambda p: 0.05 * noise(p), state["params"])
    t_state = bridge.train_state_from_jax(_np_tree(state), tcfg, "cpu")
    t_grads = bridge.params_from_jax(_np_tree(grads), tcfg, "cpu")
    params, opt, gn = JO.adamw_update(state["params"], grads, state["opt"], HP)
    _, t_opt, t_gn = TO.adamw_update(list(t_state["params"].parameters()),
                                     list(t_grads.parameters()),
                                     t_state["opt"], T_HP)
    got = bridge.train_state_to_jax(t_state, tcfg)
    _close_trees(got["params"], _np_tree(params), TOL)
    _close_trees(got["opt"]["m"], _np_tree(opt["m"]), TOL)
    _close_trees(got["opt"]["v"], _np_tree(opt["v"]), TOL)
    assert int(got["opt"]["count"]) == int(opt["count"]) == 5
    _close(t_gn.numpy(), gn, TOL)


def test_train_state_bridge_round_trips():
    cfg, tcfg = _configs("gemma2-9b")
    state = _np_tree(JS.init_train_state(jax.random.PRNGKey(2), cfg, HP,
                                         jnp.float32))
    back = bridge.train_state_to_jax(
        bridge.train_state_from_jax(state, tcfg, "cpu"), tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def _batch(rng, cfg, accum, mb, S):
    toks = rng.integers(0, cfg.vocab, (accum, mb, S + 1)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", ["internlm2-1.8b", "qwen3-32b", "gemma2-9b",
                                  "falcon-mamba-7b", "chameleon-34b",
                                  "starcoder2-7b-padded"])
def test_train_step_matches_jax(name, accum):
    """Three steps from one bridged state; compared after the first and the
    third (gemma2: local window 8 at S = 16, softcaps, tied embeddings;
    qwen3: qk-norm; falcon-mamba: the port's scan gradient through
    ``ops.SelectiveScan`` against JAX's chunked path, the one JAX trains
    through; starcoder2 with its heads and vocab padded)."""
    cfg, tcfg = _configs(name)
    rng = np.random.default_rng(3)
    state = JS.init_train_state(jax.random.PRNGKey(0), cfg, HP, jnp.float32)
    t_state = bridge.train_state_from_jax(_np_tree(state), tcfg, "cpu")
    rt = JM.Runtime(attn_impl="xla", scan_impl="chunked", remat="none",
                    q_chunk=16, shard_activations=False)
    step = jax.jit(JS.make_train_step(cfg, HP, rt))
    t_step = TS.make_train_step(tcfg, T_HP)
    for i in range(3):
        batch = _batch(rng, cfg, accum, 2, 16)
        state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        t_state, t_metrics = t_step(t_state, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
        for key in ("loss", "grad_norm"):
            _close(t_metrics[key].detach().numpy(), metrics[key], TOL)
        _close(t_metrics["ce"].detach().numpy(), metrics["ce"], TOL)
        if i in (0, 2):
            got = bridge.train_state_to_jax(t_state, tcfg)
            want = _np_tree(state)
            assert int(got["step"]) == int(want["step"]) == i + 1
            assert int(got["opt"]["count"]) == int(want["opt"]["count"])
            _close_trees(got["params"], want["params"], TOL)
            _close_trees(got["opt"]["m"], want["opt"]["m"], TOL)
            _close_trees(got["opt"]["v"], want["opt"]["v"], TOL)


def test_init_train_state_layout():
    _, tcfg = _configs("internlm2-1.8b")
    state = TS.init_train_state(torch.Generator().manual_seed(0), tcfg, T_HP,
                                torch.float32, "cpu")
    names = [n for n, _ in state["params"].named_parameters()]
    assert [n for n, _ in state["opt"]["m"].named_parameters()] == names
    assert all(p.requires_grad for p in state["params"].parameters())
    assert not any(m.requires_grad or m.any()
                   for m in state["opt"]["v"].parameters())
    assert int(state["step"]) == 0 and state["step"].dtype == torch.int32


def test_checkpoint_store_round_trips(tmp_path):
    from repro_torch.checkpoint import CheckpointStore
    _, tcfg = _configs("gemma2-9b")
    state = TS.init_train_state(torch.Generator().manual_seed(0), tcfg, T_HP,
                                torch.float32, "cpu")
    store = CheckpointStore(str(tmp_path))
    assert store.latest() == (None, None) and store.status(3) == "unknown"
    for s in (3, 6, 9):
        state["step"] += 3
        store.save(state, s)
    assert store.status(9) == "success"
    store.gc(keep=2)
    assert store.status(3) == "unknown" and store.status(6) == "success"
    step, host = store.latest()
    assert step == 9 and isinstance(host["params"]["embed"], np.ndarray)
    back = TS.train_state_from_host(host, tcfg, "cpu")
    for a, b in zip(back["params"].parameters(), state["params"].parameters()):
        assert torch.equal(a, b)
    assert int(back["step"]) == 9 and back["params"].embed.requires_grad
