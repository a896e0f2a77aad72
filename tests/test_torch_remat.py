"""``Runtime.remat`` of the port against its own ``remat="none"`` and
against the JAX package's ``train_step`` with the same remat, on the CPU.

Remat recomputes a block's forward in the backward ("full": only the
block's inputs are kept; "block": the outputs of products with no batch
dimension too). It changes no value, so one port train step with remat is
bitwise equal to one without: loss, grads, params and moments. Against
JAX (XLA attention, the chunked scan, ``q_chunk=16``) the tolerance is
``test_torch_training.py``'s TOL (rtol = atol = 2e-5, f32), as for the
steps without remat. Families: dense (internlm2), gemma2 (a local/global
block of two, softcaps, a tied embedding), falcon-mamba, grok with its
experts split in two (MoE), jamba (the 8-layer block: "full" only, its
cases are the slowest here) and seamless (the encoder, checkpointed a
layer at a time, and cross-attention). The port runs under
``torch.use_deterministic_algorithms(True)``, as it trains on the card:
without it the CPU's accumulating ``index_put_`` (the backward of the MoE
gathers) adds in an order that varies from run to run.

``test_remat_keeps_fewer_bytes`` counts the bytes one forward leaves alive
for the backward. The products "block" keeps are held by the selective
checkpoint's own cache, which ``saved_tensors_hooks`` never sees (the
hooks see only what autograd packs, and a checkpoint packs placeholders),
so the count follows storages instead (``tools/train_memory_probe.py``'s
``LiveBytes``): every tensor an op makes during the forward is watched
through a weak reference to its storage, and those still alive when the
forward has returned are summed, the params' own storages left out.
"""
import contextlib
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

from repro.models import model as JM  # noqa: E402
from repro.training import step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.training import loss as TLoss, step as TS  # noqa: E402
from tests.test_torch_training import (HP, T_HP, TOL, _batch, _close,  # noqa: E402
                                       _close_trees, _configs, _np_tree)

pytestmark = pytest.mark.timeout(300)
ROOT = Path(__file__).resolve().parents[1]

CASES = [(name, remat) for name in (
    "internlm2-1.8b", "gemma2-9b", "falcon-mamba-7b", "grok-1-314b-split2",
    "seamless-m4t-large-v2") for remat in ("block", "full")] + [
    ("jamba-1.5-large-398b", "full")]


def _state_leaves(state):
    return [t.detach() for mod in (state["params"], state["opt"]["m"],
                                   state["opt"]["v"])
            for t in mod.parameters()]


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """The JAX config, the port's, a JAX train state in f32 and a batch
    [accum 1, mb 2, S 16] from a numpy seed."""
    cfg, tcfg = _configs(name)
    state = JS.init_train_state(jax.random.PRNGKey(0), cfg, HP, jnp.float32)
    return cfg, tcfg, state, _batch(np.random.default_rng(3), cfg, 1, 2, 16)


@contextlib.contextmanager
def _deterministic():
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


@functools.lru_cache(maxsize=None)
@_deterministic()
def _port_step(name, remat):
    """The port's grads of the first microbatch and one train step, both at
    ``remat``, from the bridged state: (loss, grads, state leaves)."""
    _, tcfg, state, batch = _inputs(name)
    rt = TM.Runtime(remat=remat)
    t_state = bridge.train_state_from_jax(_np_tree(state), tcfg, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    mb = {k: v[0] for k, v in tb.items()}
    mb["tokens"] = mb["tokens"].long()
    params = t_state["params"]
    grads = torch.autograd.grad(TLoss.loss_fn(params, mb, tcfg, rt)[0],
                                list(params.parameters()))
    t_state, metrics = TS.make_train_step(tcfg, T_HP, rt)(t_state, tb)
    return metrics["loss"], grads, _state_leaves(t_state), t_state


@pytest.mark.parametrize("name, remat", CASES)
def test_remat_step_is_bitwise_none_and_matches_jax(name, remat):
    loss, grads, leaves, t_state = _port_step(name, remat)
    want_loss, want_grads, want_leaves, _ = _port_step(name, "none")
    assert torch.equal(loss, want_loss)
    assert len(grads) == len(want_grads) and len(leaves) == len(want_leaves)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))
    assert all(torch.equal(a, b) for a, b in zip(leaves, want_leaves))
    cfg, tcfg, state, batch = _inputs(name)
    rt = JM.Runtime(attn_impl="xla", scan_impl="chunked", remat=remat,
                    q_chunk=16, shard_activations=False)
    state, metrics = jax.jit(JS.make_train_step(cfg, HP, rt))(
        state, {k: jnp.asarray(v) for k, v in batch.items()})
    _close(loss.numpy(), metrics["loss"], TOL)
    got, want = bridge.train_state_to_jax(t_state, tcfg), _np_tree(state)
    _close_trees(got["params"], want["params"], TOL)
    _close_trees(got["opt"]["m"], want["opt"]["m"], TOL)
    _close_trees(got["opt"]["v"], want["opt"]["v"], TOL)


def _probe():
    spec = importlib.util.spec_from_file_location(
        "train_memory_probe", ROOT / "tools" / "train_memory_probe.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["internlm2-1.8b", "grok-1-314b-split2"])
def test_remat_keeps_fewer_bytes(name):
    """The bytes one train forward leaves alive for its backward fall
    strictly from "none" to "block" to "full"."""
    _, tcfg, state, batch = _inputs(name)
    params = bridge.train_state_from_jax(_np_tree(state), tcfg, "cpu")["params"]
    mb = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
    mb["tokens"] = mb["tokens"].long()
    skip = {t.untyped_storage().data_ptr() for t in params.parameters()}
    kept = {}
    for remat in ("none", "block", "full"):
        mode = _probe().LiveBytes(skip)
        with mode:
            loss = TLoss.loss_fn(params, mb, tcfg, TM.Runtime(remat=remat))[0]
        kept[remat] = mode.alive()
        del loss
    assert kept["none"] > kept["block"] > kept["full"] > 0, kept


class _Saved(TorchDispatchMode):
    """Records each op ``model._save_products`` would keep under remat
    "block": its name and its output's shape."""

    def __init__(self):
        super().__init__()
        self.saved = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if TM._save_products(None, func, *args, **(kwargs or {})) \
                == CheckpointPolicy.MUST_SAVE:
            self.saved.append((str(func), tuple(out.shape)))
        return out


def _projections(cfg, N: int, Ns: int) -> list:
    """The products with no batch dimension of one block, in order: each
    reaches ``aten.bmm`` with a batch of 1 and output [1, rows, width]."""
    hd, kvd = cfg.n_heads * cfg.d_head, cfg.n_kv_heads * cfg.d_head
    out = []
    for spec in cfg.layer_kinds()[:len(cfg.block)]:
        if spec.mixer == "attn":
            out += [(N, hd), (N, kvd), (N, kvd), (N, cfg.d_model)]
        else:
            out += [(N, 2 * cfg.d_inner),
                    (N, cfg.dt_rank + 2 * cfg.mamba.d_state),
                    (N, cfg.d_inner), (N, cfg.d_model)]
        if cfg.enc_dec:
            out += [(N, hd), (Ns, kvd), (Ns, kvd), (N, cfg.d_model)]
        if spec.ffn in ("moe", "moe_dense"):
            out += [(N, cfg.moe.n_experts)]
        if spec.ffn in ("dense", "moe_dense"):
            out += [(N, cfg.d_ff), (N, cfg.d_ff), (N, cfg.d_model)]
    return [("aten.bmm.default", (1,) + shape) for shape in out]


@pytest.mark.parametrize("name", [
    "internlm2-1.8b", "gemma2-9b", "falcon-mamba-7b", "grok-1-314b-split2",
    "seamless-m4t-large-v2", "jamba-1.5-large-398b"])
def test_block_policy_saves_exactly_the_projections(name):
    """Remat "block" keeps the outputs of exactly the block's projections
    (attention's q, k, v and o, a cross half's, the dense MLP's three, the
    router's logits, Mamba's four) and nothing else: not the experts'
    products (the expert is their batch), not Mamba's h.C, not attention's
    scores, not the kernels' outputs. The policy decides from the op and
    its batch alone, so a torch that lowers einsum otherwise, or a shape
    whose batch is 1 by chance, shows here."""
    _, cfg = _configs(name)
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            torch.float32, "cpu")
    B, S, Ss = 2, 16, 12
    g = torch.Generator().manual_seed(1)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    memory = (torch.randn(B, Ss, cfg.d_model, generator=g) if cfg.enc_dec
              else None)
    nb = len(cfg.block)
    mode = _Saved()
    with mode:
        TM._block(params.layers[:nb], cfg.layer_kinds()[:nb], x,
                  torch.arange(S)[None], memory,
                  torch.arange(Ss)[None] if cfg.enc_dec else None, cfg,
                  TM.Runtime())
    assert mode.saved == _projections(cfg, B * S, B * Ss)


@pytest.mark.parametrize("name, remat", [
    (name, remat) for name in (
        "internlm2-1.8b", "gemma2-9b", "falcon-mamba-7b",
        "grok-1-314b-split2", "seamless-m4t-large-v2")
    for remat in ("block", "full")])
def test_train_memory_reckons_the_bytes_remat_keeps(name, remat):
    """``chip_smoke.train_units``, which sets how deep each train cell on
    the card goes, reckons to the byte what one unit keeps for the backward
    under remat, per token: counted on the CPU by
    ``tools/train_memory_probe.py`` at one unit and two, S 32 and 64."""
    _, cfg = _configs(name)
    (kept, reckoned), _ = _probe().per_token(cfg, torch.float32, remat, 32, 64)
    assert kept == reckoned > 0


def test_runtime_rejects_unknown_remat():
    assert TM.Runtime().remat == JM.Runtime().remat == "block"
    with pytest.raises(ValueError, match="remat"):
        TM.Runtime(remat="bogus")


@pytest.mark.parametrize("remat", ["block", "full"])
def test_fused_mamba_remat_is_bitwise_none(remat):
    """falcon-mamba at S = 512 takes JAX's chunked branch (the fused scan;
    on the CPU its plain versions through ``ops.SelectiveScanFused``): one
    microbatch's loss and grads under remat are bitwise those without, and
    "block" keeps exactly the block's four projections there too (the
    fused scan, like the materialised one, is recomputed)."""
    _, cfg = _configs("falcon-mamba-7b")
    params = TM.init_params(torch.Generator().manual_seed(0), cfg,
                            torch.float32, "cpu").requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab, (2, 513), generator=g)
    mb = {"tokens": toks[:, :-1], "labels": toks[:, 1:].to(torch.int32)}
    leaves = list(params.parameters())
    with _deterministic():
        out = {}
        for r in ("none", remat):
            loss = TLoss.loss_fn(params, mb, cfg, TM.Runtime(remat=r))[0]
            out[r] = (loss, torch.autograd.grad(loss, leaves))
    assert torch.equal(out["none"][0], out[remat][0])
    assert all(torch.equal(a, b) for a, b in zip(out["none"][1], out[remat][1]))
    if remat == "block":
        nb = len(cfg.block)
        x = torch.randn(2, 512, cfg.d_model, generator=g)
        mode = _Saved()
        with mode:
            TM._block(params.layers[:nb], cfg.layer_kinds()[:nb], x,
                      torch.arange(512)[None], None, None, cfg, TM.Runtime())
        assert mode.saved == _projections(cfg, 2 * 512, 0)
