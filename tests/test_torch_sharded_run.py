"""The port's sharded ``forward``, ``train_step`` and ``serve_step`` over
gloo, against the JAX package and against the port unsharded, on the CPU.

One spawn of 4 ranks (``tests/torch_sharded_runner.py``, a ``FileStore`` in
``tmp_path``, one thread a rank, a 60 s process-group timeout and a join
deadline, so a hung collective fails these tests and not the suite) runs
every case on a CPU ``DeviceMesh`` with the default strategy of
``parallel.sharding.ShardingStrategy.for_mesh``: FSDP on "data", TP on
heads / mlp / inner / vocab, EP (or ``expert_mlp``), the decode cache's
sequence on "model", the batch on "data". Weights come from seeded JAX
inits (``PRNGKey``), bridged; batches from numpy seeds. The JAX side runs
unsharded (its XLA attention and chunked scan), as the unsharded parity
tests do.

Cases, on a (2, 2) ("data", "model") mesh unless said:
  * internlm2: dense GQA, 4 heads / 2 kv on model 2 (the local heads hold a
    whole group); int8 AdamW moments;
  * internlm2-kv1 on (1, 4): 4 heads / 1 kv on model 4 (the group spans
    the ranks' heads);
  * gemma2: softcaps, sliding window, local/global layers, tied embedding;
  * grok: MoE with EP (4 experts on model 2); grok-noep: ``ep=False``, TP
    inside each expert (``expert_mlp``), and its forward again with the
    runtime's ``ep`` turned on (the experts redistributed to EP);
  * grok-chunk: EP with ``MOE_TOKEN_CHUNK`` 128 (patched in the ranks and in
    both references) over 256 forward tokens, so each rank's tokens are one
    whole capacity block; grok-chunk-dp on (4, 1), chunks of 16 over ranks
    of 8 tokens, so each block spans two ranks, and its serve batch (2
    slots) stays whole. Both zero the router: uniform probs, so every
    token ties and picks the lowest ids, and the forward's blocks of 128
    overflow their capacity (96): the tie break and the pinned slot-0
    overflow rule hold sharded;
  * falcon-mamba: d_inner on model ("inner"); falcon-mamba-512 the same
    at S = 512 (forward [2, 512], train [1, 2, 512]): JAX's chunked branch,
    the fused scan on each rank's d_inner channels, whose dB and dC are
    partial sums over them;
  * jamba: Mamba + attention + MoE in one block;
  * seamless: the encoder-decoder, its cross cache on ``kv_seq``;
  * internlm2-pad: 3 heads / 1 kv padded to 4 for model 2
    (``padded_for_tp``): the padded head zeroed on each rank's heads, in
    the forward and in decode, whose output holds every head.

Tolerances. Against JAX: rtol = atol = 2e-5, those of the unsharded parity
tests (``test_torch_model.py`` forward and decode, ``test_torch_training.py``
train step with AdamW ``eps`` 1e-6); an int8 moment within one quantization
step (its row's scale) after dequantization, as ``test_torch_lowprec.py``.
Against the port unsharded: every leaf within 1e-5 of its largest magnitude
(the sides differ in the order of the collectives' sums): the logits, the
caches, the loss, the gradient norm and the moments m and v (which hold the
gradients); int8 moments as above; the params after the AdamW step at
rtol = atol = 2e-5, the train parity tolerance, since AdamW divides by
sqrt(v) + eps and so magnifies the rounding of a near-zero gradient (a
zero-initialised norm scale moves by lr_t g / (|g| + eps)). The sharded
train step repeated from the same state is bitwise equal.
"""
import contextlib
import pickle
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget, reduced as jreduced  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.serving.decode import serve_step as jserve  # noqa: E402
from repro.training import optimizer as JO, quant as JQ, step as JS  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config as tget, reduced as treduced  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serving import serve_step as tserve  # noqa: E402
from repro_torch.training import optimizer as TO, step as TSt  # noqa: E402

pytestmark = pytest.mark.timeout(600)

WORLD = 4
TOL = 2e-5
REL = 1e-5
HP = dict(lr=1e-3, warmup=2, eps=1e-6)

# name: (arch, reduced() kwargs, mesh shape, ep, moment dtype[, extras:
# moe_chunk (MOE_TOKEN_CHUNK), fwd / train (the forward's tokens, the train
# batch's shape), zero_router, flip_ep (a second forward with the runtime's
# ep flipped), pad_tp (both configs padded for the mesh's model axis)])
CASES = {
    "internlm2": ("internlm2-1.8b", {}, (2, 2), True, "int8"),
    "internlm2-kv1": ("internlm2-1.8b", dict(n_kv_heads=1), (1, 4), True,
                      "float32"),
    "gemma2": ("gemma2-9b", {}, (2, 2), True, "float32"),
    "grok": ("grok-1-314b", {}, (2, 2), True, "float32"),
    "grok-noep": ("grok-1-314b", {}, (2, 2), False, "float32",
                  dict(flip_ep=True)),
    "grok-chunk": ("grok-1-314b", {}, (2, 2), True, "float32",
                   dict(moe_chunk=128, fwd=(4, 64), zero_router=True)),
    "grok-chunk-dp": ("grok-1-314b", {}, (4, 1), True, "float32",
                      dict(moe_chunk=16, train=(1, 4, 8), zero_router=True)),
    "falcon-mamba": ("falcon-mamba-7b", {}, (2, 2), True, "float32"),
    "falcon-mamba-512": ("falcon-mamba-7b", {}, (2, 2), True, "float32",
                         dict(fwd=(2, 512), train=(1, 2, 512))),
    "jamba": ("jamba-1.5-large-398b", dict(d_model=64, d_ff=128), (2, 2),
              True, "float32"),
    "seamless": ("seamless-m4t-large-v2", {}, (2, 2), True, "float32"),
    "internlm2-pad": ("internlm2-1.8b", dict(d_model=96, n_heads=3,
                                             n_kv_heads=1), (2, 2), True,
                      "float32", dict(pad_tp=True)),
}
FWD = (4, 8)             # forward tokens [B, S]
TRAIN = (1, 2, 16)       # train batch [accum, mb, S]
SERVE = (2, 8, 8)        # serve: B slots, cache S, steps (positions pass S)
CROSS = 8                # an encoder-decoder's cross cache length


def _extra(name) -> dict:
    return CASES[name][5] if len(CASES[name]) > 5 else {}


def _key(name):
    """What decides a case's inputs and references."""
    arch, kw, _, _, moment = CASES[name][:5]
    ex = _extra(name)
    return (arch, tuple(sorted(kw.items())), moment,
            tuple(sorted(ex.items() - {("flip_ep", True)})))


@contextlib.contextmanager
def _moe_chunk(chunk):
    """Both packages' ``MOE_TOKEN_CHUNK`` set to ``chunk`` (None: as they
    are)."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL
    old = JL.MOE_TOKEN_CHUNK, TL.MOE_TOKEN_CHUNK
    if chunk is not None:
        JL.MOE_TOKEN_CHUNK = TL.MOE_TOKEN_CHUNK = chunk
    try:
        yield
    finally:
        JL.MOE_TOKEN_CHUNK, TL.MOE_TOKEN_CHUNK = old


def _zero(tree, leaf):
    """Zero every array named ``leaf`` in a tree of dicts and lists."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if k == leaf:
            v[...] = 0
        elif isinstance(v, (dict, list)):
            _zero(v, leaf)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(name):
    arch, kw, mesh = CASES[name][:3]
    cfgs = jreduced(jget(arch), **kw), treduced(tget(arch), **kw)
    if _extra(name).get("pad_tp"):
        cfgs = tuple(c.padded_for_tp(mesh[1]) for c in cfgs)
    return cfgs


def _zeros_moment(np_params, moment: str):
    """Zero AdamW moments in the JAX layout (int8: q and scale, as JAX's
    ``qzeros_like``), numpy only."""
    def one(p):
        if moment == "int8":
            return types.SimpleNamespace(
                q=np.zeros(p.shape, np.int8),
                scale=np.zeros(p.shape[:-1] + (1,), np.float32))
        return np.zeros(p.shape, np.dtype(moment))
    return jax.tree.map(one, np_params)


def _job(name):
    """The case's inputs for the ranks (and the references), numpy only:
    weights from a seed (the port's init, in the JAX layout), the train
    state with zero moments as JAX's ``init_opt_state`` makes them,
    batches, serve tokens and the cache."""
    arch, kw, mesh, ep, moment = CASES[name][:5]
    cfg, tcfg = _configs(name)
    rng = np.random.default_rng(11)
    np_params = bridge.params_to_jax(TM.init_params(
        torch.Generator().manual_seed(2), tcfg, torch.float32, "cpu"), tcfg)
    if _extra(name).get("zero_router"):
        _zero(np_params, "router")
    B, Sq = _extra(name).get("fwd", FWD)
    fb = {"tokens": rng.integers(0, cfg.vocab, (B, Sq)).astype(np.int32)}
    if cfg.enc_dec:
        fb["frames"] = rng.standard_normal((B, Sq, cfg.d_model)).astype(
            np.float32)
    accum, mb, St = _extra(name).get("train", TRAIN)
    tt = rng.integers(0, cfg.vocab, (accum, mb, St + 1)).astype(np.int32)
    tb = {"tokens": tt[..., :-1], "labels": tt[..., 1:]}
    if cfg.enc_dec:
        tb["frames"] = rng.standard_normal((accum, mb, St, cfg.d_model)
                                           ).astype(np.float32)
    Bs, Sc, steps = SERVE
    state = {"params": np_params,
             "opt": {"m": _zeros_moment(np_params, moment),
                     "v": _zeros_moment(np_params, moment),
                     "count": np.zeros((), np.int32)},
             "step": np.zeros((), np.int32)}
    cache = [{k: np.zeros(v.shape, np.float32) for k, v in c.items()}
             for c in bridge.cache_to_jax(TM.init_cache(
                 tcfg, Bs, Sc, torch.float32, "cpu", cross_len=CROSS))]
    return {"name": name, "cfg": tcfg, "mesh": mesh,
            "axes": ("data", "model"), "ep": ep, "params": np_params,
            "moe_chunk": _extra(name).get("moe_chunk"),
            "tokens": fb["tokens"], "frames": fb.get("frames"),
            "state": state, "hp": dict(moment_dtype=moment, **HP),
            "train_batch": tb, "cache": cache,
            "serve_tokens": rng.integers(0, cfg.vocab, (Bs, steps)
                                         ).astype(np.int32),
            "serve_pos": np.stack([np.array([i, i + 5], np.int32)
                                   for i in range(steps)])}


def _references(job):
    """What the case is held to: the JAX package's results (XLA attention,
    chunked scan) and the port's, both unsharded, on the job's inputs."""
    with _moe_chunk(job["moe_chunk"]):
        return _references_of(job)


def _references_of(job):
    cfg, tcfg = _configs(job["name"])
    moment = job["hp"]["moment_dtype"]
    params = jax.tree.map(jnp.asarray, job["params"])
    tp = bridge.params_from_jax(job["params"], tcfg, "cpu")
    fb = {"tokens": job["tokens"]}
    if cfg.enc_dec:
        fb["frames"] = job["frames"]
    jl, jaux = JM.forward(params, {k: jnp.asarray(v) for k, v in fb.items()},
                          cfg, JM.Runtime(q_chunk=8))
    with torch.no_grad():
        tl, taux = TM.forward(tp, {k: torch.from_numpy(v) for k, v in
                                   fb.items()}, tcfg, TM.Runtime())

    tb = job["train_batch"]
    jhp = JO.OptHParams(**job["hp"])
    state = jax.tree.map(
        lambda x: (JQ.QTensor(jnp.asarray(x.q), jnp.asarray(x.scale))
                   if isinstance(x, types.SimpleNamespace) else jnp.asarray(x)),
        job["state"], is_leaf=lambda x: isinstance(x, types.SimpleNamespace))
    jrt = JM.Runtime(attn_impl="xla", scan_impl="chunked", remat="none",
                     q_chunk=16)
    jstate, jmet = jax.jit(JS.make_train_step(cfg, jhp, jrt))(
        state, {k: jnp.asarray(v) for k, v in tb.items()})
    tstate = bridge.train_state_from_jax(job["state"], tcfg, "cpu")
    tstate, tmet = TSt.train_step(tstate, {k: torch.from_numpy(v) for k, v
                                           in tb.items()},
                                  cfg=tcfg, hp=TO.OptHParams(**job["hp"]),
                                  rt=TM.Runtime(remat="none"))
    qt = lambda q, s: {"q": q, "scale": s}  # noqa: E731

    cache = jax.tree.map(jnp.asarray, job["cache"])
    tcache = bridge.cache_from_jax(job["cache"], "cpu")
    jstep = jax.jit(lambda p, c, t, q: jserve(p, c, t, q, cfg=cfg,
                                              rt=JM.Runtime()))
    jlog, tlog = [], []
    for i in range(job["serve_tokens"].shape[1]):
        tok, pos = job["serve_tokens"][:, i], job["serve_pos"][i]
        _, lg, cache = jstep(params, cache, jnp.asarray(tok), jnp.asarray(pos))
        jlog.append(np.asarray(lg))
        with torch.no_grad():
            _, tlg, tcache = tserve(tp, tcache, torch.from_numpy(tok),
                                    torch.from_numpy(pos), cfg=tcfg,
                                    rt=TM.Runtime())
        tlog.append(tlg.numpy())
    return {
        "jax": {"logits": np.asarray(jl), "aux": float(jaux),
                "loss": float(jmet["loss"]),
                "grad_norm": float(jmet["grad_norm"]),
                "state": jax.tree.map(
                    lambda x: {"q": np.asarray(x.q),
                               "scale": np.asarray(x.scale)}
                    if isinstance(x, JQ.QTensor) else np.asarray(x),
                    jstate, is_leaf=lambda x: isinstance(x, JQ.QTensor)),
                "serve_logits": np.stack(jlog), "cache": _np_tree(cache)},
        "port": {"logits": tl.numpy(), "aux": float(taux),
                 "loss": float(tmet["loss"]),
                 "grad_norm": float(tmet["grad_norm"]),
                 "state": bridge.train_state_to_jax(tstate, tcfg, qtensor=qt),
                 "serve_logits": np.stack(tlog),
                 "cache": bridge.cache_to_jax(tcache)},
        "moment": moment,
    }


def _spawn(tmp, jobs, while_running, deadline=420.0):
    """Run the jobs on WORLD spawned ranks; ``while_running()`` runs in this
    process meanwhile. Returns (the ranks' results, its result)."""
    import torch.multiprocessing as mp
    from tests.torch_sharded_runner import main
    (tmp / "job.pkl").write_bytes(pickle.dumps({"cases": jobs}))
    ctx = mp.start_processes(main, args=(WORLD, str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    end = time.monotonic() + deadline
    try:
        mine = while_running()
        while not ctx.join(timeout=5):
            if time.monotonic() > end:
                raise TimeoutError(f"sharded ranks still running after "
                                   f"{deadline} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    out = pickle.loads((tmp / "out.pkl").read_bytes())
    out["layout_ranks"] = [out["layout"]] + [
        pickle.loads((tmp / f"layout{r}.pkl").read_bytes())
        for r in range(1, WORLD)]
    return out, mine


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run every case while this process computes the references
    (grok-noep shares grok's inputs and references)."""
    jobs, base = [], {}
    for name in CASES:
        mesh, ep = CASES[name][2:4]
        if _key(name) not in base:
            base[_key(name)] = _job(name)
        jobs.append(dict(base[_key(name)], name=name, mesh=mesh, ep=ep,
                         flip_ep=_extra(name).get("flip_ep", False)))

    def references():
        made = {key: _references(job) for key, job in base.items()}
        return {name: made[_key(name)] for name in CASES}

    return _spawn(tmp_path_factory.mktemp("sharded"), jobs, references)


def _case(runs, name):
    out, refs = runs
    res = out[name]
    assert "error" not in res, res.get("error")
    return res, refs[name]


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol, atol=tol)


def _near(got, want):
    """Within REL of the reference's largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    bound = REL * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= bound


def _leaves(tree):
    """(path, leaf) pairs of a numpy tree of dicts and lists; an int8 moment
    ({"q", "scale"}) is one leaf."""
    if isinstance(tree, dict) and set(tree) == {"q", "scale"}:
        yield (), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            for p, v in _leaves(tree[k]):
                yield (k,) + p, v
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            for p, v in _leaves(t):
                yield (i,) + p, v
    else:
        yield (), tree


def _states_close(got, want, cmp, params_cmp=None):
    """Two train states leaf by leaf: ``cmp`` (``params_cmp`` for the
    params when given), int8 moments within one quantization step, counts
    exactly."""
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    assert gl.keys() == wl.keys()
    for path, w in wl.items():
        g = gl[path]
        if isinstance(w, dict):   # int8: one quantization step
            _close(g["scale"], w["scale"], TOL)
            deq = lambda x: np.asarray(x["q"], np.float32) * np.asarray(  # noqa: E731
                x["scale"], np.float32)
            assert (np.abs(deq(g) - deq(w))
                    <= np.asarray(w["scale"], np.float32) * (1 + TOL)
                    + 1e-30).all(), path
        elif path[-1:] in (("count",), ("step",)) or np.ndim(w) == 0:
            assert np.array_equal(np.asarray(g), np.asarray(w)), path
        elif path[0] == "params" and params_cmp is not None:
            params_cmp(g, w)
        else:
            cmp(g, w)


NAMES = sorted(CASES)


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_match_jax(runs, name):
    res, ref = _case(runs, name)
    assert res["logits"].shape == ref["jax"]["logits"].shape
    _close(res["logits"], ref["jax"]["logits"])
    assert abs(res["aux"] - ref["jax"]["aux"]) <= 1e-6
    # batch on "data", vocab on "model"
    assert res["logits_placements"] == [0, 2]


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits_match_the_unsharded_port(runs, name):
    res, ref = _case(runs, name)
    _near(res["logits"], ref["port"]["logits"])
    assert abs(res["aux"] - ref["port"]["aux"]) <= REL * max(
        abs(ref["port"]["aux"]), 1e-30) + 1e-7


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(runs, name):
    res, ref = _case(runs, name)
    metrics, state = res["train"]
    _close(metrics["loss"], ref["jax"]["loss"])
    _close(metrics["grad_norm"], ref["jax"]["grad_norm"])
    _states_close(state, ref["jax"]["state"], _close)


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_the_unsharded_port(runs, name):
    res, ref = _case(runs, name)
    metrics, state = res["train"]
    _near(metrics["loss"], ref["port"]["loss"])
    _near(metrics["grad_norm"], ref["port"]["grad_norm"])
    _states_close(state, ref["port"]["state"], _near, params_cmp=_close)


@pytest.mark.parametrize("name", NAMES)
def test_sharded_train_step_repeats_bitwise(runs, name):
    res, _ = _case(runs, name)
    (m1, s1), (m2, s2) = res["train"], res["train_repeat"]
    for k in m1:
        assert np.array_equal(m1[k], m2[k]), k
    l1, l2 = dict(_leaves(s1)), dict(_leaves(s2))
    assert l1.keys() == l2.keys()
    for path in l1:
        a, b = l1[path], l2[path]
        if isinstance(a, dict):
            assert np.array_equal(a["q"], b["q"]), path
            assert np.array_equal(a["scale"], b["scale"]), path
        else:
            assert np.array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                  np.asarray(b).reshape(-1).view(np.uint8)), path


@pytest.mark.parametrize("name", NAMES)
def test_serve_steps_match_jax(runs, name):
    res, ref = _case(runs, name)
    _close(res["serve_logits"], ref["jax"]["serve_logits"])
    for c, w in zip(res["cache"], ref["jax"]["cache"]):
        assert sorted(c) == sorted(w)
        for leaf in c:
            _close(c[leaf], w[leaf])
    assert np.array_equal(res["serve_next"],
                          ref["jax"]["serve_logits"].argmax(-1))


@pytest.mark.parametrize("name", NAMES)
def test_serve_steps_match_the_unsharded_port(runs, name):
    res, ref = _case(runs, name)
    _near(res["serve_logits"], ref["port"]["serve_logits"])
    for c, w in zip(res["cache"], ref["port"]["cache"]):
        for leaf in c:
            _near(c[leaf], w[leaf])


def test_layouts_cover_every_sharding_mode(runs):
    """FSDP ("embed" on data), TP (heads, mlp, inner, vocab), EP and
    expert_mlp, SP (kv_seq) and DP (batch) each appear in some case's
    rules."""
    out, _ = runs
    seen = {(name, ax, r) for name in NAMES for ax, r in
            out[name]["rules"].items() if r is not None}
    for ax in ("embed", "heads", "mlp", "inner", "vocab", "kv_seq", "batch"):
        assert any(a == ax for _, a, _ in seen), ax
    assert ("grok", "expert", "model") in seen
    assert ("grok-noep", "expert_mlp", "model") in seen
    assert ("grok-noep", "expert", "model") not in seen


def test_runtime_ep_sets_the_expert_layout(runs):
    """grok-noep's weights are laid out by the rules with ``expert_mlp``;
    its forward with the runtime's ``ep`` turned on redistributes them to
    whole experts on "model" and gives the unsharded logits all the
    same."""
    res, ref = _case(runs, "grok-noep")
    assert res["rules"]["expert"] is None and not res["ep"]
    _near(res["logits_ep_flipped"], ref["port"]["logits"])
    _close(res["logits_ep_flipped"], ref["jax"]["logits"])


def test_multi_axis_entry_is_pod_major_and_mesh_builders(runs):
    """On a (2, 2, 1) ("pod", "data", "model") mesh a dim on ("pod",
    "data") is cut in 4 blocks, rank (pod p, data d) holding block 2p + d,
    as JAX lays it out; ``make_local_mesh`` is (1, world) and
    ``make_production_mesh`` refuses a world of 4."""
    out, _ = runs
    x = np.arange(24).reshape(8, 3)
    for lay in out["layout_ranks"]:
        p, d = lay["coords"]
        assert np.array_equal(lay["pod_major"], x[(2 * p + d) * 2:
                                                  (2 * p + d + 1) * 2])
        assert lay["local_mesh"] == (("data", "model"), (1, WORLD))
        assert "needs 256 ranks but only 4" in lay["production"]
        assert lay["foreign_modules"] == []     # the ranks load no JAX
