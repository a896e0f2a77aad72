"""The port's multi-device layout against the JAX package's, on the CPU.

One process, no ranks: ``make_rules``, the param / state / cache specs and
``train_batch_layout`` of ``repro_torch.parallel.sharding`` and
``repro_torch.launch.input_specs`` equal ``repro.parallel.sharding``'s and
``repro.launch.input_specs``' for every arch over the production meshes
(16, 16) and (2, 16, 16), and (2, 2) and (1, 4), under each strategy the
dry-run uses, with f32, bf16 and int8 moments. Meshes are stand-ins: both
packages read only a mesh's axis names and sizes. The JAX tree stacks a
block position's layers with a leading "layers" axis; ``bridge.specs_to_jax``
maps the port's per-layer specs onto it. The input specs' meta shapes and
dtypes equal JAX's ``eval_shape`` results.

Also the decode kernel's split: on the plain version, a cache cut into 2 or
4 key ranges, each run with its key offset and its row log-sum-exp, then
``ops.merge_attention_parts``, equals the uncut call.
"""
import dataclasses
import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as jcfgs  # noqa: E402
from repro.launch import input_specs as JI  # noqa: E402
from repro.launch.presets import preset_for as jpreset_for  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro.training import quant as jquant  # noqa: E402
from repro.training.optimizer import OptHParams as JOpt  # noqa: E402
from repro.training.step import init_train_state as jinit_state  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch import configs as tcfgs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import input_specs as TI  # noqa: E402
from repro_torch.launch.presets import preset_for as tpreset_for  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402
from repro_torch.training.optimizer import OptHParams as TOpt  # noqa: E402

ARCHS = sorted(jcfgs.ARCHS)
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16)),
          "2x2": (("data", "model"), (2, 2)),
          "1x4": (("data", "model"), (1, 4))}
STRATEGIES = ("default", "no_fsdp", "no_ep", "dp_only", "fsdp_over_pod")
MOMENTS = ("float32", "bfloat16", "int8")


def _meshes(name):
    """(JAX stand-in mesh, port MeshShape) of one shape."""
    names, shape = MESHES[name]
    return (types.SimpleNamespace(axis_names=names,
                                  devices=np.empty(shape, dtype=object)),
            TS.MeshShape(names, shape))


def _strategies(kind, jmesh, tmesh, global_batch=256):
    """(JAX strategy, port strategy): ``for_mesh``'s variants, or the
    dry-run's dp-only layout (``repro/launch/dryrun.py``: no TP, FSDP over
    every axis, the batch over the largest suffix of axes that divides
    it)."""
    if kind == "dp_only":
        flat = tuple(tmesh.axis_names)
        sizes = dict(zip(tmesh.axis_names, tmesh.shape))
        bt = flat
        while bt and global_batch % int(np.prod([sizes[a] for a in bt])):
            bt = bt[1:]
        kw = dict(fsdp=True, tp=False, ep=False, seq_shard_decode=False,
                  fsdp_axes=flat, dp_axes=bt or ("data",))
        return JS.ShardingStrategy(**kw), TS.ShardingStrategy(**kw)
    kw = {"default": {}, "no_fsdp": dict(fsdp=False), "no_ep": dict(ep=False),
          "fsdp_over_pod": dict(fsdp_over_pod=True)}[kind]
    return (JS.ShardingStrategy.for_mesh(jmesh, **kw),
            TS.ShardingStrategy.for_mesh(tmesh, **kw))


def _configs(arch, tmesh, tstrat):
    """(JAX config, port config), padded for the tensor axis as the dry-run
    does when TP is on."""
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    if tstrat.tp:
        n = dict(zip(tmesh.axis_names, tmesh.shape))[tstrat.tp_axis]
        jc, tc = jc.padded_for_tp(n), tc.padded_for_tp(n)
    return jc, tc


def _jax_specs(tree):
    """JAX's PartitionSpecs (and QTensors of them) as tuples."""
    def one(x):
        if isinstance(x, jquant.QTensor):
            return ("Q", tuple(x.q), tuple(x.scale))
        return tuple(x)
    return jax.tree.map(one, tree, is_leaf=lambda x: isinstance(
        x, (jax.sharding.PartitionSpec, jquant.QTensor)))


def _qt(q, s):
    return ("Q", q, s)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_rules_and_specs_equal_jax(arch, mesh, strategy):
    jmesh, tmesh = _meshes(mesh)
    jstrat, tstrat = _strategies(strategy, jmesh, tmesh)
    assert dataclasses.asdict(jstrat) == dataclasses.asdict(tstrat)
    jc, tc = _configs(arch, tmesh, tstrat)
    jrules, trules = JS.make_rules(jc, jmesh, jstrat), TS.make_rules(tc, tmesh, tstrat)
    assert jrules == trules
    assert _jax_specs(JS.param_pspecs(jc, jrules)) == bridge.specs_to_jax(
        TS.param_pspecs(tc, trules), tc)
    for moment in MOMENTS:
        js = _jax_specs(JS.state_pspecs(jc, jrules, moment))
        ts = TS.state_pspecs(tc, trules, moment)
        assert js["params"] == bridge.specs_to_jax(ts["params"], tc)
        for k in ("m", "v"):
            assert js["opt"][k] == bridge.specs_to_jax(ts["opt"][k], tc,
                                                       qtensor=_qt)
        assert js["opt"]["count"] == ts["opt"]["count"] == ()
        assert js["step"] == ts["step"] == ()
    for shardable in (True, False):
        assert _jax_specs(JS.cache_pspecs(jc, jrules, shardable)) == \
            TS.cache_pspecs(tc, trules, shardable)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_runtime_ep_follows_the_rules(arch, mesh, strategy):
    """``sharding.runtime`` turns EP on exactly where ``make_rules`` puts the
    experts on the tensor axis (one rule: grok-1's 8 experts on a 16-way
    axis get ``expert_mlp`` and no EP), with the strategy's axes."""
    jmesh, tmesh = _meshes(mesh)
    _, tstrat = _strategies(strategy, jmesh, tmesh)
    _, tc = _configs(arch, tmesh, tstrat)
    rules = TS.make_rules(tc, tmesh, tstrat)
    rt = TS.runtime(tc, tmesh, tstrat)
    assert rt.ep == (rules["expert"] is not None)
    assert rt.shard_activations and rt.dp_axes == tstrat.dp_axes
    assert rt.tp_axis == (tstrat.tp_axis if tstrat.tp else "")
    ctx = rt.shard_ctx()
    assert ctx["ep"] == rt.ep and ctx["tp"] == (rt.tp_axis or None)


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_specs_equal_jax(arch):
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    tl = TM.logical_specs(tc)
    shapes = {n: p.shape for n, p in
              TM.DecoderParams(tc, torch.float32, "meta").named_parameters()}
    assert set(tl) == set(shapes)
    assert all(len(tl[n]) == len(shapes[n]) for n in tl)
    jl = jax.tree.map(tuple, JM.logical_specs(jc),
                      is_leaf=lambda x: isinstance(x, tuple))
    assert jl == bridge.specs_to_jax(tl, tc, lead="layers")
    assert JM.cache_logical_specs(jc) == TM.cache_logical_specs(tc)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_train_batch_layout_equals_jax(arch, mesh):
    jmesh, tmesh = _meshes(mesh)
    for shape in jcfgs.ALL_SHAPES:
        for strategy in STRATEGIES:
            jstrat, tstrat = _strategies(
                strategy, jmesh, tmesh, jcfgs.ALL_SHAPES[shape].global_batch)
            for micro in (None, 1, 3, 8):
                jp = dataclasses.replace(jpreset_for(arch), microbatch=micro)
                tp = dataclasses.replace(tpreset_for(arch), microbatch=micro)
                assert JI.train_batch_layout(
                    jcfgs.ALL_SHAPES[shape], jmesh, jstrat, jp) == \
                    TI.train_batch_layout(tcfgs.ALL_SHAPES[shape], tmesh,
                                          tstrat, tp)
            assert JI.dp_total(jmesh, jstrat) == TI.dp_total(tmesh, tstrat)


def test_shape_sets_are_a_copy():
    assert {k: dataclasses.asdict(v) for k, v in jcfgs.ALL_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in tcfgs.ALL_SHAPES.items()}
    for arch in ARCHS:
        assert [s.name for s in jcfgs.shapes_for(jcfgs.get_config(arch))] == \
            [s.name for s in tcfgs.shapes_for(tcfgs.get_config(arch))]


def _jshapes(tree):
    """JAX ShapeDtypeStructs (QTensors as {"q", "scale"}) -> (shape, dtype
    name) leaves."""
    def one(x):
        if isinstance(x, jquant.QTensor):
            return {"q": one(x.q), "scale": one(x.scale)}
        return (tuple(x.shape), str(x.dtype))
    return jax.tree.map(one, tree, is_leaf=lambda x: isinstance(
        x, (jax.ShapeDtypeStruct, jquant.QTensor)))


def _tshape(t):
    return (tuple(t.shape), str(t.dtype).removeprefix("torch."))


@pytest.mark.parametrize("arch", ARCHS)
def test_input_spec_shapes_equal_jax_eval_shape(arch):
    """Meta shapes and dtypes of the train state and batch, the prefill
    params and batch, and the decode cache and tokens, against JAX's
    ``eval_shape`` (its train_specs / prefill_specs / decode_specs compute
    the same ``eval_shape``s; nothing is allocated on either side)."""
    jc, tc = jcfgs.get_config(arch), tcfgs.get_config(arch)
    jmesh, tmesh = _meshes("16x16")
    jstrat, tstrat = _strategies("default", jmesh, tmesh)
    moment = tpreset_for(arch).moment_dtype
    jst = _jshapes(jax.eval_shape(functools.partial(
        jinit_state, cfg=jc, hp=JOpt(moment_dtype=moment)),
        jax.random.PRNGKey(0)))
    tshape = tcfgs.TRAIN_4K
    tst, tb, tss, tbs = TI.train_specs(tc, tshape, tmesh, tstrat,
                                       tpreset_for(arch),
                                       TOpt(moment_dtype=moment))
    assert jst["params"] == bridge.shapes_to_jax(tst["params"], tc)
    for k in ("m", "v"):
        assert jst["opt"][k] == bridge.shapes_to_jax(tst["opt"][k], tc)
    assert jst["opt"]["count"] == _tshape(tst["opt"]["count"])
    assert jst["step"] == _tshape(tst["step"])
    accum, mb = JI.train_batch_layout(jcfgs.TRAIN_4K, jmesh, jstrat,
                                      jpreset_for(arch))
    S = tshape.seq_len
    want = {"tokens": ((accum, mb, S), "int32"),
            "labels": ((accum, mb, S), "int32")}
    if tc.enc_dec:
        want["frames"] = ((accum, mb, S, tc.d_model), "bfloat16")
    assert {k: _tshape(v) for k, v in tb.items()} == want
    assert tbs["tokens"] == (None, "data", None)
    assert TS.bytes_of(tst) == sum(
        int(np.prod(s)) * np.dtype(jax.numpy.dtype(d)).itemsize
        for s, d in jax.tree.leaves(jst, is_leaf=lambda x: isinstance(x, tuple)
                                    and isinstance(x[1], str)))

    jp = _jshapes(jax.eval_shape(lambda: JM.init_params(
        jax.random.PRNGKey(0), jc, jax.numpy.bfloat16)))
    tp, pb, _, pbs = TI.prefill_specs(tc, tcfgs.PREFILL_32K, tmesh, tstrat)
    assert jp == bridge.shapes_to_jax(tp, tc)
    assert _tshape(pb["tokens"]) == ((32, 32_768), "int32")
    assert pbs["tokens"] == ("data", None)

    for shape in tcfgs.shapes_for(tc):
        if shape.kind != "decode":
            continue
        jcache = _jshapes(jax.eval_shape(lambda: JM.init_cache(
            jc, shape.global_batch, shape.seq_len, jax.numpy.bfloat16,
            cross_len=4096)))
        _, tcache, toks, _, cspec, tspec = TI.decode_specs(tc, shape, tmesh,
                                                           tstrat)
        assert jcache == [{k: _tshape(v) for k, v in c.items()}
                          for c in tcache]
        assert _tshape(toks["pos"]) == ((shape.global_batch,), "int32")
        shardable = shape.global_batch % 16 == 0
        assert tspec["tokens"] == (("data",) if shardable else (None,))
        assert cspec == _jax_specs(JS.cache_pspecs(
            jc, JS.make_rules(jc, jmesh, jstrat), shardable))


def test_placements_of_a_multi_axis_entry_are_pod_major():
    """("pod", "data") on one dim shards it over both mesh axes, pod
    outermost, as JAX does; another order is refused."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TS.placements((("pod", "data"), "model"), mesh) == \
        [Shard(0), Shard(0), Shard(1)]
    assert TS.placements((None, None), mesh) == [Replicate()] * 3
    with pytest.raises(ValueError):
        TS.placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError):
        TS.placements(("data", "data"), mesh)


# ---------------------------------------------------------------------------
# the decode kernel's key ranges, on its plain version
# ---------------------------------------------------------------------------

SPLIT_CASES = {
    # name: (B, S, H, KV, D, lengths, window, softcap)
    "dense": (3, 64, 4, 2, 32, [5, 64, 33], None, None),
    "window": (3, 64, 4, 2, 32, [5, 64, 40], 8, None),
    "softcap": (2, 64, 8, 2, 16, [17, 60], None, 30.0),
    "beyond_cache": (2, 32, 2, 1, 16, [40, 100], 8, None),
    # slot 1's window [70 - 8, 70) lies past the cache: no key is valid
    "no_valid_key": (2, 64, 4, 4, 16, [20, 0], None, None),
}


@pytest.mark.parametrize("parts", (2, 4))
@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_decode_split_over_key_ranges_equals_the_whole(case, parts):
    B, S, H, KV, D, lengths, window, softcap = SPLIT_CASES[case]
    g = torch.Generator().manual_seed(7)
    q = torch.randn(B, H, D, generator=g)
    k = torch.randn(B, S, KV, D, generator=g)
    v = torch.randn(B, S, KV, D, generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32)
    kw = dict(window=window, softcap=softcap)
    whole, whole_lse = ref.decode_attention_ref(q, k, v, lens, return_lse=True,
                                                **kw)
    assert torch.equal(whole, ref.decode_attention_ref(q, k, v, lens, **kw))
    n = S // parts
    outs = [ops.decode_attention(q, k[:, r * n:(r + 1) * n].contiguous(),
                                 v[:, r * n:(r + 1) * n].contiguous(), lens,
                                 offset=r * n, return_lse=True, **kw)
            for r in range(parts)]
    merged = ops.merge_attention_parts(torch.stack([o for o, _ in outs]),
                                       torch.stack([s for _, s in outs]))
    torch.testing.assert_close(merged, whole, rtol=1e-6, atol=1e-6)
    # the row log-sum-exp of the whole is the log-sum-exp of the ranges'
    lse = torch.logsumexp(torch.stack([s for _, s in outs]), dim=0)
    torch.testing.assert_close(lse, whole_lse, rtol=1e-6, atol=1e-6)


def test_decode_with_no_valid_key_is_the_uniform_mean_when_split():
    g = torch.Generator().manual_seed(3)
    q = torch.randn(1, 2, 16, generator=g)
    k = torch.randn(1, 32, 1, 16, generator=g)
    v = torch.randn(1, 32, 1, 16, generator=g)
    lens = torch.zeros(1, dtype=torch.int32)
    outs = [ops.decode_attention(q, k[:, r * 8:(r + 1) * 8].contiguous(),
                                 v[:, r * 8:(r + 1) * 8].contiguous(), lens,
                                 offset=r * 8, return_lse=True)
            for r in range(4)]
    neg = torch.tensor(ref.NEG_INF, dtype=torch.float32)
    assert all(torch.equal(s, torch.full_like(s, neg)) for _, s in outs)
    merged = ops.merge_attention_parts(torch.stack([o for o, _ in outs]),
                                       torch.stack([s for _, s in outs]))
    torch.testing.assert_close(merged, v[0].mean(0).expand(2, 16)[None],
                               rtol=1e-6, atol=1e-6)


def test_merge_of_one_part_is_exact():
    g = torch.Generator().manual_seed(5)
    o = torch.randn(1, 3, 4, 8, generator=g)
    lse = torch.randn(1, 3, 4, generator=g)
    assert torch.equal(ops.merge_attention_parts(o, lse), o[0])
    assert torch.equal(ops.merge_attention_parts(
        o, torch.full_like(lse, ref.NEG_INF)), o[0])
