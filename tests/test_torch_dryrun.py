"""The port's dry-run (``repro_torch.launch.dryrun``) and its per-rank
op-trace analysis (``repro_torch.parallel.trace_analysis``), on the CPU.

* the counters: a matrix product's FLOPs and bytes; each collective's ring
  bytes over a fake group of 4 and 16 ranks, by the link its group spans;
  the ring factors equal ``repro.parallel.hlo_analysis``'s (a module that
  imports no JAX) for n = 1 .. 512; a collective of an unknown kind raises;
* per rank: a TP- and FSDP-sharded forward on a fake (2, 2) mesh counts a
  quarter of the unsharded GEMM FLOPs, apart from the K/V projections,
  which every rank of the tensor axis computes for all kv heads (the rules
  map "kv_heads" to no axis, as JAX's do); the kernels a quarter exactly;
* the kernel wrappers' shape-only route on ``meta``: the outputs of the
  kernel route, the cost each call reports, and a CPU call unchanged;
* parity with JAX: the port's GEMM FLOPs plus the attention term of JAX's
  XLA path (4 B H Sq Sk D a layer: the full square, as its einsums compute
  it) equal ``hlo_analysis.analyze``'s ``dot_flops`` of the compiled JAX
  call exactly, for reduced internlm2 and grok, prefill ``forward`` and one
  ``serve_step``. XLA on the CPU keeps every one of these products a
  ``dot`` (decode's single query too), so nothing is added back. The Mamba
  archs are left out: JAX contracts its scan in dots that the port's scan
  kernel does without;
* the cells: ``all_cells()`` is JAX's list (built here from
  ``repro.configs``: importing ``repro.launch.dryrun`` sets ``XLA_FLAGS``
  to 512 host devices), two production cells and a reduced train cell run.

Every case that makes a fake process group destroys it on the way out
(``dryrun.fake_world``), since other files may share this worker.
"""
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS, get_config, reduced, shapes_for  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import input_specs as ispec  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import sharding as S  # noqa: E402
from repro_torch.parallel import trace_analysis as TA  # noqa: E402

pytestmark = pytest.mark.timeout(300)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rate", [(torch.float32, "f32"),
                                        (torch.bfloat16, "bf16")])
def test_matmul_flops_and_bytes(dtype, rate):
    M_, K, N, Bt = 48, 64, 80, 3
    a, b = _meta(M_, K, dtype=dtype), _meta(K, N, dtype=dtype)
    x, y = _meta(Bt, M_, K, dtype=dtype), _meta(Bt, K, N, dtype=dtype)
    e = torch.tensor([], dtype=dtype).element_size()
    with TA.OpTrace() as tr:
        c = a @ b
        d = torch.bmm(x, y)       # c still held: the peak holds both
        a.t()                     # a view: no traffic
        del c, d
    s = tr.summary()
    assert s["gemm_flops"] == 2 * M_ * K * N + 2 * Bt * M_ * K * N
    assert s["flops_by_rate"] == {rate: s["gemm_flops"]}
    assert s["memory_bytes"] == e * ((M_ * K + K * N + M_ * N)
                                     + Bt * (M_ * K + K * N + M_ * N))
    assert s["ops"] == 2 and s["kernel_flops"] == 0
    assert s["temp_bytes"] == e * (M_ * N + Bt * M_ * N)


def _waited(t):
    """A functional collective's result, waited for where it is async."""
    return t.wait() if hasattr(t, "wait") else t


def _collectives(n):
    """Each collective kind over a group of ``n`` ranks of a fake world of
    16, functional and in place: (name, call, kind, ring base bytes)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    g = dist.new_group(list(range(n)))
    t = _meta(8, 16)
    nb = 8 * 16 * 4
    return [
        ("all_gather_single", lambda: _waited(fc.all_gather_single(t, 0, g)),
         "all-gather", n * nb),
        ("reduce_scatter_tensor",
         lambda: _waited(fc.reduce_scatter_tensor(_meta(8 * n, 16), "sum",
                                                  0, g)),
         "reduce-scatter", n * nb),
        ("all_reduce", lambda: _waited(fc.all_reduce(t, "sum", g)),
         "all-reduce", nb),
        ("all_to_all_single",
         lambda: _waited(fc.all_to_all_single(_meta(8 * n, 16), None,
                                              None, g)),
         "all-to-all", n * nb),
        ("c10d.allreduce_", lambda: dist.all_reduce(t, group=g),
         "all-reduce", nb),
        ("c10d.allgather_",
         lambda: dist.all_gather([_meta(8, 16) for _ in range(n)], t,
                                 group=g),
         "all-gather", n * nb),
        ("c10d._allgather_base_",
         lambda: dist.all_gather_into_tensor(_meta(8 * n, 16), t, group=g),
         "all-gather", n * nb),
        ("c10d._reduce_scatter_base_",
         lambda: dist.reduce_scatter_tensor(t, _meta(8 * n, 16), group=g),
         "reduce-scatter", n * nb),
        ("c10d.alltoall_base_",
         lambda: dist.all_to_all_single(_meta(8 * n, 16), _meta(8 * n, 16),
                                        group=g),
         "all-to-all", n * nb),
        ("_dtensor.shard_dim_alltoall",
         lambda: torch.ops._dtensor.shard_dim_alltoall(
             _meta(8, 16 * n), 0, 1, g.group_name),
         "all-to-all", n * nb),
    ]


@pytest.mark.parametrize("n", [4, 16])
def test_collective_ring_bytes(n):
    """Wire bytes = ring factor(n) x the gathered, scattered or reduced
    bytes; a group inside one node of 8 ranks goes over NVLink, one across
    nodes over the NIC."""
    with dryrun.fake_world(16):
        for name, call, kind, base in _collectives(n):
            with TA.OpTrace(node_size=8) as tr:
                call()
            s = tr.summary()
            want = TA._RING[kind](n) * base
            assert s["collective_count"] == 1, name
            assert s["collectives"][kind] == pytest.approx(want, rel=1e-12), name
            assert s["collective_bytes"] == s["collectives"][kind], name
            link = "nvlink" if n <= 8 else "nic"
            assert s["collective_bytes_by_link"][link] == \
                s["collective_bytes"], name


def test_unknown_collective_raises():
    import torch.distributed as dist
    with dryrun.fake_world(4):
        with pytest.raises(ValueError, match="does not know"):
            with TA.OpTrace():
                dist.broadcast(_meta(4), src=0)


def test_ring_factors_equal_jax():
    from repro.parallel import hlo_analysis as H
    assert TA.COLLECTIVES == H.COLLECTIVES
    assert set(TA._RING) == set(H._RING)
    for n in range(1, 513):
        for kind in H.COLLECTIVES:
            assert TA._RING[kind](n) == H._RING[kind](n), (kind, n)


# ---------------------------------------------------------------------------
# per rank
# ---------------------------------------------------------------------------

def _kv_projection_flops(cfg, tokens):
    """The K and V projections' GEMM FLOPs of a whole forward."""
    n_attn = sum(1 for s in cfg.layer_kinds() if s.mixer == "attn")
    return n_attn * 2 * (2 * tokens * cfg.d_model * cfg.n_kv_heads
                         * cfg.d_head)


def test_sharded_forward_counts_a_quarter_per_rank():
    from torch.distributed.device_mesh import DeviceMesh
    cfg = reduced(get_config("internlm2-1.8b"), d_model=256, n_layers=2)
    shape = ShapeSpec("p", "prefill", 256, 4)
    rt = M.Runtime(remat="none")
    whole = dryrun.trace_cell(cfg, shape, rt=rt)
    with dryrun.fake_world(4):
        mesh = DeviceMesh("cuda", np.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        strat = S.ShardingStrategy.for_mesh(mesh)
        part = dryrun.trace_cell(cfg, shape, mesh=mesh, strat=strat,
                                 rt=S.runtime(cfg, mesh, strat, remat="none"))
    kv = _kv_projection_flops(cfg, shape.global_batch * shape.seq_len)
    # a quarter of everything but K/V, which is split over "data" only
    want = (whole["gemm_flops"] - kv) / 4 + kv / 2
    assert part["gemm_flops"] == pytest.approx(want, rel=0.01)
    assert part["kernel_flops"] == whole["kernel_flops"] / 4
    assert part["kernel_calls"] == whole["kernel_calls"] == \
        {"flash_attention": cfg.n_layers}
    assert part["collective_count"] > 0 and whole["collective_count"] == 0
    assert part["argument_bytes"] < whole["argument_bytes"]


# ---------------------------------------------------------------------------
# the kernel wrappers' shape-only route
# ---------------------------------------------------------------------------

def _calls(gen):
    """The flash, decode, scan and fused scan wrapper calls on tensors from
    ``gen`` (``gen(shape, dtype)``): (name, call)."""
    B, Sq, Sk, H, KV, D = 2, 48, 64, 4, 2, 32
    bf = torch.bfloat16
    q, k, v = gen((B, Sq, H, D), bf), gen((B, Sk, KV, D), bf), \
        gen((B, Sk, KV, D), bf)
    out, lse = gen((B, Sq, H, D), bf), gen((B, H, Sq), torch.float32)
    qd, kc, vc = gen((B, H, D), bf), gen((B, Sk, KV, D), bf), \
        gen((B, Sk, KV, D), bf)
    a, b = (gen((B, 8, 6, 4), torch.float32) for _ in range(2))
    h0 = gen((B, 6, 4), torch.float32)
    lens = torch.full((B,), 40, dtype=torch.int32, device=q.device)
    kw = dict(causal=True, window=24, softcap=None)
    u, Bc, Cc = gen((B, 70, 6), bf), gen((B, 70, 4), bf), gen((B, 70, 4), bf)
    dt, dy = gen((B, 70, 6), torch.float32), gen((B, 70, 6), torch.float32)
    A, st = gen((6, 4), torch.float32), gen((B, 2, 6, 4), torch.float32)
    return [
        ("flash_attention", lambda: ops.flash_attention_forward(
            q, k, v, True, 24, None, want_lse=True)),
        ("flash_attention_backward", lambda: ops.flash_attention_backward(
            q, k, v, out, lse, out, **kw)),
        ("decode_attention", lambda: ops.decode_attention(
            qd, kc, vc, lens, offset=16, return_lse=True)),
        ("selective_scan", lambda: ops.selective_scan_forward(a, b, h0)),
        ("selective_scan_backward", lambda: ops.selective_scan_backward(
            a, b, h0, a)),
        ("selective_scan_fused", lambda: ops.selective_scan_fused_forward(
            u, dt, A, Bc, Cc, want_states=True)),
        ("selective_scan_fused_backward",
         lambda: ops.selective_scan_fused_backward(u, dt, A, Bc, Cc, st, dy)),
    ]


def _shapes(out):
    return [None if t is None else (tuple(t.shape), t.dtype, t.device.type)
            for t in (out if isinstance(out, tuple) else (out,))]


def test_meta_route_matches_the_kernel_outputs_and_reports_the_work(monkeypatch):
    seen = []
    monkeypatch.setattr(ops, "COST_HOOK", lambda *a: seen.append(a))
    g = torch.Generator().manual_seed(0)
    cpu = _calls(lambda s, dt: torch.randn(s, generator=g).to(dt))
    assert seen == []        # a CPU call reports nothing
    meta = _calls(lambda s, dt: torch.empty(s, dtype=dt, device="meta"))
    ops.reset_launches()
    for (name, c), (_, m) in zip(cpu, meta):
        got, want = m(), c()
        assert [x and x[:2] for x in _shapes(got)] == \
            [x and x[:2] for x in _shapes(want)], name
        assert all(x is None or x[2] == "meta" for x in _shapes(got))
    assert ops.LAUNCHES == dict.fromkeys(ops.LAUNCHES, 0)
    pairs = ops.kept_pairs(48, 64, True, 24)
    assert pairs == sum(min(i + 1, 64) - max(0, i - 23) for i in range(48))
    assert [s[:3] for s in seen] == [
        ("flash_attention", 4 * 2 * 4 * 32 * pairs, "bf16"),
        ("flash_attention_backward", 10 * 2 * 4 * 32 * pairs, "bf16"),
        ("decode_attention", 4 * 2 * 4 * 64 * 32, "f32"),
        ("selective_scan", 0, "f32"),
        ("selective_scan_backward", 0, "f32"),
        ("selective_scan_fused", 7 * 2 * 70 * 6 * 4, "f32"),
        ("selective_scan_fused_backward", 25 * 2 * 70 * 6 * 4, "f32")]
    # bytes: q, k, v read, o and lse written, never the scores
    qb, kb, ob, lb = 2 * 48 * 4 * 32 * 2, 2 * 64 * 2 * 32 * 2, \
        2 * 48 * 4 * 32 * 2, 2 * 4 * 48 * 4
    assert seen[0][3:] == (qb + 2 * kb, ob + lb)
    assert seen[1][3:] == (2 * qb + 2 * kb + ob + lb, qb + 2 * kb)
    assert seen[3][3:] == (2 * 2 * 8 * 24 * 4 + 2 * 24 * 4, 2 * 8 * 24 * 4)
    # the fused scan: its operands read (u, Bc, Cc in bf16) and y and the
    # chunk states written; backward, the states and dy read too and du,
    # ddt, dA, dB and dC written in f32 (the kernel's; du, dB and dC are
    # cast to bf16 after it), never a [B,S,DI,DS] tensor
    ub, rb, fb = 2 * 70 * 6 * 2, 2 * 70 * 4 * 2, 2 * 70 * 6 * 4
    sb, ab = 2 * 2 * 6 * 4 * 4, 6 * 4 * 4
    assert seen[5][3:] == (ub + fb + ab + 2 * rb, fb + sb)
    assert seen[6][3:] == (ub + 2 * fb + ab + 2 * rb + sb,
                           2 * fb + ab + 4 * rb)


def test_cpu_calls_are_unchanged(monkeypatch):
    """The CPU route gives the plain version's bits, and never the hook."""
    monkeypatch.setattr(ops, "COST_HOOK", lambda *a: pytest.fail("hook"))
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 16, 2, 32), generator=g) for _ in range(3))
    assert torch.equal(ops.flash_attention(q, k, v, window=8),
                       ref.flash_attention_ref(q, k, v, causal=True, window=8))
    a, b = (torch.rand((1, 5, 3, 4), generator=g) for _ in range(2))
    assert torch.equal(ops.selective_scan(a, b), ref.selective_scan_ref(a, b))


def test_meta_autograd_reaches_the_backward_wrappers():
    """``FlashAttention`` and ``SelectiveScan`` on meta: a traced backward
    reaches both backward wrappers, once a call."""
    q, k, v = (_meta(1, 32, 2, 64).requires_grad_() for _ in range(3))
    a, b = (_meta(1, 8, 4, 2).requires_grad_() for _ in range(2))
    with TA.OpTrace() as tr:
        o = ops.flash_attention(q, k, v)
        h = ops.selective_scan(a, b)
        torch.autograd.grad((o.sum() + h.sum()), (q, k, v, a, b))
    assert tr.summary()["kernel_calls"] == {
        "flash_attention": 1, "flash_attention_backward": 1,
        "selective_scan": 1, "selective_scan_backward": 1}


# ---------------------------------------------------------------------------
# parity with JAX's HLO analysis
# ---------------------------------------------------------------------------

def _jax_dot_flops(name, kind, B, S):
    jax = pytest.importorskip("jax")
    import functools
    import jax.numpy as jnp
    from repro.configs import get_config as jget, reduced as jred
    from repro.models import model as JM
    from repro.parallel import hlo_analysis
    from repro.serving.decode import serve_step
    cfg = jred(jget(name), n_layers=2)
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    rt = JM.Runtime(attn_impl="xla", remat="none")
    if kind == "prefill":
        fn = jax.jit(lambda p, b: JM.forward(p, b, cfg, rt)[0])
        lowered = fn.lower(params, {"tokens": jnp.zeros((B, S), jnp.int32)})
    else:
        pos = jnp.zeros((B,), jnp.int32)
        fn = jax.jit(functools.partial(serve_step, cfg=cfg, rt=rt))
        lowered = fn.lower(params, JM.init_cache(cfg, B, S), pos, pos)
    return hlo_analysis.analyze(lowered.compile().as_text())["dot_flops"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", ["internlm2-1.8b", "grok-1-314b"])
def test_gemm_flops_plus_attention_equal_jax_dot_flops(name, kind):
    B, S = 2, 64
    cfg = reduced(get_config(name), n_layers=2)
    tr = dryrun.trace_cell(cfg, ShapeSpec("x", kind, S, B),
                           rt=M.Runtime(remat="none"))
    Sq = S if kind == "prefill" else 1
    n_attn = sum(1 for s in cfg.layer_kinds() if s.mixer == "attn")
    attention = n_attn * 4 * B * cfg.eff_heads * Sq * S * cfg.d_head
    assert tr["gemm_flops"] + attention == _jax_dot_flops(name, kind, B, S)


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def test_all_cells_equal_jax_cells():
    from repro.configs import ARCHS as JARCHS, shapes_for as jshapes_for
    jax_cells = [(name, shp.name, multi) for name, cfg in JARCHS.items()
                 for shp in jshapes_for(cfg) for multi in (False, True)]
    assert list(dryrun.all_cells()) == jax_cells
    assert len(jax_cells) == 64
    assert [(name, shp.name) for name, cfg in ARCHS.items()
            for shp in shapes_for(cfg)] == [c[:2] for c in jax_cells[::2]]


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_production_cell_runs(shape, tmp_path):
    dump = tmp_path / "ops.jsonl"
    res = dryrun.run_cell("internlm2-1.8b", shape, False,
                          out_path=str(tmp_path / "cell.json"),
                          dump_ops=str(dump))
    assert res["status"] == "ok", res.get("traceback")
    assert json.loads((tmp_path / "cell.json").read_text()) == res
    assert res["n_chips"] == 256 and res["memory"]["fits_80GB"]
    kernel = "flash_attention" if shape == "prefill_32k" else "decode_attention"
    assert res["trace"]["kernel_calls"] == {kernel: 24}
    r = res["roofline"]
    assert r["step_time_s_lower_bound"] == max(
        r["compute_s"], r["memory_s"], r["collective_s"]) > 0
    lines = [json.loads(x) for x in dump.read_text().splitlines()]
    assert sum(x.get("flops", 0) for x in lines
               if not x["op"].startswith("kernel.")) == \
        res["trace"]["gemm_flops"]


def test_reduced_train_cell_on_a_2x2_mesh():
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.launch.presets import Preset
    from repro_torch.training.optimizer import OptHParams
    cfg = reduced(get_config("internlm2-1.8b"), d_model=128, n_layers=2)
    shape = ShapeSpec("t", "train", 64, 4)
    with dryrun.fake_world(4):
        mesh = DeviceMesh("cuda", np.arange(4).reshape(2, 2),
                          mesh_dim_names=("data", "model"))
        strat = S.ShardingStrategy.for_mesh(mesh)
        preset = Preset(remat="full")
        tr = dryrun.trace_cell(cfg, shape, mesh=mesh, strat=strat,
                               preset=preset, hp=OptHParams(),
                               rt=S.runtime(cfg, mesh, strat, remat="full"),
                               dump=io.StringIO())
    accum, _ = ispec.train_batch_layout(shape, mesh, strat, preset)
    # remat "full": each forward kernel twice (forward and recompute)
    assert tr["kernel_calls"] == {
        "flash_attention": 2 * accum * cfg.n_layers,
        "flash_attention_backward": accum * cfg.n_layers}
    assert tr["collectives"]["reduce-scatter"] + \
        tr["collectives"]["all-reduce"] > 0
    assert tr["peak_bytes"] > tr["argument_bytes"] > 0
    roof = dryrun.roofline(tr, tr["model_flops"], 4)
    assert roof["dominant"] in ("compute", "memory", "collective")
