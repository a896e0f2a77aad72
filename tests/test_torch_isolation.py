"""What the port promises about itself, checked on the CPU:

* it imports neither JAX nor anything of the ``repro`` package, and
  importing every module (the dry-run's too), ``chip_smoke.py`` and the
  examples ``examples/torch_*.py`` starts no process group;
* its entry points run on ``cuda`` and raise without a card unless the
  caller asks for ``device="cpu"``;
* the parts of the LOG.io core that raised until the engine slice (the
  sqlite, sharded and segment log stores, ABS, replay) and until the
  process-mode slice (process mode, replay and scaling in process mode)
  build and run, and a spawned engine worker loads neither torch nor
  anything of ``repro``; the optimizer-state variants (bf16/int8 moments,
  bf16 accumulation, gradient compression) build;
* the kernel wrappers pick the plain version by the tensors' device alone:
  a tensor on the card gets the kernel or an error, never the plain version;
  a meta tensor gets the dry-run's shape-only route, any other an error.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve as serve_driver  # noqa: E402
from repro_torch.launch import train as train_driver  # noqa: E402
from repro_torch.models import model as M  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, importlib.util, json, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    names.append(info.name)
    importlib.import_module(info.name)
for i, path in enumerate(sys.argv[1:]):
    spec = importlib.util.spec_from_file_location(f"probe{i}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] == "repro" or m.split(".")[0].startswith("jax"))
import torch.distributed as dist
print(json.dumps({"modules": names, "bad": bad,
                  "process_group": dist.is_available() and dist.is_initialized()}))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    examples = [str(ROOT / "examples" / f"torch_{name}.py")
                for name in ("quickstart", "elastic_scaling", "train_e2e",
                             "serve_batched")]
    out = subprocess.run([sys.executable, "-c", _PROBE,
                          str(ROOT / "chip_smoke.py"), *examples],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["process_group"] is False   # the dry-run makes its own
    for mod in ("repro_torch.bridge", "repro_torch.kernels.ops",
                "repro_torch.kernels.build", "repro_torch.models.model",
                "repro_torch.serving.decode", "repro_torch.launch.serve",
                "repro_torch.configs.base", "repro_torch.core.engine",
                "repro_torch.core.operator", "repro_torch.core.recovery",
                "repro_torch.core.logstore.memory",
                "repro_torch.core.logstore.sqlite",
                "repro_torch.core.logstore.segment",
                "repro_torch.core.logstore.batched",
                "repro_torch.core.logstore.sharded",
                "repro_torch.core.logstore.epoch", "repro_torch.core.abs",
                "repro_torch.core.api", "repro_torch.core.controller",
                "repro_torch.core.lineagequery", "repro_torch.core.replay",
                "repro_torch.core.scaling", "repro_torch.core.procmode",
                "repro_torch.core.cluster", "repro_torch.core.channels",
                "repro_torch.core.transport.local",
                "repro_torch.core.transport.routed",
                "repro_torch.core.transport.socketmode",
                "repro_torch.core.transport.shmring",
                "repro_torch.core.transport.wire", "repro_torch.data.pipeline",
                "repro_torch.training.step", "repro_torch.training.optimizer",
                "repro_torch.training.loss", "repro_torch.checkpoint.store",
                "repro_torch.launch.train", "repro_torch.launch.presets",
                "repro_torch.parallel.sharding", "repro_torch.parallel.dtensor",
                "repro_torch.launch.mesh",
                "repro_torch.launch.input_specs",
                "repro_torch.configs.shapes", "repro_torch.launch.dryrun",
                "repro_torch.parallel.trace_analysis"):
        assert mod in res["modules"]


def test_mesh_builders_run_on_the_card_by_default():
    """The mesh builders ask for "cuda" unless the caller names the CPU, and
    the production mesh refuses a world smaller than its shape."""
    import inspect
    from repro_torch.launch import make_local_mesh, make_production_mesh
    for fn in (make_local_mesh, make_production_mesh):
        assert inspect.signature(fn).parameters["device_type"].default == \
            "cuda"
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True, device_type="cpu")


def test_engine_import_and_chip_engine_load_no_torch():
    """``import repro_torch.core`` and ``chip_engine.py`` (the main script
    of chip_smoke's spawn runs) load neither torch nor anything of
    ``repro``: a spawned worker or node agent starts from them alone."""
    probe = ("import json, sys; import repro_torch.core, "
             "repro_torch.core.procmode, repro_torch.core.cluster, chip_engine; "
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] "
             "in ('torch', 'repro', 'jax', 'jaxlib'))))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_chip_smoke_fails_without_the_repository(tmp_path):
    """Alone in a directory, chip_smoke.py cannot import the port: it must
    exit non-zero and print no result."""
    (tmp_path / "chip_smoke.py").write_bytes((ROOT / "chip_smoke.py").read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny(name="internlm2-1.8b"):
    return reduced(get_config(name), d_model=64, n_layers=1)


def test_entry_points_raise_without_a_card(no_card):
    cfg = _tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_params(torch.Generator(), cfg, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.init_cache(cfg, 2, 8, torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_driver.main(["--requests", "1", "--tokens", "1"])
    p = M.init_params(torch.Generator(), cfg, torch.float32, "cpu")
    np_params = bridge.params_to_jax(p, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.params_from_jax(np_params, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bridge.cache_from_jax(bridge.cache_to_jax(M.init_cache(
            cfg, 1, 4, torch.float32, "cpu")))
    # the same calls run when the CPU is asked for
    assert repro_torch.resolve_device("cpu").type == "cpu"
    assert bridge.params_from_jax(np_params, cfg, "cpu").embed.device.type == "cpu"
    done = serve_driver.main(["--requests", "1", "--tokens", "2",
                              "--d-model", "64", "--device", "cpu"])
    assert len(done[0]) == 2


def test_training_raises_without_a_card(no_card, tmp_path):
    from repro_torch.training import OptHParams, init_train_state
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_driver.run_training(steps=1, ckpt_dir=str(tmp_path / "a"),
                                  verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_driver.main(["--steps", "1", "--ckpt-dir", str(tmp_path / "b")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_train_state(torch.Generator(), _tiny(), OptHParams())
    out = train_driver.main(["--steps", "2", "--ckpt-every", "1", "--seq-len",
                             "16", "--d-model", "32", "--n-layers", "1",
                             "--ckpt-dir", str(tmp_path / "c"),
                             "--device", "cpu"])
    assert out["steps"] == 2 and len(out["losses"]) == 2


def test_training_on_the_card_needs_a_pinned_cublas(monkeypatch):
    """Deterministic training on the card refuses to start unless cuBLAS's
    workspace is pinned (CUBLAS_WORKSPACE_CONFIG)."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        train_driver.deterministic(torch.device("cuda"))
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":0:0")
    with pytest.raises(RuntimeError, match="CUBLAS_WORKSPACE_CONFIG"):
        train_driver.deterministic(torch.device("cuda"))
    train_driver.deterministic(torch.device("cpu"))   # nothing to pin


def _linear_pipeline():
    from repro_torch.core import (CountWindowOperator, GeneratorSource,
                                  Pipeline, ReadSource, TerminalSink)
    p = Pipeline()
    p.add(lambda: GeneratorSource("src", ReadSource([{"v": 1}])))
    p.add(lambda: CountWindowOperator("win", 1, agg=len))
    p.add(lambda: TerminalSink("sink", target=1))
    p.connect("src", "out", "win", "in")
    p.connect("win", "out", "sink", "in")
    return p


def _process_mode(what):
    """Run one process-mode path of the engine on a small pipeline."""
    from repro_torch.core import Engine, LineageScope
    from repro_torch.core.scaling import Controller
    from tests.torch_core_helpers import mk_replica, replica_pipeline
    if what == "process mode":
        eng = Engine(_linear_pipeline(), mode="process", transport="routed")
        eng.start()
        assert eng.wait(60)
        eng.stop()
        assert eng.external.committed() == [1]
    elif what == "replay in process mode":
        eng = Engine(_linear_pipeline(), mode="step",
                     lineage_scopes=[LineageScope(("src", "out"),
                                                  ("win", "out"))])
        assert eng.run_to_completion()
        rep = eng.replay([("win", "out", 0)], mode="process", timeout=60)
        assert rep.ok and rep.executed_ops == frozenset({"win"})
    else:
        import repro_torch.core as TC
        n = 40
        eng = Engine(replica_pipeline(TC, n, rate=0.005)(), mode="process")
        ctrl = Controller(eng, "disp", "mrg",
                          replica_factory=functools.partial(mk_replica, TC))
        eng.start()
        if what == "scale-up in process mode":
            ctrl.scale_up("r2")
            assert eng.group_state["r2"] == "running"
        else:
            ctrl.scale_down("r1")
            assert eng.group_state["r1"] == "removed"
        assert eng.wait(60)
        eng.stop()
        assert sorted(b["v"] for b in eng.external.committed()) == \
            [2 * i for i in range(n)]


# The paths that raised NotImplementedError until the process-mode slice
# (the test keeps its name): each runs on the CPU now.
TRIMMED = ["process mode", "replay in process mode",
           "scale-down in process mode", "scale-up in process mode"]


@pytest.mark.parametrize("what", TRIMMED)
def test_trimmed_paths_raise(what):
    _process_mode(what)


def test_no_path_refuses_for_a_later_slice():
    """No module of the port raises ``NotImplementedError`` for a slice
    still to come: the process-mode paths were the last such refusals."""
    src = ROOT / "src" / "repro_torch"
    hits = [f"{p.relative_to(ROOT)}:{i}"
            for p in sorted(src.rglob("*.py"))
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if "process-mode" in line and ("slice" in line or "later" in line)
            or "_later(" in line]
    assert hits == []
    from repro_torch.core import engine
    assert not hasattr(engine, "_later")


def test_spawned_engine_worker_loads_no_torch_and_nothing_of_repro():
    """A ``ctx="spawn"`` worker starts from the bootstrap alone: its
    ``sys.modules`` holds the port's engine and neither ``torch`` nor
    anything of ``repro``, though the test process has both loaded."""
    import repro.core  # noqa: F401
    from repro_torch.core import (Engine, GeneratorSource, MapOperator,
                                  Pipeline, ReadSource, TerminalSink)
    from tests.torch_core_helpers import modules_probe
    assert "torch" in sys.modules and "repro.core" in sys.modules
    p = Pipeline()
    p.add(functools.partial(GeneratorSource, "src",
                            ReadSource([{"v": i} for i in range(4)])))
    p.add(functools.partial(MapOperator, "probe", fn=modules_probe))
    p.add(functools.partial(TerminalSink, "sink", target=4))
    p.connect("src", "out", "probe", "in")
    p.connect("probe", "out", "sink", "in")
    eng = Engine(p, mode="process", ctx="spawn", transport="routed")
    eng.start()
    assert eng.wait(90)
    eng.stop()
    got = eng.external.committed()
    assert [b["v"] for b in got] == [0, 1, 2, 3]
    assert all(b["pid"] != os.getpid() for b in got)
    assert not any(b["torch"] for b in got), got
    assert not any(b["repro"] for b in got), got


def _runs_on(store):
    from repro_torch.core import Engine
    eng = Engine(_linear_pipeline(), mode="step", store=store)
    assert eng.run_to_completion()
    assert eng.external.committed() == [1]


def _engine_part(what, tmp_path):
    from repro_torch.core import (Engine, LineageScope, SegmentLogStore,
                                  ShardedLogStore, SqliteLogStore,
                                  StoreConfig, build_store)
    if what == "sqlite store":
        store = build_store("sqlite", path=str(tmp_path / "log.db"))
        assert isinstance(store, SqliteLogStore)
        _runs_on(store)
    elif what == "sharded store":
        store = build_store("memory+sharded+group")
        assert isinstance(store, ShardedLogStore)
        _runs_on(store)
    elif what == "segment config":
        cfg = StoreConfig(base="segment", path=str(tmp_path / "segs"))
        assert str(cfg) == "segment"
        store = build_store(cfg)
        assert isinstance(store, SegmentLogStore)
        _runs_on(store)
    elif what == "abs":
        eng = Engine(_linear_pipeline(), protocol="abs")
        eng.start()
        assert eng.wait(30)
        assert eng.external.committed() == [1]
    elif what == "replay":
        eng = Engine(_linear_pipeline(), mode="step",
                     lineage_scopes=[LineageScope(("src", "out"),
                                                  ("win", "out"))])
        assert eng.run_to_completion()
        rep = eng.replay([("win", "out", 0)])
        assert rep.ok and rep.executed_ops == frozenset({"win"})


# The parts of the engine that raised until the engine slice: each builds
# and runs a one-event pipeline on the CPU now.
ENGINE_PARTS = ["abs", "replay", "segment config", "sharded store",
                "sqlite store"]


@pytest.mark.parametrize("what", ENGINE_PARTS)
def test_engine_parts_run(what, tmp_path):
    _engine_part(what, tmp_path)


# The optimizer-state variants, which raised until the low-precision slice:
# each builds and runs one train step of a tiny model on the CPU.
LOW_PRECISION = {
    "int8 moments": dict(moment_dtype="int8"),
    "bf16 moments": dict(moment_dtype="bfloat16", grad_accum_dtype="bfloat16"),
    "compressed grads": dict(compress_grads=True),
}


@pytest.mark.parametrize("what", sorted(LOW_PRECISION))
def test_low_precision_options_run(what):
    from repro_torch.training import (OptHParams, init_train_state,
                                      make_train_step)
    kw = dict(LOW_PRECISION[what])
    compress = kw.pop("compress_grads", False)
    cfg, hp = _tiny(), OptHParams(**kw)
    state = init_train_state(torch.Generator().manual_seed(0), cfg, hp,
                             device="cpu")
    toks = torch.randint(0, cfg.vocab, (1, 2, 17),
                         generator=torch.Generator().manual_seed(1))
    state, metrics = make_train_step(cfg, hp, M.Runtime(remat="none"),
                                     compress_grads=compress)(
        state, {"tokens": toks[..., :-1], "labels": toks[..., 1:]})
    assert int(state["step"]) == 1 and bool(metrics["loss"].isfinite())
    with pytest.raises(ValueError):
        OptHParams(moment_dtype="float16")


def test_memory_store_and_step_engine_run():
    from repro_torch.core import Engine, MemoryLogStore, build_store
    assert isinstance(build_store("memory"), MemoryLogStore)
    eng = Engine(_linear_pipeline(), mode="step", store="memory")
    assert eng.run_to_completion()
    assert eng.external.committed() == [1]


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b",
                                  "jamba-1.5-large-398b"])
def test_moe_families_serve_through_the_driver(arch):
    """The MoE families (grok; arctic's MoE beside a dense FFN; jamba's
    Mamba + attention + MoE block) serve a reduced model on the CPU."""
    done = serve_driver.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--tokens", "4", "--slots",
                              "2", "--d-model", "64"])
    assert sorted(done) == [0, 1, 2]
    assert all(len(toks) == 4 for toks in done.values())


def test_encdec_serves_through_the_driver():
    """seamless: a reduced encoder-decoder serves on the CPU, its decoder
    over a cross K/V cache of ``cross_len`` = 16 zero keys a slot (nothing
    fills it, as in the JAX driver)."""
    done = serve_driver.main(["--arch", "seamless", "--device", "cpu",
                              "--requests", "3", "--tokens", "4", "--slots",
                              "2", "--d-model", "64"])
    assert sorted(done) == [0, 1, 2]
    assert all(len(toks) == 4 for toks in done.values())


def test_falcon_mamba_serves_through_the_driver():
    done = serve_driver.main(["--arch", "falcon-mamba-7b", "--device", "cpu",
                              "--requests", "3", "--tokens", "4", "--slots",
                              "2", "--d-model", "64"])
    assert sorted(done) == [0, 1, 2]
    assert all(len(toks) == 4 for toks in done.values())


def test_runtime_rejects_unknown_attn_impl():
    with pytest.raises(ValueError):
        M.Runtime(attn_impl="xla")


def test_runtime_rejects_unknown_scan_impl():
    with pytest.raises(ValueError):
        M.Runtime(scan_impl="pallas")


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper decides from."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def _claims_cuda(t):
    return t.as_subclass(_ClaimsCuda)


class _ClaimsXpu(torch.Tensor):
    """A CPU tensor that reports a device of neither kind the wrappers
    take."""

    @property
    def device(self):
        return torch.device("xpu", 0)


class _Launched(Exception):
    pass


def _refuse(*args, **kwargs):
    raise _Launched("launcher reached")


@pytest.mark.parametrize("which", ["flash_attention", "decode_attention",
                                   "selective_scan"])
def test_wrappers_choose_the_plain_version_only_by_device(monkeypatch, which):
    monkeypatch.setattr(ops, f"_launch_{which}", _refuse)
    q4, k4 = torch.randn(1, 8, 4, 32), torch.randn(1, 8, 2, 32)
    q3, lengths = torch.randn(1, 4, 32), torch.tensor([5], dtype=torch.int32)
    args = {"flash_attention": (q4, k4, k4),
            "decode_attention": (q3, k4, k4, lengths),
            "selective_scan": (torch.rand(2, 8, 4, 3), torch.randn(2, 8, 4, 3),
                               torch.randn(2, 4, 3))}[which]
    wrapper = getattr(ops, which)
    before = dict(ops.LAUNCHES)
    # CPU tensors: the plain version, no launch
    want = getattr(ref, f"{which}_ref")(*args)
    torch.testing.assert_close(wrapper(*args), want, rtol=0, atol=0)
    # tensors that claim the card: the launcher, whose error propagates;
    # the plain version is never consulted
    monkeypatch.setattr(ref, f"{which}_ref", _refuse)
    with pytest.raises(_Launched):
        wrapper(*(_claims_cuda(a) for a in args))
    assert ops.LAUNCHES == before          # a failed launch is not counted
    # meta tensors (the dry-run's trace): the shape-only route, the plain
    # version's shapes, no launch
    got = wrapper(*(a.to("meta") for a in args))
    assert got.device.type == "meta" and got.shape == want.shape \
        and got.dtype == want.dtype
    assert ops.LAUNCHES == before
    # a tensor on another device is refused before any launch
    with pytest.raises(ValueError):
        wrapper(*(a.as_subclass(_ClaimsXpu) for a in args))


@pytest.mark.parametrize("bad", ["dim", "group", "noncontiguous", "grad"])
def test_kernel_limits_are_checked_before_launch(monkeypatch, bad):
    """On the card the wrapper refuses what the kernels do not take before
    it launches anything (the launcher here would raise _Launched): head
    dim 0 (every head dim from 1 is built, padded or on the wide route), q
    heads that are not a multiple of the kv heads (every whole group
    runs), non-contiguous operands, grad on a bare kernel call."""
    monkeypatch.setattr(ops, "_launch_decode_attention", _refuse)
    monkeypatch.setattr(ops, "_launch_flash_attention", _refuse)
    H, KV, D = 4, 2, 32
    if bad == "dim":
        D = 0
    elif bad == "group":
        H, KV = 6, 4
    q, k = torch.randn(1, H, D), torch.randn(1, 8, KV, D)
    lengths = torch.tensor([5], dtype=torch.int32)
    q4 = torch.randn(1, 8, H, D)
    if bad == "noncontiguous":
        k = torch.randn(1, 8, D, KV).transpose(2, 3)
    flash = ops.flash_attention
    if bad == "grad":
        q.requires_grad_(True)
        q4.requires_grad_(True)
        # gradients of flash attention go through ops.FlashAttention; a bare
        # kernel call refuses them (test_flash_grad_reaches_the_kernels)
        flash = functools.partial(ops.flash_attention_forward, causal=True,
                                  window=None, softcap=None, want_lse=False)
    err = NotImplementedError if bad == "grad" else ValueError
    with pytest.raises(err):
        ops.decode_attention(*(_claims_cuda(t) for t in (q, k, k, lengths)))
    with pytest.raises(err, match="FlashAttention" if bad == "grad" else None):
        flash(*(_claims_cuda(t) for t in (q4, k, k)))


def test_flash_grad_reaches_the_kernels(monkeypatch):
    """On the card, flash attention with grad goes through ops.FlashAttention
    to the forward kernel (asked for its lse) in f32 and in bf16; the
    backward wrapper takes both dtypes to the kernel library and refuses a
    malformed lse or mixed dtypes before any launch."""
    seen = []
    monkeypatch.setattr(ops, "_launch_flash_attention",
                        lambda *a: seen.append(a[4]) or _refuse())
    q = torch.randn(1, 8, 4, 32, requires_grad=True)
    k = torch.randn(1, 8, 2, 32)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(_Launched):
            ops.flash_attention(*(_claims_cuda(t.detach().to(dt).requires_grad_())
                                  for t in (q, k, k)))
    assert len(seen) == 2                                # lse [B,H,Sq] f32
    assert all(tuple(x.shape) == (1, 4, 8) and x.dtype == torch.float32
               for x in seen)
    monkeypatch.setattr(ops.build, "load", _refuse)     # the library's load
    qd = q.detach()
    lse = torch.zeros(1, 4, 8)
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(_Launched):
            ops.flash_attention_backward(*(_claims_cuda(t.to(dt)) for t in
                                           (qd, k, k, qd)), _claims_cuda(lse),
                                         _claims_cuda(qd.to(dt)))
    with pytest.raises(ValueError, match="lse"):
        ops.flash_attention_backward(*(_claims_cuda(t) for t in
                                       (qd, k, k, qd, lse[:, :, :4], qd)))
    with pytest.raises(ValueError, match="dout"):
        ops.flash_attention_backward(*(_claims_cuda(t.bfloat16()) for t in
                                       (qd, k, k, qd)), _claims_cuda(lse),
                                     _claims_cuda(qd))


@pytest.mark.parametrize("bad", ["noncontiguous", "grad"])
def test_scan_limits_are_checked_before_launch(monkeypatch, bad):
    """A non-contiguous operand, or a bare forward-kernel call with grad, is
    refused before any launch; with grad the wrapper itself goes through
    ops.SelectiveScan to the forward kernel."""
    monkeypatch.setattr(ops, "_launch_selective_scan", _refuse)
    a, b = torch.rand(2, 8, 4, 3), torch.randn(2, 8, 4, 3)
    if bad == "noncontiguous":
        b = torch.randn(2, 8, 3, 4).transpose(2, 3)
        with pytest.raises(ValueError):
            ops.selective_scan(_claims_cuda(a), _claims_cuda(b))
        return
    a.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="SelectiveScan"):
        ops.selective_scan_forward(_claims_cuda(a), _claims_cuda(b))
    with pytest.raises(_Launched):
        ops.selective_scan(_claims_cuda(a), _claims_cuda(b))


def test_kernels_are_not_built_on_import():
    from repro_torch.kernels import build
    assert build.load.cache_info().currsize == 0
    assert build.library_path().suffix == ".so"
    assert dataclasses.is_dataclass(M.Runtime)
