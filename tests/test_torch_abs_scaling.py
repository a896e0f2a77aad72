"""The port's ABS baseline, dynamic scaling and recovery controller, on the
CPU.

* copies of the in-process cases of ``tests/test_scaling_abs.py`` and
  ``tests/test_controller.py`` on ``repro_torch.core``. The scale-up and
  scale-down copies time their scaling by the outputs committed so far,
  not by fixed sleeps, so each scaling step lands mid-run on any host;
* parity with ``repro.core``: the same ABS outputs and failure counts, on
  every store stack behind the ABS snapshot store, and the same
  ``RecoveryController`` decisions (without their timestamps) for the
  scripted ``tick(snapshot)`` sequences;
* the ABS ``wait`` fix: a run does not end while a global restart is in
  progress (``repro.core.abs`` can lose the outputs of the restart there).

Process-mode cases (a SIGKILL of an epoch-mode worker, a live switch then a
SIGKILL) are not copied: process mode is not ported yet.
"""
import time
from functools import partial

import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import (ControllerConfig, Engine,  # noqa: E402
                              FailureInjector, GeneratorSource, MapOperator,
                              Pipeline, ReadSource, TerminalSink)
from repro_torch.core.controller import RecoveryController  # noqa: E402
from repro_torch.core.scaling import (Controller,  # noqa: E402
                                      DispatcherOperator, MergerOperator)
from tests.torch_core_helpers import (ALL_STACKS, double_v,  # noqa: E402
                                      linear_pipeline, mk_store, sink_outputs)


def _wait_for(cond, timeout=30.0, what="progress"):
    """Poll ``cond`` until it holds; fail loudly after ``timeout``."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"no {what} in {timeout}s"
        time.sleep(0.001)


def _committed(eng):
    return len(eng.external.committed())


# ---------------------------------------------------------------------------
# replicas and scaling (tests/test_scaling_abs.py)
# ---------------------------------------------------------------------------

def _replica(rid, processing_time=0.004):
    return MapOperator(rid, fn=double_v, processing_time=processing_time)


def _replica_pipeline(n, rate=0.002):
    p = Pipeline()
    p.add(partial(GeneratorSource, "src",
                  ReadSource([{"v": i} for i in range(n)]), rate=rate))
    p.add(partial(DispatcherOperator, "disp", ["r0", "r1"]))
    p.add(partial(_replica, "r0"))
    p.add(partial(_replica, "r1"))
    p.add(partial(MergerOperator, "mrg", ["r0", "r1"]))
    p.add(partial(TerminalSink, "sink", target=n))
    p.connect("src", "out", "disp", "in")
    p.connect("disp", "to_r0", "r0", "in")
    p.connect("disp", "to_r1", "r1", "in")
    p.connect("r0", "out", "mrg", "from_r0")
    p.connect("r1", "out", "mrg", "from_r1")
    p.connect("mrg", "out", "sink", "in")
    return p


def _controller(eng):
    return Controller(eng, "disp", "mrg",
                      replica_factory=lambda rid: partial(_replica, rid))


def _doubled(eng, n):
    return sorted(b["v"] for b in eng.external.committed()) == \
        sorted(2 * i for i in range(n))


def test_replicas_exactly_once():
    n = 40
    eng = Engine(_replica_pipeline(n), mode="thread", restart_delay=0.01)
    eng.start()
    assert eng.wait(30)
    assert _doubled(eng, n)


def test_replica_failure_nonblocking():
    n = 40
    eng = Engine(_replica_pipeline(n), mode="thread",
                 injector=FailureInjector([("r0", "post_log", 3)]),
                 restart_delay=0.01)
    eng.start()
    assert eng.wait(30)
    assert _doubled(eng, n)
    assert eng.failures == 1


def test_scale_up_and_down_with_failure():
    n = 60
    eng = Engine(_replica_pipeline(n), mode="thread",
                 injector=FailureInjector([("r0", "post_log", 3)]),
                 restart_delay=0.01)
    ctrl = _controller(eng)
    eng.start()
    _wait_for(lambda: _committed(eng) >= 10)
    ctrl.scale_up("r2")
    _wait_for(lambda: _committed(eng) >= 25)
    assert _committed(eng) < n, "the run ended before the scale-down"
    ctrl.scale_down("r1")
    assert eng.wait(40)
    assert _doubled(eng, n)
    assert eng.ops["r2"].runtime is not None and "r1" not in eng.ops


def test_scale_down_to_one():
    n = 30
    eng = Engine(_replica_pipeline(n), mode="thread", restart_delay=0.01)
    ctrl = _controller(eng)
    eng.start()
    _wait_for(lambda: _committed(eng) >= 5)
    assert _committed(eng) < n, "the run ended before the scale-down"
    ctrl.scale_down("r0")
    assert eng.wait(30)
    assert _doubled(eng, n)
    assert eng.ops["disp"].routes == ["r1"]


def test_scaling_in_step_mode():
    """Step mode scales too, between steps. At the scale-down the removed
    replica's channels still hold events: ``scale_down`` steps the replica
    and the merger until they drain (``repro.core.scaling`` waits 5 s for
    a group thread step mode does not have, then drops those events)."""
    n, held = 24, []
    for steps in (4, 10, 16):
        eng = Engine(_replica_pipeline(n, rate=0.0), mode="step")
        ctrl = _controller(eng)
        eng.run_to_completion(max_steps=steps)
        ctrl.scale_up("r2")
        eng.run_to_completion(max_steps=steps)
        held.append(sum(len(c) for c in eng.channels
                        if "r0" in (c.send_op, c.rec_op)))
        t0 = time.monotonic()
        ctrl.scale_down("r0")
        assert time.monotonic() - t0 < 2.0, "the drain waited for a thread"
        assert eng.run_to_completion()
        assert _doubled(eng, n), steps
        assert eng.ops["disp"].routes == ["r1", "r2"]
    assert any(held), held


# ---------------------------------------------------------------------------
# ABS baseline
# ---------------------------------------------------------------------------

def test_abs_normal_processing():
    build, expected = linear_pipeline(TC)
    eng = Engine(build(), mode="thread", protocol="abs",
                 abs_options={"epoch_events": 5})
    eng.start()
    assert eng.wait(30)
    assert sink_outputs(eng) == expected


@pytest.mark.parametrize("nth", [3, 7, 12, 17])
def test_abs_global_restart_recovery(nth):
    build, expected = linear_pipeline(TC)
    eng = Engine(build(), mode="thread", protocol="abs",
                 injector=FailureInjector([("win", "abs_input", nth)]),
                 restart_delay=0.01, abs_options={"epoch_events": 5})
    eng.start()
    assert eng.wait(30)
    assert sink_outputs(eng) == expected
    assert eng.failures == 1


def test_abs_two_failures():
    build, expected = linear_pipeline(TC)
    inj = FailureInjector([("win", "abs_input", 5), ("map", "abs_input", 9)])
    eng = Engine(build(), mode="thread", protocol="abs", injector=inj,
                 restart_delay=0.01, abs_options={"epoch_events": 5})
    eng.start()
    assert eng.wait(40)
    assert sink_outputs(eng) == expected
    assert eng.failures == 2


def test_abs_wait_does_not_end_inside_a_global_restart():
    """The cause of ``test_abs_two_failures``'s lost outputs: a restart
    clears the channels before it rebuilds the operators, so for a moment
    the old sources read as exhausted beside empty channels. Here that
    moment is stretched to 0.3 s. ``wait`` must sit it out; in
    ``repro.core.abs`` it ends the run there and the last window is lost."""
    build, expected = linear_pipeline(TC)
    eng = Engine(build(), mode="thread", protocol="abs",
                 injector=FailureInjector([("sink", "abs_input", 5)]),
                 restart_delay=0.01, abs_options={"epoch_events": 5})
    build_ops = eng._build

    def slow_build(*a, **kw):
        time.sleep(0.3)
        return build_ops(*a, **kw)

    eng._build = slow_build
    eng.start()
    assert eng.wait(30)
    assert eng.failures == 1
    assert sink_outputs(eng) == expected


def _slow_mid(b):
    if 40 <= b["v"] < 120:
        time.sleep(0.012)
    return {"v": b["v"] * 2}


def test_abs_restart_quiesces_slow_operators():
    n = 160
    p = Pipeline()
    p.add(partial(GeneratorSource, "src",
                  ReadSource([{"v": i} for i in range(n)]), rate=0.002))
    p.add(partial(MapOperator, "map", fn=_slow_mid))
    p.add(partial(TerminalSink, "sink", target=n))
    p.connect("src", "out", "map", "in")
    p.connect("map", "out", "sink", "in")
    inj = FailureInjector([("map", "abs_input", 50), ("map", "abs_input", 90)])
    eng = Engine(p, mode="thread", protocol="abs", injector=inj,
                 restart_delay=0.005, abs_options={"epoch_events": 15})
    eng.start()
    assert eng.wait(60)
    assert sorted(b["v"] for b in sink_outputs(eng)) == \
        sorted(2 * i for i in range(n))
    assert eng.failures == 2


def _abs_run(core, spec, plan, root):
    build, _ = linear_pipeline(core, rate=0.002)
    backend = mk_store(core, spec, root, shards=3, batch_size=4,
                       interval=0.001)
    eng = core.Engine(build(), mode="thread", protocol="abs",
                      injector=core.FailureInjector(plan),
                      restart_delay=0.01,
                      abs_options={"epoch_events": 5,
                                   "durable_store": backend})
    eng.start()
    # the sink's target first: repro.core's wait can end a run early
    # (ROADMAP C.2), which this comparison is not about
    _wait_for(eng._done.is_set, what="sink target")
    assert eng.wait(30)
    eng.stop()
    return sink_outputs(eng), eng.failures, eng.restarts


@pytest.mark.parametrize("spec", ALL_STACKS)
@pytest.mark.parametrize("plan", [[], [("win", "abs_input", 3)],
                                  [("map", "abs_input", 5)]])
def test_abs_outputs_match_jax(spec, plan, tmp_path):
    """ABS over each store stack (snapshots persisted through the log
    interface, an epoch's writes gated on its durability): the outputs and
    counts of repro.core's. The crashes fall while the paced source still
    emits, outside the window the wait fix closes."""
    got = _abs_run(TC, spec, plan, tmp_path / "torch")
    assert got == _abs_run(JC, spec, plan, tmp_path / "jax")
    assert got[0] == linear_pipeline(TC)[1]
    assert got[1] == len(plan)


# ---------------------------------------------------------------------------
# the recovery controller: scripted snapshots (tests/test_controller.py)
# ---------------------------------------------------------------------------

class _StubEngine:
    def __init__(self):
        self.modes = {}
        self.switches = []

    def recovery_mode_of(self, group):
        return self.modes.get(group, "log")

    def set_recovery_mode(self, group, mode):
        self.modes[group] = mode
        self.switches.append((group, mode))

    def metrics(self):
        raise AssertionError("scripted tests must pass snapshots to tick()")


class _StubScaler:
    def __init__(self):
        self.calls = []

    def scale_up(self, rid):
        self.calls.append(("up", rid))

    def scale_down(self, rid):
        self.calls.append(("down", rid))


def _snap(ts, *, ev_in=0, commit_us=0, stall_us=0, qdepth=0, core=TC):
    ops = {"op": core.OpMetrics(op_id="op", group="g", events_in=ev_in,
                                commit_us=commit_us, send_stall_us=stall_us,
                                queue_depth=qdepth)}
    return core.MetricsSnapshot(ts=ts, mode="thread", protocol="logio",
                                ops=ops)


def _ctl(core, cfg, **kw):
    from importlib import import_module
    ctrl = import_module(core.__name__ + ".controller")
    return ctrl.RecoveryController(_StubEngine(), core.ControllerConfig(**cfg),
                                   **kw)


#: name -> (config, controller kwargs, snapshots as (ts, _snap kwargs))
SCRIPTS = {
    "mode_switch_hysteresis": (
        dict(switch_hysteresis=2, high_rate_eps=1000.0),
        dict(mode_groups=("g",)),
        [(0.0, {}), (1.0, dict(ev_in=2000, commit_us=200_000)),
         (2.0, dict(ev_in=4000, commit_us=400_000)),
         (3.0, dict(ev_in=4050, commit_us=405_000, qdepth=500)),
         (4.0, dict(ev_in=4100, commit_us=410_000, qdepth=500))]),
    "votes_reset_on_disagreement": (
        dict(switch_hysteresis=2, high_rate_eps=1000.0),
        dict(mode_groups=("g",)),
        [(0.0, {}), (1.0, dict(ev_in=2000, commit_us=200_000)),
         (2.0, dict(ev_in=2010, commit_us=201_000)),
         (3.0, dict(ev_in=4010, commit_us=401_000))]),
    "stalled_downstream": (
        dict(switch_hysteresis=1, high_rate_eps=1000.0),
        dict(mode_groups=("g",)),
        [(0.0, {}), (1.0, dict(ev_in=2000, commit_us=200_000,
                               stall_us=700_000))]),
    "scaling_hysteresis_and_cooldown": (
        dict(slo_ms=100.0, switch_hysteresis=2, scale_cooldown=0.0,
             max_replicas=2),
        dict(mode_groups=(), initial_replicas=["r0"]),
        [(0.0, {})] + [(float(t), dict(ev_in=100 * t, qdepth=1000))
                       for t in (1, 2, 3, 4)]
        + [(5.0 + i, dict(ev_in=500 + i)) for i in range(3)]
        + [(9.0, dict(ev_in=600))]),
}


def _script(core, name):
    cfg, kw, snaps = SCRIPTS[name]
    scaler = _StubScaler()
    ctl = _ctl(core, cfg, scaler=scaler, **kw)
    for ts, s in snaps:
        ctl.tick(_snap(ts, core=core, **s))
    return ([d[1:] for d in ctl.decisions], ctl.engine.switches,
            scaler.calls, ctl.replicas)


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_controller_decisions_match_jax(name):
    assert _script(TC, name) == _script(JC, name)


def test_mode_switch_hysteresis_scripted():
    cfg = ControllerConfig(switch_hysteresis=2, high_rate_eps=1000.0)
    ctl = RecoveryController(_StubEngine(), cfg, mode_groups=("g",))
    eng = ctl.engine
    ctl.tick(_snap(0.0))
    ctl.tick(_snap(1.0, ev_in=2000, commit_us=200_000))
    assert eng.switches == []
    ctl.tick(_snap(2.0, ev_in=4000, commit_us=400_000))
    assert eng.switches == [("g", "epoch")]
    ctl.tick(_snap(3.0, ev_in=4050, commit_us=405_000, qdepth=500))
    assert eng.switches == [("g", "epoch")]
    ctl.tick(_snap(4.0, ev_in=4100, commit_us=410_000, qdepth=500))
    assert eng.switches == [("g", "epoch"), ("g", "log")]
    assert [d[1] for d in ctl.decisions].count("mode") == 2


def test_mode_votes_reset_on_disagreement():
    decisions, switches, _, _ = _script(TC, "votes_reset_on_disagreement")
    assert switches == [] and decisions == []


def test_stalled_downstream_does_not_vote_epoch():
    decisions, switches, _, _ = _script(TC, "stalled_downstream")
    assert switches == [] and decisions == []


def test_scaling_hysteresis_and_cooldown_scripted():
    scaler = _StubScaler()
    cfg = ControllerConfig(slo_ms=100.0, switch_hysteresis=2,
                           scale_cooldown=0.0, max_replicas=2)
    ctl = RecoveryController(_StubEngine(), cfg, mode_groups=(),
                             scaler=scaler, initial_replicas=["r0"])
    ctl.tick(_snap(0.0))
    ctl.tick(_snap(1.0, ev_in=100, qdepth=1000))
    assert scaler.calls == []
    ctl.tick(_snap(2.0, ev_in=200, qdepth=1000))
    assert scaler.calls == [("up", "r1")]
    assert ctl.replicas == ["r0", "r1"]
    ctl.tick(_snap(3.0, ev_in=300, qdepth=1000))
    ctl.tick(_snap(4.0, ev_in=400, qdepth=1000))
    assert scaler.calls == [("up", "r1")]
    for i in range(3):
        ctl.tick(_snap(5.0 + i, ev_in=500 + i))
    assert scaler.calls == [("up", "r1")]
    ctl.tick(_snap(9.0, ev_in=600))
    assert scaler.calls == [("up", "r1"), ("down", "r1")]
    assert ctl.replicas == ["r0"]
    assert [d[1] for d in ctl.decisions] == ["scale_up", "scale_down"]


def test_controller_loop_survives_sensing_errors():
    ctl = RecoveryController(_StubEngine(),
                             ControllerConfig(sample_interval=0.005))
    ctl.start()
    try:
        _wait_for(lambda: ctl.decisions, timeout=2.0, what="decision")
    finally:
        ctl.stop()
    assert ctl.decisions[0][1] == "error"


def test_controller_accepts_spec_string():
    ctl = RecoveryController(_StubEngine(), "slo_ms=42,switch_hysteresis=5")
    assert ctl.config.slo_ms == 42.0
    assert ctl.config.switch_hysteresis == 5


# ---------------------------------------------------------------------------
# per-group recovery modes on a live engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("point", ["pre_log", "post_log", "post_ack_log"])
def test_epoch_mode_crash_recovery_exactly_once_thread(point):
    build, expected = linear_pipeline(TC, n_events=40, window=4,
                                      sink_target=10)
    eng = Engine(build(), mode="thread", store=mk_store(TC, "memory"),
                 injector=FailureInjector([("map", point, 3)]),
                 restart_delay=0.01,
                 recovery_modes={"map": "epoch", "win": "epoch"},
                 epoch_interval=5)
    eng.start()
    assert eng.wait(60)
    eng.stop()
    assert sink_outputs(eng) == expected
    assert eng.failures == 1
    assert eng.metrics().recovery_modes["map"] == "epoch"


def test_live_switch_with_crash_thread_exactly_once():
    build, expected = linear_pipeline(TC, n_events=60, window=4,
                                      sink_target=15)
    eng = Engine(build(), mode="thread", store=mk_store(TC, "memory"),
                 injector=FailureInjector([("map", "post_log", 20)]),
                 restart_delay=0.01, epoch_interval=4)
    eng.start()
    eng.set_recovery_mode("map", "epoch")
    assert eng.recovery_mode_of("map") == "epoch"
    assert eng.wait(60)
    eng.set_recovery_mode("map", "log")
    assert eng.recovery_mode_of("map") == "log"
    eng.stop()
    assert sink_outputs(eng) == expected
    assert eng.failures == 1


@pytest.mark.parametrize("spec", ["sqlite", "segment"])
def test_mode_record_is_authoritative_across_restart(spec, tmp_path):
    path = str(tmp_path / "log")
    build, expected = linear_pipeline(TC, n_events=20, window=4,
                                      sink_target=5)
    store = mk_store(TC, spec, path=path)
    eng = Engine(build(), mode="thread", store=store, epoch_interval=4)
    eng.start()
    eng.set_recovery_mode("map", "epoch")
    assert eng.wait(30)
    eng.stop()
    assert sink_outputs(eng) == expected
    store.close()
    store2 = mk_store(TC, spec, path=path)
    eng2 = Engine(build(), mode="thread", store=store2, resume=True,
                  epoch_interval=4)
    assert eng2.recovery_mode_of("map") == "epoch"
    store2.close()


def test_recovery_modes_rejects_bad_args():
    build, _ = linear_pipeline(TC)
    with pytest.raises(ValueError, match="unknown group"):
        Engine(build(), recovery_modes={"nope": "epoch"})
    with pytest.raises(ValueError, match="unknown recovery mode"):
        Engine(build(), recovery_modes={"map": "turbo"})
    with pytest.raises(ValueError, match="epoch_interval"):
        Engine(build(), epoch_interval=1)
    eng = Engine(build(), mode="step")
    with pytest.raises(ValueError, match="unknown group"):
        eng.set_recovery_mode("nope", "epoch")
    with pytest.raises(ValueError, match="unknown recovery mode"):
        eng.set_recovery_mode("map", "turbo")


def test_abs_protocol_pins_every_group_to_epoch():
    build, _ = linear_pipeline(TC)
    with pytest.raises(ValueError, match="cannot be mixed"):
        Engine(build(), protocol="abs", recovery_modes={"map": "log"})
    eng = Engine(build(), protocol="abs")
    assert eng.recovery_mode_of("map") == "epoch"
    with pytest.raises(ValueError, match="fixed under protocol"):
        eng.set_recovery_mode("map", "log")


# ---------------------------------------------------------------------------
# end-to-end controller runs
# ---------------------------------------------------------------------------

def test_controller_switches_straggler_group_back_to_log():
    build, expected = linear_pipeline(TC, n_events=120, window=4,
                                      sink_target=30, rate=0.001)
    inj = FailureInjector(stalls=[("map", "post_log", 10, 90, 0.02)])
    eng = Engine(build(), mode="thread", store=mk_store(TC, "memory"),
                 injector=inj, recovery_modes={"map": "epoch"},
                 epoch_interval=8)
    ctl = RecoveryController(
        eng, ControllerConfig(sample_interval=0.02, switch_hysteresis=2,
                              high_rate_eps=100_000.0),
        mode_groups=("map",))
    eng.start()
    ctl.start()
    try:
        assert eng.wait(60)
    finally:
        ctl.stop()
        eng.stop()
    assert sink_outputs(eng) == expected
    assert eng.recovery_mode_of("map") == "log"
    mode_decisions = [d for d in ctl.decisions if d[1] == "mode"]
    assert mode_decisions and mode_decisions[0][2] == "map"
    assert mode_decisions[0][3].startswith("log")


def _burst_rate(off):
    # events 20..59 arrive 20x faster than the rest (the burst)
    return 0.002 if 20 <= off < 60 else 0.04


def _burst_pipeline(n):
    p = Pipeline()
    p.add(partial(GeneratorSource, "src",
                  ReadSource([{"v": i} for i in range(n)]),
                  rate_fn=_burst_rate))
    p.add(partial(DispatcherOperator, "disp", ["r0"]))
    p.add(partial(_replica, "r0", 0.01))
    p.add(partial(MergerOperator, "mrg", ["r0"]))
    p.add(partial(TerminalSink, "sink", target=n))
    p.connect("src", "out", "disp", "in")
    p.connect("disp", "to_r0", "r0", "in")
    p.connect("r0", "out", "mrg", "from_r0")
    p.connect("mrg", "out", "sink", "in")
    return p


def test_controller_scales_replicas_through_burst():
    n = 90
    eng = Engine(_burst_pipeline(n), mode="thread",
                 store=mk_store(TC, "memory"), restart_delay=0.01)
    scaler = Controller(eng, "disp", "mrg",
                        replica_factory=lambda rid: partial(_replica, rid,
                                                            0.01))
    ctl = RecoveryController(
        eng, ControllerConfig(slo_ms=60.0, sample_interval=0.03,
                              switch_hysteresis=2, scale_cooldown=0.2,
                              max_replicas=3),
        mode_groups=(), scaler=scaler, replica_prefix="x",
        initial_replicas=["r0"])
    eng.start()
    ctl.start()
    try:
        assert eng.wait(90)
    finally:
        ctl.stop()
        eng.stop()
    assert _doubled(eng, n)
    kinds = [d[1] for d in ctl.decisions]
    assert "scale_up" in kinds, ctl.decisions
    assert "scale_down" in kinds[kinds.index("scale_up"):], ctl.decisions


def test_controller_drives_a_step_mode_engine():
    """A live controller on a step-mode engine, ticked between runs of
    steps: it reads ``metrics()``, switches ``map`` to epoch recovery and
    back, and the outputs stay exactly once across a crash."""
    build, expected = linear_pipeline(TC, n_events=40, sink_target=10)
    eng = Engine(build(), mode="step", epoch_interval=4,
                 injector=FailureInjector([("map", "post_log", 15)]))
    ctl = RecoveryController(
        eng, ControllerConfig(switch_hysteresis=1, high_rate_eps=1.0),
        mode_groups=("map",))
    ctl.tick()
    while not eng.run_to_completion(max_steps=6):
        ctl.tick()
    assert sink_outputs(eng) == expected
    assert eng.failures == 1
    modes = [d for d in ctl.decisions if d[1] == "mode"]
    assert modes and modes[0][2] == "map" and modes[0][3].startswith("epoch")


def test_batch_governor_stats_is_a_safe_copy():
    from repro_torch.core.batching import BatchGovernor
    gov = BatchGovernor("adaptive")
    gov.observe(8, 0.004)
    s = gov.stats()
    s["runs"] = 999
    s["events"] = -1
    s.clear()
    fresh = gov.stats()
    assert fresh["runs"] == 1 and fresh["events"] == 8
    assert fresh["max_run"] == 8
    assert gov.runs == 1 and gov.events == 8

