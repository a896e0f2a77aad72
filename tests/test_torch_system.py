"""End-to-end behaviour of the port's LOG.io engine (step and thread mode),
on the CPU: a copy of ``tests/test_system.py`` on ``repro_torch.core``,
with its pipelines from ``tests/torch_core_helpers.py``.

Each step-mode case also runs the same pipeline, plan and lineage scopes
on ``repro.core`` and holds the committed outputs, the failure count and
the lineage answers ``==`` (step mode is deterministic; thread mode is
held to the failure-free expectation only).
"""
import random
import time

import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import (Engine, FailureInjector, LineageQuery,  # noqa: E402
                              LineageScope)
from tests.torch_core_helpers import (diamond_pipeline,  # noqa: E402
                                      linear_pipeline, plain, sink_outputs)


def _step_run(core, build, plan=(), scopes=None):
    """One step-mode run of ``build(core)()`` on ``core``."""
    kw = {}
    if scopes is not None:
        kw["lineage_scopes"] = [core.LineageScope(*s) for s in scopes]
    eng = core.Engine(build(core)(), mode="step",
                      injector=core.FailureInjector(list(plan)), **kw)
    assert eng.run_to_completion()
    return eng


def _parity(build, plan=(), scopes=None, queries=()):
    """The port's run and ``repro.core``'s: outputs, every committed
    external write, failures and restarts, and each lineage query of
    ``queries`` (("backward", key) or ("forward", key, op)) ``==``.
    Returns the port's engine."""
    runs = {}
    for core in (TC, JC):
        eng = _step_run(core, build, plan, scopes)
        q = core.LineageQuery(eng.store)
        answers = [plain(q.backward(a[1]).keys()) if a[0] == "backward"
                   else plain(q.forward(a[1], a[2]).keys()) for a in queries]
        runs[core] = (eng, (eng.external.committed(), eng.failures,
                            eng.restarts, answers))
    assert runs[TC][1] == runs[JC][1]
    return runs[TC][0]


def test_happy_path_exactly_once():
    build, expected = linear_pipeline(TC)
    eng = Engine(build(), mode="step")
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected
    _parity(lambda core: linear_pipeline(core)[0])


def test_happy_path_with_writer_ops():
    build, expected = linear_pipeline(TC, writes=1)
    eng = Engine(build(), mode="step")
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected
    win_writes = [b for b in eng.external.committed()
                  if isinstance(b, dict) and "inset" in b]
    assert len(win_writes) == 5
    _parity(lambda core: linear_pipeline(core, writes=1)[0])


def test_diamond_topology():
    build, expected = diamond_pipeline(TC)
    eng = Engine(build(), mode="step")
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected
    _parity(lambda core: diamond_pipeline(core)[0])


def test_diamond_with_failures():
    build, expected = diamond_pipeline(TC)
    plan = [("join", "pre_log", 1), ("fast", "post_log", 3),
            ("src", "source_post_log", 7)]
    inj = FailureInjector(plan)
    eng = Engine(build(), mode="step", injector=inj)
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected
    assert eng.failures == 3
    _parity(lambda core: diamond_pipeline(core)[0], plan)


def test_thread_mode_with_failure():
    build, expected = linear_pipeline(TC)
    inj = FailureInjector([("win", "post_log", 2)])
    eng = Engine(build(), mode="thread", injector=inj, restart_delay=0.01)
    eng.start()
    assert eng.wait(30)
    eng.stop()
    assert sink_outputs(eng) == expected
    assert eng.failures == 1


def test_non_blocking_recovery_only_failed_group_restarts():
    build, expected = linear_pipeline(TC)
    inj = FailureInjector([("win", "pre_log", 1)])
    eng = Engine(build(), mode="thread", injector=inj, restart_delay=0.05)
    eng.start()
    assert eng.wait(30)
    eng.stop()
    # only the failed group restarted (LOG.io is non-blocking)
    assert eng.restarts == 1
    assert sink_outputs(eng) == expected


def test_lineage_backward_forward():
    build, expected = linear_pipeline(TC)
    scopes = [LineageScope(("src", "out"), ("win", "out"))]
    eng = Engine(build(), mode="step", lineage_scopes=scopes)
    assert eng.run_to_completion()
    q = LineageQuery(eng.store)
    back = q.backward(("win", "out", 0)).keys()
    assert ("src", "out", 0) in back and ("src", "out", 3) in back
    assert ("src", "out", 4) not in back     # no false contributors
    fwd = q.forward(("src", "out", 2), "map").keys()
    assert ("win", "out", 0) in fwd
    assert ("win", "out", 1) not in fwd
    _parity(lambda core: linear_pipeline(core)[0],
            scopes=[(("src", "out"), ("win", "out"))],
            queries=[("backward", ("win", "out", 0)),
                     ("forward", ("src", "out", 2), "map")])


def test_lineage_correct_under_failure():
    build, expected = linear_pipeline(TC)
    scopes = [LineageScope(("src", "out"), ("win", "out"))]
    plan = [("win", "post_log", 1), ("map", "pre_log", 5)]
    inj = FailureInjector(plan)
    eng = Engine(build(), mode="step", lineage_scopes=scopes, injector=inj)
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected
    q = LineageQuery(eng.store)
    for i in range(5):
        back = q.backward(("win", "out", i))
        srcs = sorted(k.ssn for k in back if k.op == "src")
        assert srcs == list(range(i * 4, (i + 1) * 4))
    _parity(lambda core: linear_pipeline(core)[0], plan,
            scopes=[(("src", "out"), ("win", "out"))],
            queries=[("backward", ("win", "out", i)) for i in range(5)])


def _nondeterministic(core):
    def build():
        rng = random.Random()   # unseeded: non-deterministic payload salt

        p = core.Pipeline()
        p.add(lambda: core.GeneratorSource(
            "src", core.ReadSource([{"v": i} for i in range(12)])))
        p.add(lambda: core.CountWindowOperator(
            "win", 3, agg=lambda bs: {"s": sum(b["v"] for b in bs),
                                      "salt": rng.random()}))
        p.add(lambda: core.TerminalSink("sink", target=4))
        p.connect("src", "out", "win", "in")
        p.connect("win", "out", "sink", "in")
        return p
    return build


def test_nondeterministic_operator_recovers():
    """Operators may be non-deterministic (general programming model):
    recovery must still deliver exactly one output per window, and every
    output must be valid for some failure-free execution."""
    plan = [("win", "post_ack_log", 5)]
    runs = {core: _step_run(core, _nondeterministic, plan)
            for core in (TC, JC)}
    outs = sink_outputs(runs[TC])
    assert [o["s"] for o in outs] == [0 + 1 + 2, 3 + 4 + 5, 6 + 7 + 8,
                                      9 + 10 + 11]
    # the salts differ run to run; the sums and failures do not
    assert [o["s"] for o in sink_outputs(runs[JC])] == [o["s"] for o in outs]
    assert runs[JC].failures == runs[TC].failures


def _one_shot(core, n=8):
    class OneShotSource(core.ReadSource):
        """Returns different data on re-execution (non-replayable)."""
        def __init__(self, n):
            super().__init__([], replayable=False)
            self.n = n
            self.executions = 0

        def effect(self, desc, from_offset=0):
            self.executions += 1
            base = self.executions * 1000
            return [{"v": base + i} for i in range(self.n)]

    src_sys = OneShotSource(n)

    def build():
        p = core.Pipeline()
        p.add(lambda: core.GeneratorSource("src", src_sys))
        p.add(lambda: core.TerminalSink("sink", target=n))
        p.connect("src", "out", "sink", "in")
        return p
    return build


def test_non_replayable_source():
    """Non-replayable read actions: effect stored first (Alg 1 step 2),
    failures replay from the store, exactly-once output preserved."""
    eng = _parity(_one_shot, [("src", "source_post_log", 3)])
    outs = sink_outputs(eng)
    # the stored effect was used across the failure: all from ONE execution
    bases = {o["v"] // 1000 for o in outs}
    assert len(bases) == 1
    assert sorted(o["v"] % 1000 for o in outs) == list(range(8))


def test_slow_generate_on_final_events_not_lost():
    """A generate slower than the idle double-check window must not race
    the shutdown: the queued trigger (input already acked and out of the
    channel) is live work, and its outputs must still reach a consumer
    whose thread would otherwise have exited."""
    n, window = 64, 4

    def slow_tail(b):
        if b["v"] >= n - 24:            # stall the tail, incl. the final event
            time.sleep(0.012)
        return {"v": b["v"] * 2}

    def build():
        p = TC.Pipeline()
        p.add(lambda: TC.GeneratorSource(
            "src", TC.ReadSource([{"v": i} for i in range(n)])))
        p.add(lambda: TC.MapOperator("map", fn=slow_tail))
        p.add(lambda: TC.CountWindowOperator(
            "win", window, agg=lambda bs: {"s": sum(b["v"] for b in bs)}))
        p.add(lambda: TC.TerminalSink("sink", target=n // window))
        p.connect("src", "out", "map", "in")
        p.connect("map", "out", "win", "in")
        p.connect("win", "out", "sink", "in")
        return p

    eng = Engine(build(), mode="thread")
    eng.start()
    assert eng.wait(30)
    eng.stop()
    assert [o["s"] for o in sink_outputs(eng)] == [
        sum(2 * j for j in range(i * window, (i + 1) * window))
        for i in range(n // window)]
