"""The port's process mode against ``repro.core``'s and against thread mode,
on the CPU.

* a failure-free process-mode run commits the same external outputs, each
  operator's in the same order, as ``repro.core``'s process-mode run and
  the port's thread-mode run of the same pipeline, and its
  ``MetricsSnapshot`` after ``stop()`` counts the same events processed
  per operator;
* under the same injected SIGKILL plan, both packages commit the
  failure-free outputs, each once, and the backward lineage query of every
  output is the same in both (``==``).
"""
import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from tests.torch_core_helpers import (diamond_pipeline,  # noqa: E402
                                      linear_pipeline, mk_store,
                                      plain, sink_outputs,
                                      window_writes)

pytestmark = pytest.mark.timeout(300)

TRANSPORTS = ["routed", "socket", "tcp", "shm"]

PIPELINES = {
    "linear": (lambda core: linear_pipeline(core, n_events=40, window=4,
                                            sink_target=10, writes=1),
               ("src", "out"), ("win", "out"), 10),
    "diamond": (lambda core: diamond_pipeline(core, n_events=30, n1=6, n2=3,
                                              sink_target=5),
                ("src", "out"), ("join", "out"), 5),
}


def _run(core, name, mode, root, transport="routed", ctx="fork", plan=()):
    make, start, end, n_out = PIPELINES[name]
    build, expected = make(core)
    kw = {"transport": transport, "ctx": ctx} if mode == "process" else {}
    inj = core.FailureInjector(list(plan))
    eng = core.Engine(build(), mode=mode,
                      store=mk_store(core, "sqlite+group", root, batch_size=4,
                                     interval=0.001),
                      injector=inj, restart_delay=0.02,
                      lineage_scopes=[core.LineageScope(start, end)], **kw)
    eng.start()
    assert eng.wait(90), (core.__name__, name, mode, transport)
    eng.stop()
    q = core.LineageQuery(eng.store)
    lineage = [plain(q.backward((end[0], end[1], i))) for i in range(n_out)]
    # the sink's and the window's writes each commit in order; how the two
    # operators' writes interleave in the external system is a race
    out = {"committed": (sink_outputs(eng), window_writes(eng)),
           "sinks": sink_outputs(eng), "expected": expected,
           "processed": {op: m.processed
                         for op, m in eng.metrics().ops.items()},
           "failures": eng.failures, "fired": len(inj.fired),
           "lineage": lineage}
    eng.store.close()
    return out


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_failure_free_process_run_matches_jax_and_thread_mode(name, transport,
                                                              tmp_path):
    port = _run(TC, name, "process", tmp_path / "tp", transport)
    jax = _run(JC, name, "process", tmp_path / "jp", transport)
    thread = _run(TC, name, "thread", tmp_path / "tt")
    assert port["sinks"] == port["expected"]
    assert port["committed"] == jax["committed"] == thread["committed"]
    assert port["processed"] == jax["processed"] == thread["processed"]
    assert port["lineage"] == jax["lineage"] == thread["lineage"]
    assert port["failures"] == jax["failures"] == 0


PLANS = {
    "map-post_send": [("map", "post_send", 3)],
    "win-post_ack_log": [("win", "post_ack_log", 2)],
    "two-groups": [("map", "post_ack_log", 2), ("win", "pre_log", 1)],
    "sink-pre_write": [("sink", "pre_write", 2)],
}


@pytest.mark.parametrize("transport", ["routed", "socket"])
@pytest.mark.parametrize("plan", sorted(PLANS))
def test_sigkill_plan_outputs_and_lineage_match_jax(plan, transport,
                                                    tmp_path):
    free = _run(TC, "linear", "thread", tmp_path / "free")
    port = _run(TC, "linear", "process", tmp_path / "tp", transport,
                plan=PLANS[plan])
    jax = _run(JC, "linear", "process", tmp_path / "jp", transport,
               plan=PLANS[plan])
    # every plan entry SIGKILLed a live worker, in both packages
    assert port["failures"] == jax["failures"] == len(PLANS[plan])
    assert port["fired"] == jax["fired"] == len(PLANS[plan])
    # each committed once, in order: the failure-free outputs
    assert port["committed"] == jax["committed"] == free["committed"]
    assert port["sinks"] == free["expected"]
    assert port["lineage"] == jax["lineage"] == free["lineage"]
    for i, res in enumerate(port["lineage"]):
        srcs = sorted(k for k in res[1]["events"] if k[0] == "src")
        assert srcs == [("src", "out", j) for j in range(4 * i, 4 * i + 4)]
