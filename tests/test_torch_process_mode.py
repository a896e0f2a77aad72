"""The port's process mode on the CPU: copies of ``tests/test_process_mode.py``
on ``repro_torch.core`` (the full crash-point matrix is in
``tests/test_torch_process_matrix.py``).

Every operator group runs as an OS process; every injected crash is a real
``kill -9`` of the worker, so volatile state loss is enforced by the OS.
The cases run over the ``proc_transport`` and ``proc_ctx`` axes of
``tests/conftest.py``, as their JAX counterparts do. Where a JAX case
sleeps a fixed time before it scales, the copy waits for outputs committed
so far, so each scaling step lands mid-run on a loaded host too.
"""
import os
import signal
import sqlite3
import subprocess
import sys
import threading
import time
from functools import partial

import pytest

pytest.importorskip("torch")

import repro_torch.core as TC  # noqa: E402
from repro_torch.core import Engine, FailureInjector  # noqa: E402
from repro_torch.core.scaling import Controller  # noqa: E402
from tests.torch_core_helpers import (FileExternalSystem,  # noqa: E402
                                      ident, linear_pipeline, mk_replica,
                                      mk_store, replica_pipeline,
                                      sink_outputs, wait_for, window_writes)

# boot polling + eng.wait(90..150) on a loaded host exceed the global 120s
# pytest-timeout; 300s still fails a genuine hang
pytestmark = pytest.mark.timeout(300)

# the sqlite family is the deployment target: one durable store shared by
# every worker process (plain, group-commit, and sharded+group with the
# global flush-epoch 2PC)
SQLITE_SPECS = ["sqlite", "sqlite+group", "sqlite+sharded+group"]

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mk(spec, root):
    return mk_store(TC, spec, root, shards=3, batch_size=4, interval=0.001)


def run(build, expected, spec, plan, root, timeout=60.0, require_fired=True,
        transport="routed", ctx=None):
    """One process-mode run under an injected SIGKILL plan, held to
    exactly-once outputs and the failures the plan fired."""
    inj = FailureInjector(plan)
    eng = Engine(build(), mode="process", store=_mk(spec, root),
                 injector=inj, transport=transport, ctx=ctx,
                 restart_delay=0.02)
    eng.start()
    ok = eng.wait(timeout)
    eng.stop()
    assert ok, (spec, plan)
    assert sink_outputs(eng) == expected, (spec, plan)
    assert len(window_writes(eng)) == 5, (spec, plan)
    if require_fired:        # every plan entry SIGKILLed a live worker
        assert eng.failures == len(plan), (spec, plan)
    else:
        assert eng.failures == len(inj.fired), (spec, plan)
    return eng


# one crash point per protocol phase x operator role: each case SIGKILLs a
# live worker there and requires exactly-once completion
MATRIX = [
    ("src", "source_post_log", 2),
    ("map", "pre_state_update", 2),
    ("map", "post_send", 1),
    ("win", "post_ack_log", 2),
    ("win", "pre_log", 1),
    ("win", "post_log", 2),
    ("sink", "pre_write", 1),
    ("sink", "post_write_pre_done", 2),
]


@pytest.mark.parametrize("spec", SQLITE_SPECS)
@pytest.mark.parametrize("op_id,point,nth", MATRIX)
def test_sigkill_recovery_matrix(op_id, point, nth, spec, proc_transport,
                                 proc_ctx, tmp_path):
    build, expected = linear_pipeline(TC, writes=1)
    run(build, expected, spec, [(op_id, point, nth)], tmp_path,
        transport=proc_transport, ctx=proc_ctx)


def test_multiple_worker_kills(store_spec, proc_transport, proc_ctx,
                               tmp_path):
    """Two distinct groups SIGKILLed in one run (Case 3 of the proof),
    against the LOGIO_STORE_SPEC-selected stacks."""
    build, expected = linear_pipeline(TC, writes=1)
    run(build, expected, store_spec,
        [("map", "post_ack_log", 2), ("win", "pre_log", 1)], tmp_path,
        transport=proc_transport, ctx=proc_ctx)


def test_nonblocking_recovery_other_groups_advance(proc_transport, proc_ctx,
                                                   tmp_path):
    """Kill one group mid-stream; the other workers keep processing while
    it restarts (the paper's non-blocking property across processes)."""
    build, expected = linear_pipeline(TC, n_events=200, window=4,
                                      sink_target=50, writes=1, rate=0.005)
    eng = Engine(build(), mode="process",
                 store=_mk("sqlite+sharded+group", tmp_path),
                 transport=proc_transport, ctx=proc_ctx, restart_delay=0.3)
    eng.start()
    wait_for(lambda: eng.metrics().op("src").processed >= 10, 30.0,
             "pipeline start")
    before = eng.metrics().op("src").processed
    eng.kill_group("win")
    # poll inside the restart_delay window (win is down): the source must
    # advance at some point
    deadline = time.time() + 0.25
    during = before
    while during <= before and time.time() < deadline:
        during = eng.metrics().op("src").processed
        time.sleep(0.005)
    assert eng.wait(90)
    eng.stop()
    assert during > before, "source stalled while win was down"
    assert eng.failures >= 1
    assert sink_outputs(eng) == expected


def _committed(eng):
    return len(eng.external.committed())


def _doubled(eng, n):
    return sorted(b["v"] for b in eng.external.committed()) == \
        sorted(2 * i for i in range(n))


def test_scaling_on_live_workers(proc_transport, proc_ctx):
    """Algorithms 12-13 against live worker processes: scale up a new
    replica process mid-run, then scale one down; replicas, source and
    sink keep their processes throughout. The copy scales at committed
    output counts where the JAX case sleeps 0.3 s."""
    n = 60
    eng = Engine(replica_pipeline(TC, n)(), mode="process",
                 transport=proc_transport, ctx=proc_ctx, restart_delay=0.02)
    ctrl = Controller(eng, "disp", "mrg",
                      replica_factory=partial(mk_replica, TC))
    eng.start()
    wait_for(lambda: _committed(eng) >= 10)
    ctrl.scale_up("r2")
    wait_for(lambda: _committed(eng) >= 25)
    assert _committed(eng) < n, "the run ended before the scale-down"
    ctrl.scale_down("r1")
    assert eng.wait(90)
    eng.stop()
    assert _doubled(eng, n)


def test_scaling_with_worker_kill(proc_transport, proc_ctx):
    """A replica worker SIGKILLed while another is being scaled in."""
    n = 60
    inj = FailureInjector([("r0", "post_log", 3)])
    eng = Engine(replica_pipeline(TC, n)(), mode="process", injector=inj,
                 transport=proc_transport, ctx=proc_ctx, restart_delay=0.02)
    ctrl = Controller(eng, "disp", "mrg",
                      replica_factory=partial(mk_replica, TC))
    eng.start()
    wait_for(lambda: _committed(eng) >= 10)
    ctrl.scale_up("r2")
    assert eng.wait(90)
    eng.stop()
    assert _doubled(eng, n)
    assert eng.failures >= 1


# ---------------------------------------------------------------------------
# true kill -9 of the WHOLE engine process tree (supervisor + workers):
# exactly the unflushed/uncommitted epochs are lost; a warm restart on the
# surviving durable files replays to the correct state
# ---------------------------------------------------------------------------

def committed_epochs(db_path):
    ep = f"{db_path}.epochs"
    if not os.path.exists(ep):
        return set()
    conn = sqlite3.connect(ep)
    try:
        return {r[0] for r in conn.execute("SELECT epoch_id FROM epochs")}
    finally:
        conn.close()


def shard_files(db_path, spec):
    if "sharded" in spec:
        return [p for p in (f"{db_path}.shard{i}" for i in range(8))
                if os.path.exists(p)]
    return [db_path] if os.path.exists(db_path) else []


def kill9_run(spec, db_path, ext_path, transport, ctx, kill_after):
    """Run ``tests/torch_kill9_runner.py`` in a session of its own and
    SIGKILL the whole session ``kill_after`` seconds after it is READY."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    proc = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_kill9_runner.py"),
         spec, db_path, ext_path, transport, ctx],
        stdout=subprocess.PIPE, env=env, start_new_session=True)
    try:
        assert proc.stdout.readline().strip() == b"READY"
        time.sleep(kill_after)
    finally:
        # kill -9 the whole session: supervisor AND workers, no cleanup
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
        proc.stdout.close()


def reopen_store(spec, db_path):
    """The store of a killed run reopened over its files. Opening runs the
    restart half of the flush-epoch 2PC: each shard deletes the WAL rows of
    every epoch that has no commit record."""
    return mk_store(TC, spec, path=db_path, shards=3, batch_size=4,
                    interval=60.0)


def resume_exactly_once(spec, db_path, ext_path, transport, ctx, store=None):
    """Warm-restart on the reopened store (``store``, else reopened here)
    with the surviving external file, and hold the run to exactly-once."""
    if store is None:
        store = reopen_store(spec, db_path)
    build, expected = linear_pipeline(TC, writes=1, rate=0.01)
    eng = Engine(build(), mode="process", store=store,
                 external=FileExternalSystem(ext_path), resume=True,
                 transport=transport, ctx=ctx, restart_delay=0.01)
    eng.start()
    ok = eng.wait(90)
    eng.stop()
    assert ok
    assert sink_outputs(eng) == expected
    assert len(window_writes(eng)) == 5


@pytest.mark.parametrize("spec", ["sqlite+group", "sqlite+sharded+group"])
@pytest.mark.parametrize("kill_after", [0.25, 0.6])
def test_kill9_whole_engine_loses_exactly_unflushed_epoch(spec, kill_after,
                                                          tmp_path,
                                                          proc_transport,
                                                          proc_ctx):
    db_path = str(tmp_path / "log.db")
    ext_path = str(tmp_path / "external.bin")
    kill9_run(spec, db_path, ext_path, proc_transport, proc_ctx, kill_after)
    # the unflushed epoch is lost atomically: after the store reopens (the
    # restart rollback), every epoch-tagged WAL row that survived belongs to
    # a committed epoch. Before it reopens, a kill that lands between the
    # shards' prepare and the epoch's commit record leaves that epoch's rows
    # on disk (test_kill_between_prepare_and_commit_record_rolls_back_at_reopen)
    committed = committed_epochs(db_path)
    store = reopen_store(spec, db_path)
    for f in shard_files(db_path, spec):
        conn = sqlite3.connect(f)
        try:
            leftover = [e for (e,) in conn.execute(
                "SELECT DISTINCT epoch FROM wal_ops WHERE epoch IS NOT NULL")]
        finally:
            conn.close()
        assert all(e in committed for e in leftover), (f, leftover, committed)
    resume_exactly_once(spec, db_path, ext_path, proc_transport, proc_ctx,
                        store=store)


@pytest.mark.parametrize("package", ["repro.core", "repro_torch.core"])
def test_kill_between_prepare_and_commit_record_rolls_back_at_reopen(
        package, tmp_path):
    """The window the whole-engine kill can land in: every shard has
    prepared (its epoch's WAL rows are committed to its SQLite file) and
    the epoch's commit record is not written. The rows stay on disk until
    the store reopens, whose rollback deletes them, and the epochs that
    committed before survive. Both packages behave so."""
    import importlib
    core = importlib.import_module(package)
    ls = importlib.import_module(package + ".logstore")
    events = importlib.import_module(package + ".events")
    path = str(tmp_path / "log.db")
    kw = dict(shards=3, batch_size=100, interval=60.0, path=path)
    store = ls.build_store("sqlite+sharded+group", **kw)

    def log(ev):
        txn = store.begin()
        txn.log_event(ev, events.UNDONE)
        txn.put_event_data(ev)
        txn.commit()

    for i, rec in enumerate(["B", "C", "D"]):
        log(core.Event(i, "A", "out", rec, "in"))
    store.flush()
    for i, rec in enumerate(["B", "C", "D"], start=10):   # several shards
        log(core.Event(i, "A", "out", rec, "in"))
    eid = store.epoch_coord.next_epoch()
    with store._epoch_barrier.write():
        cut = [(s, s.cut_pending(eid)) for s in store._group_shards]
    for s, batch in cut:
        if batch:
            s.persist_prepared(eid)
    for s in store.shards:      # the kill: no commit record, no cleanup
        s.inner.close()
    store.epoch_coord.close()

    def on_disk():
        out = set()
        for f in shard_files(path, "sharded"):
            conn = sqlite3.connect(f)
            try:
                out |= {e for (e,) in conn.execute(
                    "SELECT DISTINCT epoch FROM wal_ops "
                    "WHERE epoch IS NOT NULL")}
            finally:
                conn.close()
        return out

    committed = committed_epochs(path)
    assert eid not in committed
    assert eid in on_disk()
    store = ls.build_store("sqlite+sharded+group", **kw)
    try:
        assert on_disk() <= committed and on_disk()
        got = sorted(e.event_id for e, _ in store.fetch_resend_events("A"))
        assert got == [0, 1, 2], got
    finally:
        store.close()


# ---------------------------------------------------------------------------
# credit-based back-pressure: a slow consumer bounds every buffer at the
# credit window instead of growing supervisor (or sender) memory
# ---------------------------------------------------------------------------

def _bp_pipeline(n, window, sink_pt):
    def build():
        p = TC.Pipeline()
        p.add(partial(TC.GeneratorSource, "src",
                      TC.ReadSource([{"v": i} for i in range(n)])))
        p.add(partial(TC.MapOperator, "map", fn=ident))
        p.add(partial(TC.TerminalSink, "sink", target=n,
                      processing_time=sink_pt))
        p.connect("src", "out", "map", "in", capacity=window)
        p.connect("map", "out", "sink", "in", capacity=window)
        return p
    return build


def test_backpressure_bounds_buffers(proc_transport, proc_ctx):
    """Fast producer, slow consumer, tiny credit window: the supervisor's
    authoritative buffers never exceed the window (routed) and never hold
    an event at all (socket: payloads bypass the supervisor)."""
    n, window = 120, 8
    eng = Engine(_bp_pipeline(n, window, 0.002)(), mode="process",
                 transport=proc_transport, ctx=proc_ctx,
                 store=mk_store(TC, "memory"))
    eng.start()
    peak = [0]

    def watch():
        while not eng._done.is_set():
            peak[0] = max(peak[0],
                          max((len(c) for c in eng.channels), default=0))
            time.sleep(0.002)
    t = threading.Thread(target=watch, daemon=True)
    t.start()
    ok = eng.wait(90)
    t.join(timeout=5.0)
    eng.stop()
    assert ok
    assert len(sink_outputs(eng)) == n
    limit = 0 if proc_transport in ("socket", "tcp") else window
    assert peak[0] <= limit, (proc_transport, peak[0], window)


def test_end_of_stream_force_drain_with_lazy_watermark(proc_transport,
                                                       proc_ctx, tmp_path):
    """A group-commit store whose tail batch never flushes on its own: at
    end of stream the supervisor pushes the watermark so the run ends."""
    build, expected = linear_pipeline(TC, writes=1)
    eng = Engine(build(), mode="process", transport=proc_transport,
                 ctx=proc_ctx,
                 store=mk_store(TC, "sqlite+group", tmp_path, batch_size=100,
                                interval=60.0))
    eng.start()
    ok = eng.wait(60)
    eng.stop()
    assert ok
    assert sink_outputs(eng) == expected


def test_blocked_sender_survives_receiver_sigkill(proc_transport, proc_ctx,
                                                  tmp_path):
    """The producer is credit-blocked on a full window when its consumer
    group is SIGKILLed; recovery resets the window and the run ends."""
    n, window = 80, 4
    eng = Engine(_bp_pipeline(n, window, 0.004)(), mode="process",
                 transport=proc_transport, ctx=proc_ctx,
                 store=_mk("sqlite+group", tmp_path), restart_delay=0.05)
    eng.start()
    wait_for(lambda: eng.metrics().op("sink").processed >= 10, 30.0,
             "steady state")
    eng.kill_group("sink")
    ok = eng.wait(90)
    eng.stop()
    assert ok
    assert eng.failures >= 1
    assert len(sink_outputs(eng)) == n
