"""The port's durable log stores and the crash-point matrix, on the CPU.

* copies of the in-process cases of ``tests/test_logstore.py``,
  ``tests/test_segment_store.py`` and ``tests/test_recovery_matrix.py``,
  run on ``repro_torch.core`` over all ten stacks of the ``"all"`` set
  (not over ``LOGIO_STORE_SPEC``'s default of four memory stacks);
* parity with ``repro.core``: one step-mode run per failure plan of
  ``tests/test_torch_core.py`` on every stack, through both packages from
  the same inputs, leaves the same committed outputs, failure and restart
  counts, and the same rows in the event, input-set, payload, lineage and
  read-action tables (``==``).

The whole-engine ``kill -9`` of a process-mode run on the segment stacks
(``tests/test_segment_store.py``) is copied here too: the engine tree is
SIGKILLed mid-run, with compaction running live, and a warm restart on the
surviving files is exactly-once.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import (Engine, Event, FailureInjector,  # noqa: E402
                              GroupCommitStore, LineageScope, MemoryLogStore,
                              SqliteLogStore, TxnAborted, build_store)
from repro_torch.core.events import DONE, UNDONE  # noqa: E402
from repro_torch.core.logstore.segment import SegmentLogStore  # noqa: E402
from tests.torch_core_helpers import (ALL_STACKS, linear_pipeline,  # noqa: E402
                                      mk_store, sink_outputs, tables,
                                      window_writes)

GROUP_STACKS = [s for s in ALL_STACKS if "group" in s]


def _mk(spec, root):
    return mk_store(TC, spec, root, shards=3, batch_size=4, interval=60.0)


def _ev(i):
    return Event(i, "A", "out", "B", "in")


# ---------------------------------------------------------------------------
# store units (tests/test_logstore.py), every stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ALL_STACKS)
def test_txn_atomicity_on_abort(spec, tmp_path):
    store = _mk(spec, tmp_path)
    txn = store.begin()
    txn.log_event(_ev(0), UNDONE)
    txn.put_event_data(_ev(0))
    txn.set_inset_status("B", "nonexistent-inset", DONE, require_rows=True)
    with pytest.raises(TxnAborted):
        txn.commit()
    assert not store.fetch_resend_events("A")
    assert not store.event_status(("A", "out", 0))


@pytest.mark.parametrize("spec", ALL_STACKS)
def test_assign_and_done_lifecycle(spec, tmp_path):
    store = _mk(spec, tmp_path)
    txn = store.begin()
    for i in range(3):
        txn.log_event(_ev(i), UNDONE)
        txn.put_event_data(_ev(i))
    txn.commit()
    txn = store.begin()
    txn.assign_insets(("A", "out", 0), ["B:1"], rec_op="B")
    txn.assign_insets(("A", "out", 1), ["B:1", "B:2"], rec_op="B")
    txn.commit()
    acked = store.fetch_ack_events("B")
    assert [(e.event_id, ins) for e, ins, _ in acked] == \
        [(0, "B:1"), (1, "B:1"), (1, "B:2")]
    assert [e.event_id for e, _ in store.fetch_resend_events("A")] == [2]
    txn = store.begin()
    txn.set_inset_status("B", "B:1", DONE, require_rows=True)
    txn.commit()
    acked = store.fetch_ack_events("B")
    assert [(e.event_id, ins) for e, ins, _ in acked] == [(1, "B:2")]


@pytest.mark.parametrize("spec", ALL_STACKS)
def test_reassign_skips_done_events(spec, tmp_path):
    """Alg 13 mutual exclusion: reassignment applies only to still-undone."""
    store = _mk(spec, tmp_path)
    txn = store.begin()
    txn.log_event(_ev(0), UNDONE)
    txn.log_event(_ev(1), UNDONE)
    txn.commit()
    txn = store.begin()
    txn.set_status(("A", "out", 0), DONE)
    txn.commit()
    txn = store.begin()
    txn.reassign_event(("A", "out", 0), "B", ("A", "to_C", 0), "C", "in")
    txn.reassign_event(("A", "out", 1), "B", ("A", "to_C", 1), "C", "in")
    txn.commit()
    assert store.event_status(("A", "out", 0)) == [(None, DONE)]
    assert store.event_status(("A", "out", 1)) == []
    assert store.event_status(("A", "to_C", 1)) == [(None, UNDONE)]
    assert store.consumers_of(("A", "to_C", 1)) == ["C"]


@pytest.mark.parametrize("spec", ALL_STACKS)
def test_assign_insets_without_rec_op(spec, tmp_path):
    store = _mk(spec, tmp_path)
    txn = store.begin()
    txn.log_event(_ev(0), UNDONE)
    txn.commit()
    txn = store.begin()
    txn.assign_insets(("A", "out", 0), ["B:1"])
    txn.commit()
    acked = store.fetch_ack_events("B")
    assert [(e.event_id, ins) for e, ins, _ in acked] == [(0, "B:1")]


@pytest.mark.parametrize("spec", ALL_STACKS)
def test_gc_keeps_rows_while_lineage_exists(spec, tmp_path):
    store = _mk(spec, tmp_path)
    txn = store.begin()
    txn.log_event(_ev(0), UNDONE)
    txn.commit()
    txn = store.begin()
    txn.assign_insets(("A", "out", 0), ["B:1"], rec_op="B")
    txn.put_lineage(5, "A", "out", "B:1")
    txn.set_status(("A", "out", 0), DONE)
    txn.commit()
    store.gc()
    assert store.lineage_events_of_inset("B", "B:1") == [("A", "out", 0)]
    assert store.lineage_outputs_of_inset("A", "B:1") == [("A", "out", 5)]


def test_group_commit_tokens_stay_lost_after_crash():
    store = GroupCommitStore(batch_size=100, interval=60.0)
    txn = store.begin()
    txn.log_event(_ev(0), UNDONE)
    lost = txn.commit()
    store.crash()
    for i in range(3):
        txn = store.begin()
        txn.log_event(_ev(10 + i), UNDONE)
        txn.commit()
    store.flush()
    assert not store.is_durable(lost)


def test_undone_events_from():
    store = MemoryLogStore()
    txn = store.begin()
    for i in range(4):
        txn.log_event(_ev(i), UNDONE)
    txn.set_status(("A", "out", 1), DONE)
    txn.commit()
    assert store.undone_events_from("A", "B") == \
        [("A", "out", 0), ("A", "out", 2), ("A", "out", 3)]
    assert store.undone_events_from("A", "X") == []


def test_sqlite_durability(tmp_path):
    path = os.path.join(tmp_path, "log.db")
    store = SqliteLogStore(path)
    txn = store.begin()
    for i in range(4):
        txn.log_event(_ev(i), UNDONE)
        txn.put_event_data(_ev(i))
    txn.put_state("A", 1, b"state-blob")
    txn.commit()
    store.close()
    store2 = SqliteLogStore(path)
    assert len(store2.event_log) == 4
    assert store2.get_state("A") == b"state-blob"
    assert [e.event_id for e, _ in store2.fetch_resend_events("A")] == \
        [0, 1, 2, 3]
    store2.close()


def test_sqlite_engine_end_to_end(tmp_path):
    build, expected = linear_pipeline(TC)
    store = SqliteLogStore(os.path.join(tmp_path, "pipeline.db"))
    eng = Engine(build(), store=store, mode="step",
                 injector=FailureInjector([("win", "post_log", 2)]))
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected
    store.close()


def _wait_durable(store, token, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not store.is_durable(token):
        assert time.monotonic() < deadline, f"token {token} never durable"
        time.sleep(0.001)


def test_group_commit_watermark_and_tokens():
    store = GroupCommitStore(batch_size=3, interval=60.0)
    tokens = []
    for i in range(3):
        txn = store.begin()
        txn.log_event(_ev(i), UNDONE)
        tokens.append(txn.commit())
    _wait_durable(store, tokens[2])
    for i in (3, 4):
        txn = store.begin()
        txn.log_event(_ev(i), UNDONE)
        tokens.append(txn.commit())
    assert not store.is_durable(tokens[4])
    assert [e.event_id for e, _ in store.fetch_resend_events("A")] == \
        [0, 1, 2, 3, 4]
    store.flush()
    assert store.is_durable(tokens[4])


def test_group_commit_crash_loses_exactly_unflushed_batch():
    store = GroupCommitStore(batch_size=3, interval=60.0)
    tokens = []
    for i in range(5):
        txn = store.begin()
        txn.log_event(_ev(i), UNDONE)
        txn.put_event_data(_ev(i))
        tokens.append(txn.commit())
        if i == 2:
            _wait_durable(store, tokens[2])
    store.crash()
    assert [e.event_id for e, _ in store.fetch_resend_events("A")] == \
        [0, 1, 2]
    txn = store.begin()
    txn.log_event(_ev(7), UNDONE)
    token = txn.commit()
    store.flush()
    assert store.is_durable(token)
    assert [e.event_id for e, _ in store.fetch_resend_events("A")] == \
        [0, 1, 2, 7]


def test_group_commit_over_sqlite(tmp_path):
    path = os.path.join(tmp_path, "g.db")
    store = GroupCommitStore(SqliteLogStore(path), batch_size=2,
                             interval=60.0)
    tokens = []
    for i in range(5):
        txn = store.begin()
        txn.log_event(_ev(i), UNDONE)
        tokens.append(txn.commit())
        if i % 2:
            _wait_durable(store, tokens[i])
    store.crash()
    assert [e.event_id for e, _ in store.fetch_resend_events("A")] == \
        [0, 1, 2, 3]
    store.close()
    store2 = GroupCommitStore(SqliteLogStore(path))
    assert [e.event_id for e, _ in store2.fetch_resend_events("A")] == \
        [0, 1, 2, 3]
    store2.close()


def test_sharded_group_crash_per_shard_watermark():
    store = build_store("memory+sharded+group", shards=3, batch_size=2,
                        interval=60.0)
    txn = store.begin()
    txn.log_event(Event(0, "A", "out", "B", "in"), UNDONE)
    txn.commit()
    txn = store.begin()
    txn.log_event(Event(1, "A", "out", "C", "in"), UNDONE)
    tok = txn.commit()
    store.flush()
    assert store.is_durable(tok)
    txn = store.begin()
    txn.log_event(Event(2, "A", "out", "B", "in"), UNDONE)
    txn.commit()
    store.crash()
    assert [e.event_id for e, _ in store.fetch_resend_events("A")] == [0, 1]


# ---------------------------------------------------------------------------
# global flush epochs (2PC)
# ---------------------------------------------------------------------------

def _epoch_prepare_only(store, events):
    for ev in events:
        txn = store.begin()
        txn.log_event(ev, UNDONE)
        txn.put_event_data(ev)
        txn.commit()
    eid = store.epoch_coord.next_epoch()
    with store._epoch_barrier.write():
        cut = [(s, s.cut_pending(eid)) for s in store._group_shards]
    for s, batch in cut:
        if batch:
            s.persist_prepared(eid)
    return eid


@pytest.mark.parametrize("base", ["memory", "sqlite", "segment"])
def test_epoch_crash_between_prepare_and_commit(base, tmp_path):
    store = mk_store(TC, f"{base}+sharded+group", tmp_path, shards=3,
                     batch_size=100, interval=60.0)
    for ev in [_ev(i) for i in range(4)]:
        txn = store.begin()
        txn.log_event(ev, UNDONE)
        txn.put_event_data(ev)
        txn.commit()
    store.flush()
    lost = [Event(10, "A", "out", "B", "in"), Event(11, "A", "out", "C", "in"),
            Event(12, "A", "out", "D", "in")]
    _epoch_prepare_only(store, lost)
    store.crash()
    got = sorted(e.event_id for e, _ in store.fetch_resend_events("A"))
    assert got == [0, 1, 2, 3], got


@pytest.mark.parametrize("base", ["sqlite", "segment"])
def test_epoch_crash_after_commit_record_is_durable(base, tmp_path):
    spec = f"{base}+sharded+group"
    path = os.path.join(tmp_path, "log")
    kw = dict(shards=3, batch_size=100, interval=60.0, path=path)
    store = mk_store(TC, spec, **kw)
    evs = [Event(i, "A", "out", r, "in")
           for i, r in enumerate(["B", "C", "D"])]
    eid = _epoch_prepare_only(store, evs)
    store.epoch_coord.commit_epoch(eid)
    store.close()
    store2 = mk_store(TC, spec, **kw)
    got = sorted(e.event_id for e, _ in store2.fetch_resend_events("A"))
    assert got == [0, 1, 2], got
    store2.close()


@pytest.mark.parametrize("base", ["sqlite", "segment"])
def test_epoch_restart_rolls_back_uncommitted_epoch(base, tmp_path):
    spec = f"{base}+sharded+group"
    path = os.path.join(tmp_path, "log")
    kw = dict(shards=3, batch_size=100, interval=60.0, path=path)
    store = mk_store(TC, spec, **kw)
    for ev in [_ev(i) for i in range(3)]:
        txn = store.begin()
        txn.log_event(ev, UNDONE)
        txn.commit()
    store.flush()
    _epoch_prepare_only(store, [Event(7, "A", "out", "B", "in"),
                                Event(8, "A", "out", "C", "in")])
    for s in store.shards:
        s.inner.close()
    store.epoch_coord.close()
    store2 = mk_store(TC, spec, **kw)
    got = sorted(e.event_id for e, _ in store2.fetch_resend_events("A"))
    assert got == [0, 1, 2], got
    store2.close()


def test_epoch_flush_does_not_block_commits():
    store = build_store("memory+sharded+group", shards=3, batch_size=1000,
                        interval=60.0)
    for i in range(20):
        txn = store.begin()
        txn.log_event(_ev(i), UNDONE)
        txn.commit()
    stop = threading.Event()
    errs = []

    def committer():
        i = 100
        while not stop.is_set():
            txn = store.begin()
            txn.log_event(_ev(i), UNDONE)
            try:
                txn.commit()
            except Exception as exc:   # noqa: BLE001 - surfaced to assert
                errs.append(exc)
                return
            i += 1

    t = threading.Thread(target=committer)
    t.start()
    for _ in range(30):
        store.flush()
    stop.set()
    t.join()
    assert not errs
    store.flush()
    assert len(store.fetch_resend_events("A")) >= 20
    assert store.epochs_flushed >= 1


# ---------------------------------------------------------------------------
# segment store (tests/test_segment_store.py)
# ---------------------------------------------------------------------------

def _fill(store, n, start=0):
    for i in range(start, start + n):
        txn = store.begin()
        ev = Event(i, "A", "out", "B", "in", body={"v": i})
        txn.log_event(ev, UNDONE)
        txn.put_event_data(ev)
        txn.commit()


def _mark_done(store, ids):
    txn = store.begin()
    for i in ids:
        txn.set_status(("A", "out", i), DONE)
    txn.commit()


def test_rotation_seals_and_compresses(tmp_path):
    path = str(tmp_path / "segs")
    store = SegmentLogStore(path, segment_bytes=2048)
    _fill(store, 60)
    assert store.rotations > 0
    store.close()
    assert [f for f in os.listdir(path) if f.endswith(".logz")]
    assert len([f for f in os.listdir(path) if f.endswith(".log")]) == 1
    store2 = SegmentLogStore(path)
    assert store2.recovery_replay_count() == 60
    assert store2.last_sent_ssn("A") == {"out": 59}
    assert [e.body for e, _ in store2.fetch_resend_events("A")] == \
        [{"v": i} for i in range(60)]
    store2.close()


def test_torn_tail_frame_is_dropped(tmp_path):
    path = str(tmp_path / "segs")
    store = SegmentLogStore(path, segment_bytes=1 << 20)
    _fill(store, 10)
    active = [f for f in os.listdir(path) if f.endswith(".log")][0]
    store.close()
    with open(os.path.join(path, active), "ab") as f:
        f.write(b"\xff\x00\x00\x00garbage-partial-frame")
    store2 = SegmentLogStore(path)
    assert store2.recovery_replay_count() == 10
    assert store2.last_sent_ssn("A") == {"out": 9}
    store2.close()


def test_warm_restart_replays_at_most_checkpoint_interval(tmp_path):
    K = 20
    path = str(tmp_path / "segs")
    store = SegmentLogStore(path, segment_bytes=8192, checkpoint_interval=K)
    for i in range(300):
        _fill(store, 1, start=i)
        _mark_done(store, [i])
        store.maybe_checkpoint()
    assert store.compactions > 0
    store.close()
    store2 = SegmentLogStore(path, checkpoint_interval=K)
    assert store2.recovery_replay_count() <= K
    assert store2.last_sent_ssn("A") == {"out": 299}
    store2.close()


def test_disk_stays_bounded_under_done_traffic(tmp_path):
    path = str(tmp_path / "segs")
    store = SegmentLogStore(path, segment_bytes=4096, checkpoint_interval=50)
    peak = 0
    for i in range(400):
        _fill(store, 1, start=i)
        _mark_done(store, [i])
        store.maybe_checkpoint()
        peak = max(peak, store.disk_bytes())
    assert store.bytes_written > 2 * peak
    assert peak < 128 * 1024
    store.close()


def test_counter_floors_survive_truncation(tmp_path):
    path = str(tmp_path / "segs")
    store = SegmentLogStore(path)
    _fill(store, 10)
    txn = store.begin()
    for i in range(10):
        txn.assign_insets(("A", "out", i), ["B:1"], rec_op="B")
    txn.commit()
    _mark_done(store, range(10))
    store.compact()
    assert store.last_sent_ssn("A") == {"out": 9}
    assert store.last_acked("B") == {"in": 9}
    store.close()
    store2 = SegmentLogStore(path)
    assert store2.recovery_replay_count() == 0
    assert store2.last_sent_ssn("A") == {"out": 9}
    assert store2.last_acked("B") == {"in": 9}
    store2.close()


def test_gc_protect_keeps_replay_feeding_payloads(tmp_path):
    path = str(tmp_path / "segs")
    store = SegmentLogStore(path)
    store.set_gc_protect({"A"})
    _fill(store, 5)
    _mark_done(store, range(5))
    store.compact()
    assert store.event_status(("A", "out", 3)) == [(None, DONE)]
    store.close()
    store2 = SegmentLogStore(path)
    store2.set_gc_protect({"A"})
    txn = store2.begin()
    txn.set_status(("A", "out", 3), UNDONE)
    txn.commit()
    assert [(e.event_id, e.body) for e, _ in store2.fetch_resend_events("A")] \
        == [(3, {"v": 3})]
    store2.close()


_CHILD = r"""
import os, signal, sys
from repro_torch.core.events import DONE, UNDONE, Event
from repro_torch.core.logstore.segment import SegmentLogStore

path, stage = sys.argv[1], sys.argv[2]
store = SegmentLogStore(path, segment_bytes=2048)
for i in range(40):
    txn = store.begin()
    ev = Event(i, "A", "out", "B", "in", body={"v": i})
    txn.log_event(ev, UNDONE)
    txn.put_event_data(ev)
    txn.commit()
txn = store.begin()
for i in range(20):
    txn.set_status(("A", "out", i), DONE, rec_op=None)
txn.commit()
def hook(s):
    if s == stage:
        os.kill(os.getpid(), signal.SIGKILL)
store.test_hook = hook
store.compact()
print("SURVIVED", flush=True)
"""


def _env():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(root, "src"), root]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


@pytest.mark.parametrize("stage", ["compact:pre_swap", "compact:post_swap"])
def test_kill9_mid_compaction_never_tears_the_store(stage, tmp_path):
    path = str(tmp_path / "segs")
    proc = subprocess.run([sys.executable, "-c", _CHILD, path, stage],
                          env=_env(), capture_output=True, timeout=60)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
    with open(os.path.join(path, "index.json")) as f:
        idx = json.load(f)
    for name in idx["segments"] + ([idx["checkpoint"]] if idx["checkpoint"]
                                   else []):
        assert os.path.exists(os.path.join(path, name)), name
    store = SegmentLogStore(path)
    assert store.last_sent_ssn("A") == {"out": 39}
    resend = {e.event_id: e.body for e, _ in store.fetch_resend_events("A")}
    assert resend == {i: {"v": i} for i in range(20, 40)}
    if stage == "compact:pre_swap":
        assert store.event_status(("A", "out", 5)) == [(None, DONE)]
        assert store.recovery_replay_count() == 41
    else:
        assert store.event_status(("A", "out", 5)) == []
        assert store.recovery_replay_count() == 0
    store.close()


_CHILD_ROTATE = r"""
import os, signal, sys
from repro_torch.core.events import UNDONE, Event
from repro_torch.core.logstore.segment import SegmentLogStore

path = sys.argv[1]
store = SegmentLogStore(path, segment_bytes=2048)
def hook(s):
    if s == "rotate:pre_index":
        os.kill(os.getpid(), signal.SIGKILL)
store.test_hook = hook
for i in range(200):
    txn = store.begin()
    ev = Event(i, "A", "out", "B", "in", body={"v": i})
    txn.log_event(ev, UNDONE)
    txn.put_event_data(ev)
    txn.commit()
    print(i, flush=True)
"""


def test_kill9_mid_rotation_keeps_every_acked_commit(tmp_path):
    path = str(tmp_path / "segs")
    proc = subprocess.run([sys.executable, "-c", _CHILD_ROTATE, path],
                          env=_env(), capture_output=True, timeout=60)
    assert proc.returncode == -signal.SIGKILL, proc.stderr.decode()
    acked = [int(x) for x in proc.stdout.split()]
    assert acked, "child died before any commit"
    store = SegmentLogStore(path)
    assert set(acked) <= {e.event_id for e, _ in store.fetch_resend_events("A")}
    store.close()


@pytest.mark.parametrize("spec", ["segment+group", "segment+sharded+group"])
def test_kill9_whole_engine_segment_exactly_once(spec, tmp_path,
                                                 proc_transport, proc_ctx):
    from tests.test_torch_process_mode import kill9_run, resume_exactly_once
    db_path = str(tmp_path / "log.segs")
    ext_path = str(tmp_path / "external.bin")
    kill9_run(spec, db_path, ext_path, proc_transport, proc_ctx, 0.4)
    resume_exactly_once(spec, db_path, ext_path, proc_transport, proc_ctx)


# ---------------------------------------------------------------------------
# crash-point matrix (tests/test_recovery_matrix.py), every stack
# ---------------------------------------------------------------------------

POINTS = ["source_pre_log", "source_post_log", "pre_filter",
          "pre_state_update", "post_ack_log", "pre_log", "post_log",
          "post_send", "pre_write", "post_write_pre_done"]
PLANS = [
    [("map", "post_log", 2), ("win", "pre_log", 1)],
    [("src", "source_post_log", 5), ("win", "post_send", 2)],
    [("map", "pre_state_update", 1), ("map", "post_ack_log", 4),
     ("sink", "pre_write", 2)],
    [("win", "recovery_post_resend", 1), ("win", "pre_log", 1)],
]


def _matrix_store(spec, root):
    # small batches so group-commit flush boundaries interleave with crashes
    return mk_store(TC, spec, root, shards=3, batch_size=4, interval=0.001)


@pytest.mark.parametrize("spec", ALL_STACKS)
@pytest.mark.parametrize("op_id", ["src", "map", "win", "sink"])
@pytest.mark.parametrize("point", POINTS)
def test_single_failure_exactly_once(op_id, point, spec, tmp_path):
    build, expected = linear_pipeline(TC, writes=1)
    for nth in (1, 3):
        eng = Engine(build(), mode="step",
                     injector=FailureInjector([(op_id, point, nth)]),
                     store=_matrix_store(spec, tmp_path))
        assert eng.run_to_completion(), (op_id, point, nth)
        assert sink_outputs(eng) == expected, (op_id, point, nth)
        assert len(window_writes(eng)) == 5, (op_id, point, nth)


@pytest.mark.parametrize("spec", ALL_STACKS)
@pytest.mark.parametrize("plan", PLANS)
def test_multiple_failures(plan, spec, tmp_path):
    build, expected = linear_pipeline(TC)
    eng = Engine(build(), mode="step", injector=FailureInjector(plan),
                 store=_matrix_store(spec, tmp_path))
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected


REPLAY_POINTS = ["pre_filter", "pre_state_update", "post_ack_log", "pre_log",
                 "post_log", "post_send"]


@pytest.mark.parametrize("spec", ALL_STACKS)
@pytest.mark.parametrize("op_id", ["map", "win"])
@pytest.mark.parametrize("point", REPLAY_POINTS)
def test_replay_mode_exactly_once(op_id, point, spec, tmp_path):
    build, expected = linear_pipeline(TC)
    scopes = [LineageScope(("src", "out"), ("map", "out"))]
    for nth in (1, 2, 3):
        eng = Engine(build(), mode="step", lineage_scopes=scopes,
                     replay_ops={"map"},
                     injector=FailureInjector([(op_id, point, nth)]),
                     store=_matrix_store(spec, tmp_path))
        assert eng.run_to_completion(), (op_id, point, nth)
        assert sink_outputs(eng) == expected, (op_id, point, nth)


def test_replay_mode_logs_no_payloads():
    build, expected = linear_pipeline(TC)
    scopes = [LineageScope(("src", "out"), ("map", "out"))]
    eng = Engine(build(), mode="step", lineage_scopes=scopes,
                 replay_ops={"map"})
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected
    assert sum(1 for k in eng.store.event_data if k[0] == "map") == 0


@pytest.mark.parametrize("spec", GROUP_STACKS)
def test_full_process_crash_replays_to_committed_outputs(spec, tmp_path):
    """Kill the whole engine mid-run (the store loses its unflushed batch
    through crash(), the channels are gone), warm-restart a new engine on
    the recovered store and the surviving external system: the committed
    outputs equal the failure-free run, each exactly once. Only stacks with
    group commit lose data in crash(), so only they are run."""
    build, expected = linear_pipeline(TC, writes=1)
    for steps in (6, 10, 14, 22, 25, 40, 70):
        store = mk_store(TC, spec, tmp_path, shards=3, batch_size=4,
                         interval=60.0)
        eng = Engine(build(), mode="step", store=store)
        external = eng.external
        done = eng.run_to_completion(max_steps=steps)
        store.crash()
        eng2 = Engine(build(), mode="step", store=store, external=external,
                      resume=True)
        assert eng2.run_to_completion(), steps
        assert sink_outputs(eng2) == expected, (steps, done)
        assert len(window_writes(eng2)) == 5, steps


@pytest.mark.parametrize("spec", GROUP_STACKS)
def test_full_process_crash_resume_in_thread_mode(spec, tmp_path):
    build, expected = linear_pipeline(TC, writes=1)
    store = mk_store(TC, spec, tmp_path, shards=3, batch_size=4,
                     interval=60.0)
    eng = Engine(build(), mode="step", store=store)
    eng.run_to_completion(max_steps=14)
    store.crash()
    eng2 = Engine(build(), mode="thread", store=store,
                  external=eng.external, resume=True)
    eng2.start()
    assert eng2.wait(30)
    eng2.stop()
    assert sink_outputs(eng2) == expected


# ---------------------------------------------------------------------------
# parity with repro.core: outputs, counts and table rows, every stack
# ---------------------------------------------------------------------------

def _step_run(core, spec, plan, root):
    """One step-mode run with lineage capture. A segment stack behind
    group commit compacts when its flusher thread has written enough
    records, a time no step counts: so these runs compact once, after the
    run, and the rows left are a function of the run alone."""
    build, _ = linear_pipeline(core, writes=1)
    kw = {"checkpoint_interval": 0} if spec.startswith("segment") else {}
    store = mk_store(core, spec, root, shards=3, batch_size=4,
                     interval=60.0, **kw)
    eng = core.Engine(build(), mode="step", store=store,
                      injector=core.FailureInjector(plan),
                      lineage_scopes=[core.LineageScope(("src", "out"),
                                                        ("win", "out"))])
    assert eng.run_to_completion()
    store.flush()
    store.checkpoint()
    out = {"outputs": sink_outputs(eng), "writes": window_writes(eng),
           "failures": eng.failures, "restarts": eng.restarts,
           "tables": tables(store)}
    store.close()
    return out


@pytest.mark.parametrize("spec", ALL_STACKS)
@pytest.mark.parametrize("plan", [[]] + PLANS)
def test_step_runs_match_jax(spec, plan, tmp_path):
    want = _step_run(JC, spec, plan, tmp_path / "jax")
    got = _step_run(TC, spec, plan, tmp_path / "torch")
    assert got["tables"]["lineage"], "lineage capture left no rows"
    for k in ("outputs", "writes", "failures", "restarts"):
        assert got[k] == want[k], k
    for t in ("events", "insets", "data", "lineage", "reads"):
        assert got["tables"][t] == want["tables"][t], t
    assert got["outputs"] == linear_pipeline(TC)[1]
    assert got["failures"] == len(plan)


def test_build_store_builds_every_stack(tmp_path):
    """Every spec of the "all" set builds into the same class stack as
    repro.core's, and StoreConfig round-trips with its spec string."""
    def shape(store):
        kids = getattr(store, "shards", None) or [getattr(store, "inner",
                                                          None)]
        return (type(store).__name__,
                [shape(k) for k in kids if k is not None])
    for spec in ALL_STACKS:
        t = mk_store(TC, spec, tmp_path)
        j = mk_store(JC, spec, tmp_path)
        assert shape(t) == shape(j), spec
        assert str(TC.StoreConfig.parse(spec)) == spec
        t.close()
        j.close()
