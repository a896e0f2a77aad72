"""Adaptive micro-batching in the port, on the CPU: a copy of
``tests/test_batching.py`` on ``repro_torch.core`` (its mid-batch SIGKILL
and env-forced governor cases are in ``tests/test_torch_wire.py``).

* the governor units (``resolve_batching``, ``make_governor``,
  ``BatchGovernor``);
* the vectored backend ops (``log_events`` / ``set_status_many``) on every
  stack: one txn, individually keyed rows, shard splits, reopen
  durability, a group-commit batch lost whole; each store case runs the
  same txns on ``repro.core``'s stack and holds what it reads back ``==``;
* one resend scan and one ack scan a recovery (``recovery_scan_batches``,
  its step-mode counters ``==`` ``repro.core``'s);
* the batched hot path end to end in thread mode, with and without
  crashes.
"""
import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import Engine, FailureInjector, build_store  # noqa: E402
from repro_torch.core.batching import (BatchGovernor,  # noqa: E402
                                       make_governor, resolve_batching)
from repro_torch.core.events import DONE, REPLAY, UNDONE  # noqa: E402
from tests.torch_core_helpers import (linear_pipeline, mk_store,  # noqa: E402
                                      sink_outputs)


# ---------------------------------------------------------------------------
# governor units
# ---------------------------------------------------------------------------

def test_resolve_batching_specs():
    assert resolve_batching("off") == "off"
    assert resolve_batching("adaptive") == "adaptive"
    assert resolve_batching(16) == 16
    assert resolve_batching("16") == 16
    with pytest.raises(ValueError):
        resolve_batching(0)
    with pytest.raises(ValueError):
        resolve_batching(True)
    with pytest.raises(ValueError):
        resolve_batching("junk")


def test_resolve_batching_env(monkeypatch):
    monkeypatch.delenv("LOGIO_BATCH", raising=False)
    assert resolve_batching(None) == "off"
    monkeypatch.setenv("LOGIO_BATCH", "adaptive")
    assert resolve_batching(None) == "adaptive"
    monkeypatch.setenv("LOGIO_BATCH", "8")
    assert resolve_batching(None) == 8
    # an explicit spec wins over the environment
    assert resolve_batching("off") == "off"


def test_make_governor_off_is_none():
    assert make_governor("off") is None
    assert make_governor(1) is None
    assert make_governor("adaptive") is not None
    assert make_governor(4) is not None


def test_governor_degenerates_to_one_when_idle():
    """The moderate-rate regime: one queued event at a time -> batch=1,
    the scalar path, unchanged latency."""
    gov = BatchGovernor("adaptive")
    assert gov.limit(0) == 1
    assert gov.limit(1) == 1
    gov = BatchGovernor(32)
    assert gov.limit(1) == 1


def test_governor_fixed_mode_caps_at_spec():
    gov = BatchGovernor(8)
    assert gov.limit(100) == 8
    assert gov.limit(5) == 5


def test_governor_adaptive_respects_latency_bound():
    gov = BatchGovernor("adaptive", max_batch=1000, latency_bound=0.010)
    # teach it events cost ~1ms each: a run must stay under ~10 events
    for _ in range(50):
        gov.observe(10, 0.010)
    assert gov.limit(1000) <= 12
    # cheap events: the cap opens up to max_batch
    for _ in range(200):
        gov.observe(100, 0.0001)
    assert gov.limit(1000) == 1000
    s = gov.stats()
    assert s["mode"] == "adaptive" and s["ev_cost"] > 0


# ---------------------------------------------------------------------------
# vectored backend ops: one txn, individually keyed rows, on every stack
# ---------------------------------------------------------------------------

BATCH_SPECS = ["memory", "memory+sharded", "memory+group",
               "memory+sharded+group", "sqlite", "sqlite+group",
               "segment", "segment+group", "sqlite+sharded+group"]


def _ev(core, i, port="out"):
    return core.Event(i, "A", port, "B", "in")


def _mk(core, spec, root, **kw):
    return mk_store(core, spec, root, shards=3, batch_size=4,
                    interval=0.001, **kw)


def _resend_ids(store, op):
    return [e.event_id for e, _ in store.fetch_resend_events(op)]


def _keyed(core, spec, root):
    store = _mk(core, spec, root)
    txn = store.begin()
    txn.log_events([(_ev(core, i), UNDONE, None) for i in range(5)])
    txn.commit()
    store.flush()
    before = _resend_ids(store, "A")
    # each row is independently addressable — flip two of them
    txn = store.begin()
    txn.set_status_many([(("A", "out", 1), DONE, None, None, None),
                         (("A", "out", 3), DONE, None, None, None)])
    txn.commit()
    store.flush()
    return before, _resend_ids(store, "A")


@pytest.mark.parametrize("spec", BATCH_SPECS)
def test_log_events_rows_individually_keyed(spec, tmp_path):
    before, after = _keyed(TC, spec, tmp_path / "port")
    assert before == [0, 1, 2, 3, 4]
    assert after == [0, 2, 4]
    assert (before, after) == _keyed(JC, spec, tmp_path / "jax")


def _guarded(core, spec, root):
    store = _mk(core, spec, root)
    txn = store.begin()
    txn.log_events([(_ev(core, i), UNDONE, None) for i in range(3)])
    txn.commit()
    txn = store.begin()
    txn.set_status(("A", "out", 0), DONE)
    txn.commit()
    txn = store.begin()
    txn.set_status_many([(("A", "out", i), REPLAY, "*", None, UNDONE)
                         for i in range(3)])
    txn.commit()
    store.flush()
    return [store.event_status(("A", "out", i)) for i in range(3)]


@pytest.mark.parametrize("spec", BATCH_SPECS)
def test_set_status_many_only_status_guard(spec, tmp_path):
    """The conditional form (only_status) must hold per entry: DONE rows
    keep DONE when a replay flip targets still-UNDONE rows."""
    got = _guarded(TC, spec, tmp_path / "port")
    assert got == [[(None, DONE)], [(None, REPLAY)], [(None, REPLAY)]]
    assert got == _guarded(JC, spec, tmp_path / "jax")


def _split(core, spec, root):
    store = _mk(core, spec, root)
    txn = store.begin()
    recs = []
    for i in range(6):
        e = core.Event(i, f"OP{i % 3}", "out", f"OP{(i + 1) % 3}", "in")
        recs.append((e, UNDONE, None))
    txn.log_events(recs)
    txn.commit()
    store.flush()
    return [_resend_ids(store, f"OP{i}") for i in range(3)]


@pytest.mark.parametrize("spec", ["memory+sharded", "memory+sharded+group",
                                  "sqlite+sharded+group"])
def test_log_events_split_across_shards(spec, tmp_path):
    """A run whose records home to different shards must land each record
    exactly once, queryable from both the sender and receiver views."""
    got = _split(TC, spec, tmp_path / "port")
    assert got == [[i, i + 3] for i in range(3)]
    assert got == _split(JC, spec, tmp_path / "jax")


def _reopened(core, spec, path):
    store = _mk(core, spec, None, path=path)
    txn = store.begin()
    txn.log_events([(_ev(core, i), UNDONE, None) for i in range(4)])
    txn.commit()
    txn = store.begin()
    txn.set_status_many([(("A", "out", 0), DONE, None, None, None)])
    txn.commit()
    store.flush()
    store.close()
    reopened = _mk(core, spec, None, path=path)
    return (_resend_ids(reopened, "A"),
            reopened.event_status(("A", "out", 0)))


@pytest.mark.parametrize("spec", ["sqlite", "sqlite+group",
                                  "segment", "segment+group"])
def test_batched_rows_survive_reopen(spec, tmp_path):
    """Crash/reopen: rows written through one vectored txn replay from
    disk (sqlite WAL / segment frames) as individually keyed records."""
    ext = "db" if spec.startswith("sqlite") else "segs"
    got = _reopened(TC, spec, str(tmp_path / f"log.{ext}"))
    assert got == ([1, 2, 3], [(None, DONE)])
    assert got == _reopened(JC, spec, str(tmp_path / f"jax.{ext}"))


def test_group_commit_batch_lost_before_flush():
    """A vectored log txn lost in a crash before its flush loses the WHOLE
    run atomically — no partial batch becomes durable."""
    store = build_store("memory+group", batch_size=100, interval=60.0)
    txn = store.begin()
    txn.log_events([(_ev(TC, i), UNDONE, None) for i in range(5)])
    token = txn.commit()
    store.crash()
    assert not store.is_durable(token)
    assert store.fetch_resend_events("A") == []


# ---------------------------------------------------------------------------
# batched recovery read path (one range scan per operator)
# ---------------------------------------------------------------------------

def _scan_counts(core, spec, root):
    build, expected = linear_pipeline(core, writes=1)
    inj = core.FailureInjector([("win", "post_ack_log", 2)])
    eng = core.Engine(build(), mode="step", injector=inj,
                      store=_mk(core, spec, root))
    assert eng.run_to_completion()
    assert sink_outputs(eng) == expected
    m = eng.metrics()
    return {op: (s.recovered_inputs, s.recovered_resends,
                 s.recovery_scan_batches) for op, s in m.ops.items()}


def test_recovery_scan_batches_counter(store_spec, tmp_path):
    """Each recovery performs exactly one resend scan + one ack-events
    scan — never per-event round trips."""
    counts = _scan_counts(TC, store_spec, tmp_path / "port")
    assert counts["win"][0] > 0
    assert counts["win"][2] == 2          # one resend + one ack scan
    for op, c in counts.items():
        if op != "win":
            assert c[2] == 0
    assert counts == _scan_counts(JC, store_spec, tmp_path / "jax")


# ---------------------------------------------------------------------------
# batched hot path end-to-end (thread mode, governor forced on)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batching", ["adaptive", 16])
def test_batched_pipeline_exactly_once(batching, store_spec, tmp_path):
    build, expected = linear_pipeline(TC, n_events=64, window=4,
                                      sink_target=16)
    eng = Engine(build(), mode="thread", store=_mk(TC, store_spec, tmp_path),
                 batching=batching)
    eng.start()
    assert eng.wait(30)
    eng.stop()
    assert sink_outputs(eng) == expected
    ops = eng.metrics().ops
    # saturation (rate=0): the governed operators actually formed runs
    assert any(s.batched_events > 0 for s in ops.values()), ops


def test_batched_pipeline_with_crash_thread_mode(store_spec, tmp_path):
    build, expected = linear_pipeline(TC, n_events=64, window=4,
                                      sink_target=16, writes=1)
    inj = FailureInjector([("map", "pre_state_update", 5),
                           ("win", "post_ack_log", 3)])
    eng = Engine(build(), mode="thread", store=_mk(TC, store_spec, tmp_path),
                 injector=inj, batching="adaptive", restart_delay=0.01)
    eng.start()
    assert eng.wait(30)
    eng.stop()
    assert sink_outputs(eng) == expected
