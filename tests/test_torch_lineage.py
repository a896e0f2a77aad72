"""The port's lineage queries, the deprecated query shims, partial replay
and the Protocol API, on the CPU.

* copies of the in-process cases of ``tests/test_lineage_query.py``,
  ``tests/test_lineage_units.py`` and ``tests/test_paper_api.py`` on
  ``repro_torch.core``; the store-matrix cases run over all ten stacks of
  the ``"all"`` set;
* parity with ``repro.core``: one step-mode run per stack through both
  packages from the same inputs gives the same ``LineageQuery`` backward,
  forward and slice results, the same ``ReplayReport``s, the same shim
  answers and the same outputs of an operator written against
  ``LogioAPI`` (``==``).

Not copied: replay in process mode (``Engine.replay(mode="process")``) and
its ``kill -9`` inside the replay run; process mode is not ported yet. A
thread-mode crash inside the replay run takes the latter's place.
"""
import dataclasses
import json
import threading
import time
from functools import partial

import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import (Engine, EventKey, FailureInjector,  # noqa: E402
                              GeneratorSource, LineageFilter, LineageQuery,
                              LineageScope, MapOperator, MemoryLogStore,
                              Pipeline, ReadSource, SyncJoinOperator,
                              TerminalSink, enabled_ports)
from repro_torch.core.api import LogioAPI, LogioTransaction  # noqa: E402
from repro_torch.core.events import UNDONE, Event  # noqa: E402
from repro_torch.core.lineage import _paths  # noqa: E402
from repro_torch.core.logstore import StoreConfig, build_store  # noqa: E402
from repro_torch.core.logstore.segment import (SegmentLogStore,  # noqa: E402
                                               _read_frames)
from repro_torch.core.replay import ReplayMismatch  # noqa: E402
from tests.torch_core_helpers import (ALL_STACKS, diamond_pipeline,  # noqa: E402
                                      linear_pipeline, mk_store, plain)

SEGMENT_STACKS = [s for s in ALL_STACKS if s.startswith("segment")]


def _protect(store, spec, ops):
    """A segment stack compacts every 25 records (``mk_store``) and drops
    the payloads of done events: a store meant for replay keeps its slice
    operators' payloads (``gc_protect``) from the start."""
    if spec.startswith("segment"):
        store.set_gc_protect(frozenset(ops))
    return store


def _run_linear(spec="memory", n_events=20, window=4, sink_target=5,
                mode="thread", store=None, root=None, core=TC):
    build, _ = linear_pipeline(core, n_events=n_events, window=window,
                               sink_target=sink_target)
    if store is None:
        store = _protect(mk_store(core, spec, root), spec,
                         {"src", "map", "win"})
    eng = core.Engine(build(), store=store, mode=mode,
                      lineage_scopes=[core.LineageScope(("src", "out"),
                                                        ("win", "out"))])
    if mode == "step":
        assert eng.run_to_completion()
    else:
        eng.start()
        assert eng.wait(60)
        eng.stop()
    return eng


def _run_diamond(spec="memory", mode="thread", sink_target=4, root=None,
                 core=TC):
    build, _ = diamond_pipeline(core, n_events=30, n1=6, n2=3,
                                sink_target=sink_target)
    store = _protect(mk_store(core, spec, root), spec,
                     {"src", "fast", "slow", "join"})
    eng = core.Engine(build(), store=store, mode=mode,
                      lineage_scopes=[core.LineageScope(("src", "out"),
                                                        ("join", "out"))])
    if mode == "step":
        assert eng.run_to_completion()
    else:
        eng.start()
        assert eng.wait(60)
        eng.stop()
    return eng


# ---------------------------------------------------------------------------
# typed surface validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw,match", [
    (dict(op="", port="out", ssn=0), "non-empty operator id"),
    (dict(op=3, port="out", ssn=0), "non-empty operator id"),
    (dict(op="a", port="", ssn=0), "non-empty port name"),
    (dict(op="a", port="out", ssn=-1), "non-negative int"),
    (dict(op="a", port="out", ssn=1.5), "non-negative int"),
    (dict(op="a", port="out", ssn=True), "non-negative int"),
])
def test_event_key_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        EventKey(**kw)


def test_event_key_coerce():
    k = EventKey("a", "out", 3)
    assert EventKey.coerce(k) is k
    assert EventKey.coerce(("a", "out", 3)) == k
    assert EventKey.coerce(["a", "out", 3]) == k
    assert k.astuple() == ("a", "out", 3)
    with pytest.raises(ValueError, match="3-tuple|must be"):
        EventKey.coerce(("a", "out"))
    with pytest.raises(ValueError, match="EventKey or"):
        EventKey.coerce("a.out.3")


@pytest.mark.parametrize("kw,match", [
    (dict(ops=42), "ops"),
    (dict(ports=7), "ports"),
    (dict(ssn_min="x"), "ssn_min"),
    (dict(epoch_max=1.5), "epoch_max"),
    (dict(ssn_min=5, ssn_max=2), "ssn range is empty"),
])
def test_lineage_filter_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        LineageFilter(**kw)


def test_lineage_filter_matches():
    flt = LineageFilter(ops="a", ports=["out", "aux"], ssn_min=2, ssn_max=5)
    assert flt.ops == frozenset({"a"})
    assert flt.matches("a", "out", 2) and flt.matches("a", "aux", 5)
    assert not flt.matches("b", "out", 3)
    assert not flt.matches("a", "in", 3)
    assert not flt.matches("a", "out", 6)
    assert LineageFilter(epoch_min=99).matches("a", "out", 0)


@pytest.mark.parametrize("kw,match", [
    (dict(start=("a",), target=("b", "out")), "pair of"),
    (dict(start=("a", ""), target=("b", "out")), "pair of"),
    (dict(start="a.out", target=("b", "out")), "pair of"),
])
def test_lineage_scope_rejects(kw, match):
    with pytest.raises(ValueError, match=match):
        LineageScope(**kw)


def test_query_arg_validation():
    with pytest.raises(ValueError, match="LogBackend"):
        LineageQuery(42)
    q = LineageQuery(MemoryLogStore())
    with pytest.raises(ValueError, match="depth"):
        q.backward(("a", "out", 0), depth=0)
    with pytest.raises(ValueError, match="limit"):
        q.backward(("a", "out", 0), limit=-1)
    with pytest.raises(ValueError, match="rec_op"):
        q.forward(("a", "out", 0), "")
    with pytest.raises(ValueError, match="at least one target"):
        q.slice([])


# ---------------------------------------------------------------------------
# pushdown parity + bounded results, every stack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ALL_STACKS)
def test_query_parity_and_limits_across_backends(spec, tmp_path):
    eng = _run_linear(spec, root=tmp_path)
    qs = {pd: LineageQuery(eng.store, pushdown=pd) for pd in (True, False)}
    key = ("win", "out", 1)
    flt = LineageFilter(ops={"src", "map"}, ssn_min=4, ssn_max=6)
    for query in (
            lambda q: q.backward(key),
            lambda q: q.backward(key, where=flt),
            lambda q: q.backward(key, where=LineageFilter(ports={"out"})),
            lambda q: q.forward(("src", "out", 5), "map"),
            lambda q: q.forward(("src", "out", 5), "map",
                                where=LineageFilter(ops={"map", "win"})),
    ):
        on, off = query(qs[True]), query(qs[False])
        assert sorted(on.keys()) == sorted(off.keys()), spec
        assert on.truncated == off.truncated is False
    assert sorted(qs[True].backward(key, where=flt).keys()) == \
        [("map", "out", 4), ("map", "out", 5), ("map", "out", 6),
         ("src", "out", 4), ("src", "out", 5), ("src", "out", 6)]
    s_on, s_off = qs[True].slice(key), qs[False].slice(key)
    assert sorted(s_on.events) == sorted(s_off.events)
    assert sorted(s_on.sources) == sorted(s_off.sources)
    assert (s_on.ops, s_on.edges) == (s_off.ops, s_off.edges)
    assert s_on.ops == frozenset({"map", "win"})
    assert {e.op for e in s_on.sources} == {"src"}
    assert ("src", "out", "map") in s_on.edges
    assert ("map", "out", "win") in s_on.edges
    full = qs[True].backward(key)
    capped = qs[True].backward(key, limit=2)
    assert len(capped) == 2 and capped.truncated
    assert list(capped)[:2] == list(full)[:2]
    assert qs[True].backward(key, depth=1).truncated
    assert not full.truncated


def test_forward_matches_backward_closure():
    eng = _run_linear()
    q = LineageQuery(eng.store)
    assert EventKey("win", "out", 0) in list(q.forward(("src", "out", 2),
                                                       "map"))
    assert EventKey("src", "out", 2) in list(q.backward(("win", "out", 0)))


def test_memory_pushdown_avoids_full_scans():
    eng = _run_linear("memory")
    store = eng.store
    key = ("win", "out", 1)
    store.reset_query_stats()
    LineageQuery(store, pushdown=False).backward(key)
    legacy = eng.metrics().store.rows_scanned
    store.reset_query_stats()
    LineageQuery(store, pushdown=True).backward(key)
    native = eng.metrics().store.rows_scanned
    assert native < legacy, (native, legacy)


def test_sqlite_filtered_query_uses_index_not_full_scan(tmp_path):
    store = build_store("sqlite", path=str(tmp_path / "log.db"))
    eng = _run_linear(store=store, n_events=40, sink_target=10)
    n_rows = len(store.conn.execute("SELECT * FROM lineage").fetchall())
    assert n_rows > 20
    store.reset_query_stats()
    assert len(store.query_lineage_insets(("win", "out", 3))) == 1
    sm = eng.metrics().store
    assert sm.rows_scanned <= 2, sm
    assert sm.rows_scanned < n_rows / 10
    store.reset_query_stats()
    rows = store.query_lineage(LineageFilter(ops={"win"}, ssn_min=0,
                                             ssn_max=3))
    assert {r[2] for r in rows} == {0, 1, 2, 3}
    assert eng.metrics().store.rows_scanned <= len(rows)


def _segments_without_lineage(path):
    """Sealed segments (those the sidecar index summarizes) that hold no
    lineage row, read from the files themselves."""
    with open(f"{path}/index.json") as f:
        idx = json.load(f)
    return [n for n in idx["segments"] if n in idx["lineage_summary"]
            and not any(op[0] == "put_lineage"
                        for _, ops in _read_frames(f"{path}/{n}")
                        for op in ops)]


def _assert_reader_skips(store, path):
    reader = store.lineage_reader()
    flt = LineageFilter(ops={"win"}, ssn_min=0, ssn_max=0)
    rows = reader.query_lineage(flt)
    assert [(r[0], r[2]) for r in rows] == [("win", 0)]
    assert reader.query_stats()["segments_skipped"] >= 1
    # an unfiltered audit scan returns every lineage row of the store and
    # skips only the sealed segments that hold none
    reader.reset_query_stats()
    all_rows = reader.query_lineage(None)
    assert all_rows == sorted(store.query_lineage(None))
    assert len(all_rows) > len(rows)
    assert reader.query_stats()["segments_skipped"] == \
        len(_segments_without_lineage(path))
    reader.reset_query_stats()
    assert len(reader.query_lineage_insets(("win", "out", 0))) == 1
    assert reader.query_stats()["segments_skipped"] >= 1


def test_segment_reader_skips_sealed_segments(tmp_path):
    path = str(tmp_path / "segs")
    store = build_store(StoreConfig(base="segment", path=path,
                                    segment_bytes=8 * 1024,
                                    checkpoint_interval=0))
    _run_linear(store=store, n_events=60, sink_target=15)
    assert len(store._segments) > 2, "need several segments for skip proof"
    _assert_reader_skips(store, path)


def test_segment_reader_skips_segments_without_lineage(tmp_path):
    """The stray skip of ``test_segment_reader_skips_sealed_segments``: in
    an engine run, a source that runs ahead of its consumer can fill whole
    segments with its event records, which carry no lineage row. Such a
    segment's summary is empty, and the unfiltered scan rightly skips it;
    it still returns every row. Built here record by record."""
    path = str(tmp_path / "segs")
    store = SegmentLogStore(path, segment_bytes=2048)
    for i in range(60):          # the source, ahead: no lineage rows
        txn = store.begin()
        ev = Event(i, "src", "out", "map", "in", body={"v": i})
        txn.log_event(ev, UNDONE)
        txn.put_event_data(ev)
        txn.commit()
    for i in range(12):          # then the consumer's lineage rows
        txn = store.begin()
        txn.put_lineage(i, "map", "out", f"map:{i}")
        txn.commit()
    rotations = store.rotations
    reader = store.lineage_reader()
    rows = reader.query_lineage(None)
    assert rows == sorted(store.query_lineage(None)) and len(rows) == 12
    empty = _segments_without_lineage(path)
    assert len(empty) >= 2 and rotations >= len(empty)
    assert reader.query_stats()["segments_skipped"] == len(empty)


# ---------------------------------------------------------------------------
# Engine.replay
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ALL_STACKS)
def test_replay_reexecutes_only_sub_dag(spec, tmp_path):
    eng = _run_linear(spec, root=tmp_path)
    rep = eng.replay(("win", "out", 1))
    assert rep.ok and rep.completed and rep.deterministic
    assert rep.executed_ops == frozenset({"map", "win"}), spec
    assert rep.matches[EventKey("win", "out", 1)] is True
    assert rep.rederived[EventKey("win", "out", 1)] == \
        {"s": sum(2 * j for j in range(4, 8))}


@pytest.mark.parametrize("spec", SEGMENT_STACKS)
def test_replay_on_a_compacting_segment_store_needs_gc_protect(spec,
                                                               tmp_path):
    """Without ``gc_protect`` a segment stack's compaction drops the done
    source payloads that replay injects: both packages refuse the replay
    with the same error (``repro.core``'s store-matrix replay case fails on
    these stacks under ``LOGIO_STORE_SPEC=all``)."""
    errors = []
    for core in (JC, TC):
        build, _ = linear_pipeline(core)
        eng = core.Engine(build(), store=mk_store(core, spec, tmp_path),
                          mode="step",
                          lineage_scopes=[core.LineageScope(("src", "out"),
                                                            ("win", "out"))])
        assert eng.run_to_completion()
        with pytest.raises(ValueError, match="no longer in EVENT_DATA") as e:
            eng.replay(("win", "out", 1))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("mode", ["thread", "step"])
def test_replay_diamond_multi_target_alignment(mode):
    eng = _run_diamond(mode=mode)
    rep = eng.replay([("join", "out", 0), ("join", "out", 2)], mode=mode)
    assert rep.ok
    assert rep.executed_ops == frozenset({"fast", "slow", "join"})
    assert all(v is True for v in rep.matches.values())
    assert len(rep.rederived) == 2


def test_replay_scope_cuts_the_walk():
    eng = _run_linear()
    rep = eng.replay(("win", "out", 1),
                     scope=LineageScope(("map", "out"), ("win", "out")))
    assert rep.ok
    assert rep.executed_ops == frozenset({"win"})
    assert {e.op for e in rep.slice.sources} == {"map"}


def test_replay_recovers_a_crash_inside_the_replay_run():
    """The replay run is itself a recoverable pipeline: a crash of a
    replayed operator restarts it and the rederived bytes still match."""
    eng = _run_linear()
    inj = FailureInjector([("map", "post_log", 2)])
    rep = eng.replay(("win", "out", 1), injector=inj)
    assert rep.ok
    assert inj.fired, "the injected crash never hit the replay run"
    assert rep.matches[EventKey("win", "out", 1)] is True


def test_replay_races_checkpoint_compaction(tmp_path):
    cfg = StoreConfig(base="segment", path=str(tmp_path / "segs"),
                      segment_bytes=8 * 1024, checkpoint_interval=0)
    eng = _run_linear(store=build_store(cfg), n_events=40, sink_target=10)
    store = eng.store
    pinned = frozenset({"src", "map", "win"})
    store.set_gc_protect(pinned)
    protect_seen = []
    orig_set = store.set_gc_protect

    def spy(ops):
        protect_seen.append(frozenset(ops))
        orig_set(ops)

    store.set_gc_protect = spy
    stop = threading.Event()

    def compactor():
        while not stop.is_set():
            store.checkpoint()
            time.sleep(0.001)

    t = threading.Thread(target=compactor, daemon=True)
    t.start()
    try:
        for _ in range(3):
            rep = eng.replay(("win", "out", 2))
            assert rep.ok
            assert rep.matches[EventKey("win", "out", 2)] is True
    finally:
        stop.set()
        t.join(timeout=10)
    assert any({"src", "map", "win"} <= c for c in protect_seen)
    assert store.gc_protect == pinned


def test_replay_errors_are_loud():
    eng = _run_linear()
    with pytest.raises(ValueError, match="no recorded lineage"):
        eng.replay(("src", "out", 0))
    with pytest.raises(ValueError, match="truncated"):
        eng.replay(("win", "out", 1), depth=1)
    with pytest.raises(ValueError, match="LineageScope"):
        eng.replay(("win", "out", 1), scope=("src", "out"))
    with pytest.raises(ValueError, match="EventKey or"):
        eng.replay("win.out.1")


def test_replay_mismatch_is_a_value_error():
    assert issubclass(ReplayMismatch, ValueError)


# ---------------------------------------------------------------------------
# path enumeration and capture ports (tests/test_lineage_units.py)
# ---------------------------------------------------------------------------

def _graph(connections):
    p = Pipeline()
    p.connections = [c + (64,) for c in connections]
    return p


DIAMOND = _graph([
    ("src", "out", "fast", "in"),
    ("src", "out", "slow", "in"),
    ("fast", "out", "join", "in1"),
    ("slow", "out", "join", "in2"),
    ("join", "out", "sink", "in"),
])


def test_paths_diamond_enumerates_each_branch_once():
    paths = _paths(DIAMOND, ("src", "out"), ("join", "out"))
    assert len(paths) == 2
    assert len({tuple(p) for p in paths}) == 2
    assert {p[1][0] for p in paths} == {"fast", "slow"}
    for p in paths:
        assert p[0] == ("src", "out") and p[-1] == ("join", "out")


def test_paths_terminal_target_output_port():
    g = _graph([
        ("s", "out", "a", "in"), ("s", "out", "b", "in"),
        ("a", "out", "j", "i1"), ("b", "out", "j", "i2"),
        ("j", "out", "c", "in"), ("j", "out", "d", "in"),
        ("c", "out", "k", "i1"), ("d", "out", "k", "i2"),
    ])
    paths = _paths(g, ("s", "out"), ("k", "out"))
    assert len(paths) == 4
    assert len({tuple(p) for p in paths}) == 4
    ports = enabled_ports(g, [LineageScope(("s", "out"), ("k", "out"))])
    assert ports["j"] == ({"i1", "i2"}, {"out"})
    assert ports["k"] == ({"i1", "i2"}, {"out"})
    assert ports["s"] == (set(), {"out"})


def test_paths_reconvergent_fanout_distinct_ports():
    g = _graph([
        ("src", "out", "x", "in"), ("x", "o1", "y", "a"),
        ("x", "o2", "y", "b"), ("y", "out", "z", "in"),
    ])
    paths = _paths(g, ("src", "out"), ("y", "out"))
    assert len(paths) == 2
    assert {p[2] for p in paths} == {("x", "o1"), ("x", "o2")}


def test_paths_cycle_terminates_without_duplicates():
    g = _graph([
        ("s", "out", "x", "in"), ("x", "out", "y", "in"),
        ("y", "out", "x", "fb"), ("y", "out", "t", "in"),
    ])
    paths = _paths(g, ("s", "out"), ("t", "in"))
    assert len(paths) == 1
    assert len({tuple(p) for p in paths}) == 1


def test_paths_wide_diamond_cascade_scales():
    conns, prev = [], ("src", "out")
    for i in range(6):
        for w in range(5):
            b = f"d{i}b{w}"
            conns.append((prev[0], prev[1], b, "in"))
            conns.append((b, "out", f"j{i}", f"in{w}"))
        prev = (f"j{i}", "out")
    g = _graph(conns)
    t0 = time.time()
    paths = _paths(g, ("src", "out"), prev)
    elapsed = time.time() - t0
    assert len(paths) == 5 ** 6
    assert len({tuple(p) for p in paths}) == 5 ** 6
    assert elapsed < 20.0, f"path walk took {elapsed:.1f}s"
    ports = enabled_ports(g, [LineageScope(("src", "out"), prev)])
    assert ports["d0b0"] == ({"in"}, {"out"})
    assert ports["j5"] == ({f"in{w}" for w in range(5)}, {"out"})


def test_enabled_ports_diamond_covers_both_branches():
    ports = enabled_ports(
        DIAMOND, [LineageScope(("src", "out"), ("join", "out"))])
    assert ports["fast"] == ({"in"}, {"out"})
    assert ports["slow"] == ({"in"}, {"out"})
    assert ports["join"] == ({"in1", "in2"}, {"out"})
    assert ports["src"] == (set(), {"out"})
    assert "sink" not in ports


def test_enabled_ports_multi_scope_union():
    g = _graph([("s", "out", "a", "in"), ("a", "out", "b", "in"),
                ("b", "out", "c", "in")])
    ports = enabled_ports(g, [LineageScope(("s", "out"), ("a", "out")),
                              LineageScope(("a", "out"), ("c", "out"))])
    assert ports["a"] == ({"in"}, {"out"})
    assert ports["b"] == ({"in"}, {"out"})
    assert ports["c"] == ({"in"}, {"out"})
    assert ports["s"] == (set(), {"out"})


def test_enabled_ports_scope_start_equals_target():
    g = _graph([("s", "out", "a", "in")])
    ports = enabled_ports(g, [LineageScope(("s", "out"), ("s", "out"))])
    assert ports["s"] == (set(), {"out"})


def test_diamond_lineage_queries_end_to_end():
    build, _ = diamond_pipeline(TC, n_events=12, n1=6, n2=3, sink_target=2)
    eng = Engine(build(), mode="step", lineage_scopes=[
        LineageScope(("src", "out"), ("join", "out"))])
    eng.start()
    assert eng.run_to_completion()
    eng.stop()
    q = LineageQuery(eng.store)
    ops = {c[0] for c in q.backward(("join", "out", 0)).keys()}
    assert {"fast", "slow", "src"} <= ops
    assert any(k.op == "join" for k in q.forward(("src", "out", 0), "fast"))


def _ident(b):
    return b


def _join_len(a, b):
    return len(a) + len(b)


def test_multi_scope_diamond_engine_capture():
    p = Pipeline()
    p.add(partial(GeneratorSource, "src",
                  ReadSource([{"v": i} for i in range(8)])))
    p.add(partial(MapOperator, "fast", fn=_ident))
    p.add(partial(MapOperator, "slow", fn=_ident))
    p.add(partial(SyncJoinOperator, "join", 4, 4, agg=_join_len))
    p.add(partial(TerminalSink, "sink", target=2))
    p.connect("src", "out", "fast", "in")
    p.connect("src", "out", "slow", "in")
    p.connect("fast", "out", "join", "in1")
    p.connect("slow", "out", "join", "in2")
    p.connect("join", "out", "sink", "in")
    fast_only = enabled_ports(
        p, [LineageScope(("fast", "out"), ("join", "out"))])
    assert "slow" not in fast_only
    assert fast_only["join"] == ({"in1"}, {"out"})
    both = enabled_ports(
        p, [LineageScope(("fast", "out"), ("join", "out")),
            LineageScope(("slow", "out"), ("join", "out"))])
    assert both["join"] == ({"in1", "in2"}, {"out"})


# ---------------------------------------------------------------------------
# the Protocol API (tests/test_paper_api.py)
# ---------------------------------------------------------------------------

def _listing_operator(core):
    """A Middle operator written against ``core``'s LogioAPI (Listing 2
    shape): accumulates 3 events and emits their sum."""
    from importlib import import_module
    api = import_module(core.__name__ + ".api")

    class ListingStyleOperator(core.Operator):
        def __init__(self, op_id):
            super().__init__(op_id)
            self.count = 0
            self.windows = {}

        @property
        def logio(self):
            return api.LogioAPI(self.runtime)

        def update_global(self, event):
            self.count += 1
            self.logio.UpdateContext(event)

        def global_state(self):
            return {"count": self.count}

        def restore_global(self, blob):
            if blob:
                self.count = blob["count"]

        def on_event(self, event, *, recovery_inset=None):
            if recovery_inset is None:
                assert self.logio.CheckEvent(event)
            inset = recovery_inset or f"{self.id}:w{(self.count - 1) // 3}"
            self.windows.setdefault(inset, []).append(event.body)
            return [inset]

        def triggers(self):
            return [i for i, w in self.windows.items() if len(w) >= 3]

        def generate(self, inset_id):
            return [("out", {"s": sum(b["v"] for b in
                                      self.windows[inset_id])})], []

        def clear_inset(self, inset_id):
            self.windows.pop(inset_id, None)

    return ListingStyleOperator


def _listing_run(core, plan=()):
    p = core.Pipeline()
    p.add(partial(core.GeneratorSource, "src",
                  core.ReadSource([{"v": i} for i in range(12)])))
    p.add(partial(_listing_operator(core), "mid"))
    p.add(partial(core.TerminalSink, "sink", target=4))
    p.connect("src", "out", "mid", "in")
    p.connect("mid", "out", "sink", "in")
    eng = core.Engine(p, mode="step", injector=core.FailureInjector(plan))
    assert eng.run_to_completion()
    return eng.external.committed(), eng.failures


@pytest.mark.parametrize("plan", [[], [("mid", "post_log", 2)],
                                  [("mid", "pre_state_update", 5)]])
def test_listing_style_operator_end_to_end(plan):
    got = _listing_run(TC, plan)
    assert got[0] == [{"s": 0 + 1 + 2}, {"s": 3 + 4 + 5}, {"s": 6 + 7 + 8},
                      {"s": 9 + 10 + 11}]
    assert got == _listing_run(JC, plan)


def test_api_surface_matches_tables():
    """Every method name of Tables 7/8/9 exists, as in repro.core.api."""
    from repro.core import api as japi
    table7 = ["GetActionID", "GetStateID", "BeginTransaction",
              "InitializeReadAction", "CompleteReadAction", "DropReadAction",
              "LogStateEvent", "UpdateContext", "GetWriteActions",
              "CheckEvent", "AssignInSets"]
    table8 = ["Commit", "LogSourceEvent", "LogOutputEvents", "DoneEvent",
              "StoreState"]
    table9 = ["FetchAckEvents", "FetchResendEvents", "GetProcState"]
    for m in table7 + table9:
        assert hasattr(LogioAPI, m), m
    for m in table8:
        assert hasattr(LogioTransaction, m), m
    public = lambda c: sorted(n for n in vars(c) if not n.startswith("_"))  # noqa: E731
    assert public(LogioAPI) == public(japi.LogioAPI)
    assert public(LogioTransaction) == public(japi.LogioTransaction)


# ---------------------------------------------------------------------------
# the deprecated query shims
# ---------------------------------------------------------------------------

def test_query_shims_warn_and_answer_as_lineage_query():
    eng = _run_linear(mode="step")
    q = LineageQuery(eng.store)
    with pytest.warns(DeprecationWarning, match="repro_torch.core.lineage"):
        back = TC.backward(eng.store, ("win", "out", 1))
    with pytest.warns(DeprecationWarning, match="repro_torch.core.lineage"):
        fwd = TC.forward(eng.store, ("src", "out", 5), "map")
    assert back == q.backward(("win", "out", 1)).keys()
    assert fwd == q.forward(("src", "out", 5), "map").keys()
    jeng = _run_linear(mode="step", core=JC)
    with pytest.warns(DeprecationWarning):
        assert back == JC.backward(jeng.store, ("win", "out", 1))
        assert fwd == JC.forward(jeng.store, ("src", "out", 5), "map")


# ---------------------------------------------------------------------------
# parity with repro.core: query results and replay reports, every stack
# ---------------------------------------------------------------------------

def _queries(core, spec, root):
    eng = _run_linear(spec, mode="step", root=root, core=core)
    q = core.LineageQuery(eng.store)
    flt = core.LineageFilter(ops={"src", "map"}, ssn_min=4, ssn_max=6)
    out = {
        "backward": [q.backward(("win", "out", i)) for i in range(5)],
        "filtered": q.backward(("win", "out", 1), where=flt),
        "limit": q.backward(("win", "out", 3), limit=3),
        "depth": q.backward(("win", "out", 3), depth=1),
        "forward": [q.forward(("src", "out", i), "map") for i in range(20)],
        "slice": q.slice([("win", "out", 1), ("win", "out", 4)]),
        "cut": q.slice(("win", "out", 2), cut=["map"]),
    }
    return plain(out)


@pytest.mark.parametrize("spec", ALL_STACKS)
def test_lineage_queries_match_jax(spec, tmp_path):
    got = _queries(TC, spec, tmp_path / "torch")
    assert got == _queries(JC, spec, tmp_path / "jax")
    # each window output comes from exactly its own four source events
    for i, res in enumerate(got["backward"]):
        srcs = sorted(k for k in res[1]["events"] if k[0] == "src")
        assert srcs == [("src", "out", j) for j in range(4 * i, 4 * i + 4)]


def _reports(core, spec, root):
    eng = _run_linear(spec, mode="step", root=root / "linear", core=core)
    deng = _run_diamond(spec, mode="step", root=root / "diamond", core=core)
    reps = [eng.replay(("win", "out", 1)),
            eng.replay([("win", "out", 0), ("win", "out", 4)]),
            eng.replay(("win", "out", 2),
                       scope=core.LineageScope(("map", "out"),
                                               ("win", "out"))),
            deng.replay([("join", "out", 0), ("join", "out", 2)])]
    assert all(r.ok for r in reps)
    return [dict(plain(r)[1], ok=r.ok) for r in reps]


@pytest.mark.parametrize("spec", ALL_STACKS)
def test_replay_reports_match_jax(spec, tmp_path):
    got = _reports(TC, spec, tmp_path / "torch")
    assert got == _reports(JC, spec, tmp_path / "jax")
    assert got[0]["executed_ops"] == frozenset({"map", "win"})
    assert got[2]["executed_ops"] == frozenset({"win"})


def test_plain_keeps_every_report_field():
    from repro_torch.core.replay import ReplayReport
    names = {f.name for f in dataclasses.fields(ReplayReport)}
    eng = _run_linear(mode="step")
    assert set(plain(eng.replay(("win", "out", 0)))[1]) == names
