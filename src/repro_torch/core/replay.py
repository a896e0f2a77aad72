"""Replay-from-lineage: re-execute the minimal sub-DAG deriving chosen
outputs (time-travel debugging; cf. Bauplan/Nessie replayable pipelines).

``Engine.replay(outputs, scope)`` delegates here. The flow:

  1. ``LineageQuery.slice`` walks EVENT_LINEAGE backward from the targets —
     the contributing event closure, its source events (no recorded lineage
     inputs, or produced by the scope's start operator), and the operator
     sub-DAG between them.
  2. Source payloads are materialized from EVENT_DATA. While the replay
     handle is live the slice's producer operators are added to the store's
     ``gc_protect`` registry, so a checkpoint compaction racing the replay
     cannot drop the payloads out from under it.
  3. A derived sub-pipeline is built: one injector source per (source port
     -> consumer) edge carrying exactly the events that consumer originally
     drew from that edge (per-edge injection keeps count-based InSet
     assignment aligned with the original run), the original factories for
     the slice operators, and one collector sink per target port.
  4. The sub-pipeline runs on a fresh in-memory store — thread mode or
     ``mode="process"`` (real SIGKILL injection works during replay; the
     replay run is itself recoverable).
  5. Rederived target outputs are matched positionally against the slice
     and compared byte-for-byte (``pickle.dumps``) with the logged
     payloads. Deterministic slices must reproduce exactly
     (:class:`ReplayMismatch` otherwise); non-deterministic slices are
     checked for lineage consistency only (every target rederived).

Exactness caveat: partial replay re-derives, per producer port, exactly the
slice's events. When a *re-executed* operator's port fans out to consumers
that originally drew different event subsets from it, no single re-derived
stream can serve both — that topology raises ``ValueError`` (fan-out ports
at the slice's *source* boundary are fine: sources are injected per edge).
"""
from __future__ import annotations

import dataclasses
import pickle
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.builtin import GeneratorSource, TerminalSink
from repro_torch.core.lineage import LineageScope
from repro_torch.core.lineagequery import EventKey, LineageQuery, LineageSlice
from repro_torch.core.logstore import MemoryLogStore
from repro_torch.core.operator import ExternalSystem, ReadSource

_MISSING = object()


class ReplayMismatch(ValueError):
    """A deterministic slice failed to rederive a target byte-identically."""


@dataclasses.dataclass
class ReplayReport:
    """Outcome of one ``Engine.replay`` call."""

    targets: Tuple[EventKey, ...]
    slice: LineageSlice
    rederived: Dict[EventKey, Any]          # target -> replayed body
    matches: Dict[EventKey, Optional[bool]]  # vs logged payload (None =
    #                                          original payload unavailable)
    executed_ops: frozenset                  # operators that re-executed
    deterministic: bool
    completed: bool

    @property
    def ok(self) -> bool:
        if not self.completed:
            return False
        if self.deterministic:
            return all(m is not False for m in self.matches.values())
        return all(t in self.rederived for t in self.targets)


def _injector_id(s: str, sp: str, d: str) -> str:
    return f"__replay__{s}.{sp}->{d}"


def _collector_id(op: str, port: str) -> str:
    return f"__replay_sink__{op}.{port}"


def replay_from_log(engine, outputs, *, scope: Optional[LineageScope] = None,
                    mode: Optional[str] = None, depth: int = 64,
                    timeout: float = 60.0, injector=None,
                    check: bool = True) -> ReplayReport:
    """See :meth:`repro_torch.core.engine.Engine.replay`."""
    from repro_torch.core.engine import Engine, Pipeline   # circular at import time

    store = engine.store
    pipeline = engine.pipeline
    if isinstance(outputs, (EventKey, tuple)) and (
            isinstance(outputs, EventKey)
            or (len(outputs) == 3 and isinstance(outputs[0], str))):
        outputs = [outputs]
    targets = [EventKey.coerce(k) for k in outputs]
    if scope is not None and not isinstance(scope, LineageScope):
        raise ValueError(
            f"scope must be a LineageScope (got {type(scope).__name__})")
    cut = [scope.start[0]] if scope is not None else None

    q = LineageQuery(store)
    sl = q.slice(targets, depth=depth, cut=cut)
    if sl.truncated:
        raise ValueError(
            f"lineage slice for {targets} is truncated at depth={depth}; "
            "raise depth= to capture the full upstream closure")
    if not sl.ops:
        raise ValueError(
            f"targets {targets} have no recorded lineage — nothing to "
            "re-execute (was lineage capture enabled for their scope?)")
    src_set = set(sl.sources)
    for t in sl.targets:
        if t in src_set:
            raise ValueError(
                f"target {t} has no recorded lineage inputs; it can only "
                "be read back from EVENT_DATA, not rederived")

    # while the replay is live, compaction must not GC any payload the
    # slice references (sources feed injection; the rest feed verification)
    prev_protect = store.gc_protect
    store.set_gc_protect(prev_protect | {e.op for e in sl.events})
    try:
        # ---- materialize payloads from the log -------------------------
        payloads: Dict[EventKey, Any] = {}
        for e in sl.events:
            p = store.get_event_payload(e.astuple())
            if p is not None:
                payloads[e] = p[1]
            elif e in src_set:
                raise ValueError(
                    f"payload of slice source {e} is no longer in "
                    "EVENT_DATA (GC'd?) — cannot inject it for replay; "
                    "register its operator in Engine(replay_ops=...) or "
                    "gc_protect to keep replay sources materializable")

        # ---- per-consumer consumed-event sets (from EVENT_LINEAGE) -----
        derivable = [e for e in sl.events if e not in src_set]
        consumed: Dict[str, set] = {}
        for e in derivable:
            acc = consumed.setdefault(e.op, set())
            for inset in q._insets_of(e, None):
                acc.update(EventKey(*k) for k in q._inset_events(e.op,
                                                                 inset, None))
        derived_on: Dict[Tuple[str, str], List[int]] = {}
        for e in derivable:
            derived_on.setdefault((e.op, e.port), []).append(e.ssn)
        for ssns in derived_on.values():
            ssns.sort()

        # ---- build the derived sub-pipeline ----------------------------
        rp = Pipeline()
        for op_id in sorted(sl.ops):
            rp.add(pipeline.factories[op_id])
        for (s, sp, d, dp, cap) in pipeline.connections:
            if d not in sl.ops:
                continue
            on_edge = sorted(e.ssn for e in consumed.get(d, ())
                             if (e.op, e.port) == (s, sp))
            if not on_edge:
                continue        # this input edge contributed nothing
            if s in sl.ops:
                if on_edge != derived_on.get((s, sp), []):
                    raise ValueError(
                        f"partial replay cannot align {s}.{sp} -> {d}: the "
                        f"slice re-derives events {derived_on.get((s, sp))} "
                        f"on {s}.{sp} but {d} originally consumed "
                        f"{on_edge}; a re-executed fan-out port must feed "
                        "every consumer the same event set")
                rp.connect(s, sp, d, dp, cap)
            else:
                inj = _injector_id(s, sp, d)
                bodies = [payloads[EventKey(s, sp, n)] for n in on_edge]
                rp.add(partial(GeneratorSource, inj, ReadSource(bodies),
                               conn_id="replay"))
                rp.connect(inj, "out", d, dp, cap)
        for (op, port) in sorted({(t.op, t.port) for t in sl.targets}):
            sink = _collector_id(op, port)
            rp.add(partial(TerminalSink, sink,
                           len(derived_on.get((op, port), ())),
                           record=True, conn_id="out"))
            rp.connect(op, port, sink, "in", 256)

        # ---- run it -----------------------------------------------------
        run_mode = mode or "thread"
        kw: Dict[str, Any] = {}
        if run_mode == "process":
            kw["transport"] = "routed"
            kw["ctx"] = engine.proc_ctx
        reng = Engine(rp, store=MemoryLogStore(), external=ExternalSystem(),
                      mode=run_mode, injector=injector, **kw)
        reng.start()
        completed = reng.wait(timeout)
        reng.stop()

        # ---- collect + verify -------------------------------------------
        rederived: Dict[EventKey, Any] = {}
        matches: Dict[EventKey, Optional[bool]] = {}
        for t in sl.targets:
            idx = derived_on[(t.op, t.port)].index(t.ssn)
            body = reng.external.writes.get(
                (_collector_id(t.op, t.port), "out", idx), _MISSING)
            if body is _MISSING:
                matches[t] = False
                continue
            rederived[t] = body
            orig = payloads.get(t, _MISSING)
            matches[t] = None if orig is _MISSING else \
                pickle.dumps(orig) == pickle.dumps(body)
        deterministic = all(
            getattr(engine.ops.get(op_id), "deterministic", True)
            for op_id in sl.ops)
        executed = frozenset(op for op, m in reng.metrics().ops.items()
                             if m.processed > 0
                             and not op.startswith("__replay"))
        report = ReplayReport(targets=sl.targets, slice=sl,
                              rederived=rederived, matches=matches,
                              executed_ops=executed,
                              deterministic=deterministic,
                              completed=completed)
        if check:
            if not completed:
                raise ReplayMismatch(
                    f"replay run did not complete within {timeout}s "
                    f"(executed: {sorted(executed)})")
            missing = [t for t in sl.targets if t not in rederived]
            if missing:
                raise ReplayMismatch(
                    f"replay did not rederive targets {missing}")
            if deterministic:
                bad = [t for t, m in matches.items() if m is False]
                if bad:
                    raise ReplayMismatch(
                        f"deterministic slice rederived different bytes "
                        f"for {bad}")
        return report
    finally:
        store.set_gc_protect(prev_protect)
