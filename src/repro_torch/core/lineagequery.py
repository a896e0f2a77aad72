"""Queryable lineage: the typed query facade over any LogBackend (Sec. 7.3).

The log's EVENT_LINEAGE x EVENT_LOG join is exposed as a product feature —
audit ("which inputs produced this output?"), debugging, and selective
reprocessing — instead of only the recovery mechanism's private read path:

  * :class:`EventKey` — the typed event identity ``(op, port, ssn)``
    replacing bare 3-tuples at the API boundary (tuples still accepted,
    coerced with loud ``ValueError`` on malformed input);
  * :class:`LineageQuery` — ``backward`` / ``forward`` / ``slice`` walks
    with scan-time filtering (:class:`~repro_torch.core.logstore.base.
    LineageFilter` predicates pushed into the store layer when the backend
    advertises ``supports_query_pushdown``) and bounded results (``limit``
    + an explicit ``truncated`` flag, never silently unbounded lists);
  * :class:`LineageSlice` — the minimal upstream event set and operator
    sub-DAG that rederives chosen outputs: the input of replay-from-lineage
    (``Engine.replay``).

Pushdown never changes an answer: the facade re-applies the exact predicate
client-side, so a backend is free to return a superset restricted by
whatever it evaluated natively.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Set, Tuple, Union

from repro_torch.core.logstore.base import LineageFilter, LogBackend

KeyLike = Union["EventKey", Tuple[str, str, int]]


@dataclasses.dataclass(frozen=True, order=True)
class EventKey:
    """Typed identity of a logged event: sender operator, output port, and
    send sequence number (the paper's (Sender_ID, Send_Port, SSN))."""

    op: str
    port: str
    ssn: int

    def __post_init__(self):
        if not isinstance(self.op, str) or not self.op:
            raise ValueError(
                f"EventKey.op must be a non-empty operator id string "
                f"(got {self.op!r})")
        if not isinstance(self.port, str) or not self.port:
            raise ValueError(
                f"EventKey.port must be a non-empty port name string "
                f"(got {self.port!r})")
        if not isinstance(self.ssn, int) or isinstance(self.ssn, bool) \
                or self.ssn < 0:
            raise ValueError(
                f"EventKey.ssn must be a non-negative int (got {self.ssn!r})")

    @classmethod
    def coerce(cls, key: KeyLike) -> "EventKey":
        """Accept an EventKey or a raw ``(op, port, ssn)`` tuple/list."""
        if isinstance(key, cls):
            return key
        if isinstance(key, (tuple, list)):
            if len(key) != 3:
                raise ValueError(
                    f"event key must be (op, port, ssn), got "
                    f"{len(key)}-tuple {key!r}")
            return cls(key[0], key[1], key[2])
        raise ValueError(
            f"event key must be an EventKey or (op, port, ssn) tuple, "
            f"got {type(key).__name__}: {key!r}")

    def astuple(self) -> Tuple[str, str, int]:
        return (self.op, self.port, self.ssn)


@dataclasses.dataclass(frozen=True)
class LineageResult:
    """Events found by a backward/forward walk, in discovery (BFS) order.
    ``truncated`` is True when ``limit`` cut the result or ``depth`` ran
    out with the frontier still live — the walk may not be exhaustive."""

    events: Tuple[EventKey, ...]
    truncated: bool = False

    def __iter__(self):
        return iter(self.events)

    def __len__(self):
        return len(self.events)

    def keys(self) -> List[Tuple[str, str, int]]:
        return [e.astuple() for e in self.events]


@dataclasses.dataclass(frozen=True)
class LineageSlice:
    """The minimal sub-DAG that rederives ``targets`` from the log.

    ``events`` is the full contributing closure (targets included);
    ``sources`` are the events with no recorded lineage inputs — replay
    must materialize their payloads from EVENT_DATA and inject them;
    ``ops`` are the operators that must re-execute (producers of derivable
    events); ``edges`` are operator-level flows ``(src_op, src_port,
    dst_op)`` restricted to the slice."""

    targets: Tuple[EventKey, ...]
    events: Tuple[EventKey, ...]
    sources: Tuple[EventKey, ...]
    ops: frozenset
    edges: frozenset
    truncated: bool = False


class LineageQuery:
    """Backward/forward/slice lineage queries over one :class:`LogBackend`.

    ``pushdown=None`` (default) auto-detects via the backend's
    ``supports_query_pushdown``; ``False`` forces the legacy full-scan ops
    with client-side filtering (the benchmark's baseline arm); ``True``
    requires the filtered ops (every backend answers them — the base class
    falls back to client-side filtering internally).
    """

    def __init__(self, store: LogBackend, *, pushdown: Optional[bool] = None):
        if not isinstance(store, LogBackend):
            raise ValueError(
                f"LineageQuery needs a LogBackend (got "
                f"{type(store).__name__})")
        self.store = store
        if pushdown is None:
            pushdown = bool(getattr(store, "supports_query_pushdown", False))
        self.pushdown = pushdown

    # ---- store access (pushdown vs legacy scan) --------------------------
    def _insets_of(self, key: EventKey, flt) -> List[str]:
        if self.pushdown:
            return self.store.query_lineage_insets(key.astuple(), flt)
        if flt is not None and not flt.matches(key.op, key.port, key.ssn):
            return []
        return self.store.lineage_insets_of(key.astuple())

    def _inset_events(self, rec_op: str, inset: str, flt) -> List[Tuple]:
        if self.pushdown:
            keys = self.store.query_inset_events(rec_op, inset, flt)
        else:
            keys = self.store.lineage_events_of_inset(rec_op, inset)
        if flt is not None:
            keys = [k for k in keys if flt.matches(k[0], k[1], k[2])]
        return keys

    def _inset_outputs(self, send_op: str, inset: str, flt) -> List[Tuple]:
        if self.pushdown:
            keys = self.store.query_inset_outputs(send_op, inset, flt)
        else:
            keys = self.store.lineage_outputs_of_inset(send_op, inset)
        if flt is not None:
            keys = [k for k in keys if flt.matches(k[0], k[1], k[2])]
        return keys

    def _event_insets(self, key: EventKey, rec_op: str, flt) -> List[str]:
        if self.pushdown:
            return self.store.query_event_insets(key.astuple(), rec_op, flt)
        if flt is not None and not flt.matches(key.op, key.port, key.ssn):
            return []
        return self.store.insets_of_event(key.astuple(), rec_op)

    def _consumers(self, key: EventKey, flt) -> List[str]:
        if self.pushdown:
            return self.store.query_consumers(key.astuple(), flt)
        recs = self.store.consumers_of(key.astuple())
        if flt is not None and flt.ops is not None:
            recs = [r for r in recs if r in flt.ops]
        return recs

    # ---- queries ---------------------------------------------------------
    @staticmethod
    def _check_args(depth: int, limit: Optional[int]):
        if not isinstance(depth, int) or depth < 1:
            raise ValueError(f"depth must be a positive int (got {depth!r})")
        if limit is not None and (not isinstance(limit, int) or limit < 0):
            raise ValueError(
                f"limit must be a non-negative int or None (got {limit!r})")

    def backward(self, key: KeyLike, *, where: Optional[LineageFilter] = None,
                 depth: int = 64, limit: Optional[int] = None
                 ) -> LineageResult:
        """Input events (transitively) used to produce ``key``, BFS order.
        ``where`` prunes the traversal: a non-matching input event is
        neither reported nor expanded."""
        self._check_args(depth, limit)
        key = EventKey.coerce(key)
        seen: Set[EventKey] = set()
        frontier = [key]
        found: List[EventKey] = []
        truncated = False
        for _ in range(depth):
            nxt: List[EventKey] = []
            for ev in frontier:
                # the root is expanded unfiltered: `where` scopes the
                # contributors, not the event being explained
                root_flt = None if ev is key else where
                for inset in self._insets_of(ev, root_flt):
                    for ik in self._inset_events(ev.op, inset, where):
                        ike = EventKey(*ik)
                        if ike in seen:
                            continue
                        if limit is not None and len(found) >= limit:
                            return LineageResult(tuple(found), True)
                        seen.add(ike)
                        found.append(ike)
                        nxt.append(ike)
            if not nxt:
                break
            frontier = nxt
        else:
            truncated = bool(frontier)
        return LineageResult(tuple(found), truncated)

    def forward(self, key: KeyLike, rec_op: str, *,
                where: Optional[LineageFilter] = None, depth: int = 64,
                limit: Optional[int] = None) -> LineageResult:
        """Output events (transitively) derived from ``key`` as consumed by
        ``rec_op``, BFS order."""
        self._check_args(depth, limit)
        if not isinstance(rec_op, str) or not rec_op:
            raise ValueError(
                f"rec_op must be a non-empty operator id (got {rec_op!r})")
        key = EventKey.coerce(key)
        seen: Set[EventKey] = set()
        found: List[EventKey] = []
        frontier: List[Tuple[EventKey, str]] = [(key, rec_op)]
        truncated = False
        for _ in range(depth):
            nxt: List[Tuple[EventKey, str]] = []
            for ev, op in frontier:
                for inset in self._event_insets(ev, op, None):
                    for ok in self._inset_outputs(op, inset, where):
                        oke = EventKey(*ok)
                        if oke in seen:
                            continue
                        if limit is not None and len(found) >= limit:
                            return LineageResult(tuple(found), True)
                        seen.add(oke)
                        found.append(oke)
                        for consumer in self._consumers(oke, None):
                            if consumer != op:
                                nxt.append((oke, consumer))
            if not nxt:
                break
            frontier = nxt
        else:
            truncated = bool(frontier)
        return LineageResult(tuple(found), truncated)

    def slice(self, keys: Union[KeyLike, Sequence[KeyLike]], *,
              where: Optional[LineageFilter] = None, depth: int = 64,
              limit: Optional[int] = None,
              cut: Optional[Sequence[str]] = None) -> LineageSlice:
        """Minimal upstream closure + operator sub-DAG rederiving ``keys``.

        Walks backward from every target simultaneously (shared seen-set),
        recording which operators produced derivable events and the
        operator-level edges the data flowed over — exactly what
        ``Engine.replay`` re-executes. Events with no recorded lineage
        inputs are the slice's ``sources``: their payloads come from
        EVENT_DATA, everything downstream is recomputed. ``cut`` names
        operators whose events are forced into ``sources`` (not expanded
        further) — the replay-scope boundary: replay injects their logged
        payloads instead of re-deriving them."""
        self._check_args(depth, limit)
        cut_ops = frozenset(cut) if cut is not None else frozenset()
        if isinstance(keys, (EventKey, tuple, list)) and (
                isinstance(keys, EventKey)
                or (len(keys) == 3 and isinstance(keys[0], str))):
            keys = [keys]
        targets = tuple(EventKey.coerce(k) for k in keys)
        if not targets:
            raise ValueError("slice() needs at least one target event key")
        seen: Set[EventKey] = set(targets)
        events: List[EventKey] = list(targets)
        sources: List[EventKey] = []
        ops: Set[str] = set()
        edges: Set[Tuple[str, str, str]] = set()
        frontier = list(targets)
        truncated = False
        for _ in range(depth):
            nxt: List[EventKey] = []
            for ev in frontier:
                insets = () if ev.op in cut_ops else self._insets_of(ev, None)
                if not insets:
                    sources.append(ev)      # no lineage inputs: inject
                    continue
                ops.add(ev.op)              # derivable: op must re-execute
                for inset in insets:
                    for ik in self._inset_events(ev.op, inset, where):
                        ike = EventKey(*ik)
                        edges.add((ike.op, ike.port, ev.op))
                        if ike in seen:
                            continue
                        if limit is not None and len(events) >= limit:
                            truncated = True
                            continue
                        seen.add(ike)
                        events.append(ike)
                        nxt.append(ike)
            if not nxt:
                frontier = []
                break
            frontier = nxt
        truncated = truncated or bool(frontier)
        return LineageSlice(targets=targets, events=tuple(events),
                            sources=tuple(sources), ops=frozenset(ops),
                            edges=frozenset(edges), truncated=truncated)
