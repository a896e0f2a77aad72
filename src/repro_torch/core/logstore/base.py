"""Formal LOG.io log-backend interface (Sec. 3.2).

Five tables: EVENT_LOG, EVENT_DATA, READ_ACTION, STATE, EVENT_LINEAGE.

A backend owns the tables and exposes

  * ``begin()`` — a :class:`LogTransaction` buffering mutations; ``commit``
    applies them atomically (validation of conditional mutations before any
    mutation => the abort semantics the dynamic-scaling mutual exclusion of
    Algorithm 13 needs) and returns a *durability token*;
  * queries — the read paths of the recovery/lineage/scaling algorithms;
  * a durability watermark — ``is_durable(token)`` says whether a commit has
    reached the durable medium. Plain backends are durable at commit
    (token ``None``); a :class:`~repro.core.logstore.batched.GroupCommitStore`
    pipelines commits and advances the watermark at batch flushes. Consumers
    that release *externally visible* effects (channel acks, external-system
    writes) must gate them on ``is_durable`` — the durability-watermark rule.

Transaction ops are plain tuples (``(kind, *args)``) so they can be routed
between shards, buffered into batches, and persisted as a WAL verbatim.
"""
from __future__ import annotations

import abc
import dataclasses
import warnings
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.events import Event


@dataclasses.dataclass(frozen=True)
class LineageFilter:
    """Scan-time predicate for the filtered lineage query ops.

    ``ops``/``ports`` restrict results to those sender operators/output
    ports; ``ssn_min``/``ssn_max`` bound the event id (inclusive). A backend
    that opts into predicate pushdown (``supports_query_pushdown``) evaluates
    these *at the scan* — SQL WHERE, secondary indexes, sidecar-index segment
    skipping — instead of materializing every row. ``epoch_min``/``epoch_max``
    are *scan hints* for log-structured backends (they bound the flush epochs
    a durable scan must visit); memory-image backends ignore them, and
    ``matches`` does not evaluate them, so a hint can only skip I/O, never
    change results.

    Backends may return a superset restricted by whatever they can evaluate
    natively; :class:`~repro.core.lineagequery.LineageQuery` re-applies the
    exact predicate client-side, so pushdown is purely a performance contract.
    """

    ops: Optional[frozenset] = None
    ports: Optional[frozenset] = None
    ssn_min: Optional[int] = None
    ssn_max: Optional[int] = None
    epoch_min: Optional[int] = None
    epoch_max: Optional[int] = None

    def __post_init__(self):
        for name in ("ops", "ports"):
            val = getattr(self, name)
            if val is None:
                continue
            if isinstance(val, str):
                val = (val,)
            try:
                val = frozenset(val)
            except TypeError:
                raise ValueError(
                    f"LineageFilter.{name} must be an iterable of strings "
                    f"(got {getattr(self, name)!r})") from None
            if not all(isinstance(x, str) for x in val):
                raise ValueError(
                    f"LineageFilter.{name} entries must be strings "
                    f"(got {sorted(map(repr, val))})")
            object.__setattr__(self, name, val)
        for name in ("ssn_min", "ssn_max", "epoch_min", "epoch_max"):
            val = getattr(self, name)
            if val is not None and not isinstance(val, int):
                raise ValueError(f"LineageFilter.{name} must be an int "
                                 f"(got {val!r})")
        if self.ssn_min is not None and self.ssn_max is not None \
                and self.ssn_min > self.ssn_max:
            raise ValueError(
                f"LineageFilter ssn range is empty "
                f"({self.ssn_min} > {self.ssn_max})")

    def matches(self, op: str, port: Optional[str], ssn: int) -> bool:
        """Exact (client-side) evaluation — epoch hints intentionally
        excluded: they narrow scans, never membership."""
        if self.ops is not None and op not in self.ops:
            return False
        if self.ports is not None and port not in self.ports:
            return False
        if self.ssn_min is not None and ssn < self.ssn_min:
            return False
        if self.ssn_max is not None and ssn > self.ssn_max:
            return False
        return True


class TxnAborted(Exception):
    """Raised at commit when a conditional mutation fails (e.g. marking a
    non-existent InSet done — the dynamic-scaling mutual exclusion of
    Algorithm 13)."""


class LogTransaction:
    """Buffered mutation set against one backend. Mutations are recorded as
    op tuples; nothing is visible before ``commit``."""

    def __init__(self, store: "LogBackend"):
        self.store = store
        self.ops: List[Tuple] = []

    # -- mutations (buffered) ---------------------------------------------
    def log_event(self, ev: Event, status: str,
                  inset_id: Optional[str] = None):
        if ev.cached_blob() is not None:
            # the payload travels as a put_event_blob op: carrying the body
            # here too would double-ship it through store RPC and WAL
            # pickles (EVENT_LOG rows only ever read the routing fields)
            ev = dataclasses.replace(ev, body=None, header=dict(ev.header))
        self.ops.append(("log_event", ev, status, inset_id))

    def log_events(self, entries: Iterable[Tuple]):
        """Vectored ``log_event``: one op carrying a *run* of events. Each
        entry is ``(event, status, inset_id)`` and every row stays
        individually keyed in EVENT_LOG — a crash mid-run replays exactly
        the unlogged suffix, never a whole batch. Backends apply the run
        under one lock acquisition / one durable append."""
        recs = []
        for ev, status, inset_id in entries:
            if ev.cached_blob() is not None:
                ev = dataclasses.replace(ev, body=None,
                                         header=dict(ev.header))
            recs.append((ev, status, inset_id))
        self.ops.append(("log_events", recs))

    def put_event_data(self, ev: Event):
        blob = ev.cached_blob()
        if blob is not None:
            # zero-copy path: the transport's wire payload doubles as the
            # EVENT_DATA blob — one encode per event, shared end to end.
            # op[2] is the row's home operator (the sharded router's key).
            home = ev.rec_op if ev.rec_op is not None else ev.send_op
            self.ops.append(("put_event_blob", ev.key(), home, blob))
        else:
            self.ops.append(("put_event_data", ev))

    def delete_event_data(self, key):
        self.ops.append(("delete_event_data", key))

    def set_status(self, key, status: str, inset_id: Optional[str] = "*",
                   rec_op: Optional[str] = None,
                   only_status: Optional[str] = None):
        """key = (send_op, send_port, event_id). rec_op filters to one
        receiver's rows; only_status makes the flip conditional."""
        self.ops.append(("set_status", key, status, inset_id, rec_op,
                         only_status))

    def set_status_many(self, entries: Iterable[Tuple]):
        """Vectored ``set_status``: one op flipping a run of individually
        keyed rows. Each entry is ``(key, status, inset_id, rec_op,
        only_status)`` — the same fields ``set_status`` takes."""
        self.ops.append(("set_status_many",
                         [(tuple(k), s, i, r, o)
                          for (k, s, i, r, o) in entries]))

    def assign_insets(self, key, inset_ids: List[str],
                      rec_op: Optional[str] = None):
        self.ops.append(("assign_insets", key, list(inset_ids), rec_op))

    def set_inset_status(self, rec_op: str, inset_id: str, status: str,
                         require_rows: bool = False):
        self.ops.append(("set_inset_status", rec_op, inset_id, status,
                         require_rows))

    def clear_inset(self, rec_op: str, inset_id: str):
        self.ops.append(("clear_inset", rec_op, inset_id))

    def put_state(self, op_id: str, state_id: int, blob: bytes,
                  keep_history: bool = False):
        self.ops.append(("put_state", op_id, state_id, blob, keep_history))

    def put_lineage(self, event_id: int, send_op: str, send_port: str,
                    inset_id: str):
        self.ops.append(("put_lineage", event_id, send_op, send_port,
                         inset_id))

    def put_read_action(self, op_id: str, conn_id: str, action_id: int,
                        status: str, desc: str):
        self.ops.append(("put_read_action", op_id, conn_id, action_id,
                         status, desc))

    def set_read_action_status(self, op_id: str, conn_id: str,
                               action_id: int, status: str):
        self.ops.append(("set_read_action_status", op_id, conn_id, action_id,
                         status))

    def delete_event_rows(self, key):
        self.ops.append(("delete_event_rows", key))

    def reassign_event(self, old_key, old_rec: Optional[str], new_key,
                       tgt_op: str, tgt_port: str):
        """Alg 13 step 1.c: move a still-undone event to a new destination
        (+ new event id); rows already done are skipped at apply time."""
        self.ops.append(("reassign_event", old_key, old_rec, new_key,
                         tgt_op, tgt_port))

    def commit(self):
        """Atomically apply the buffered ops. Returns a durability token
        (``None`` = durable now). Raises TxnAborted and applies nothing when
        a conditional mutation fails."""
        ops, self.ops = self.ops, []
        return self.store._commit(ops)


class LogBackend(abc.ABC):
    """Abstract log backend: the contract every protocol module (operator
    runtime, recovery, scaling, lineage, engine) programs against."""

    # ---- transactions ----------------------------------------------------
    def begin(self) -> LogTransaction:
        return LogTransaction(self)

    @abc.abstractmethod
    def _commit(self, ops: List[Tuple]):
        """Validate + apply one transaction's ops; return durability token."""

    # ---- durability watermark -------------------------------------------
    def is_durable(self, token) -> bool:
        """True once the commit identified by ``token`` is durable. Plain
        backends commit durably, so any token (incl. None) is durable."""
        return True

    def flush(self):
        """Force everything committed so far to the durable medium."""

    def maybe_flush(self):
        """Flush if a size/time watermark has been reached (group commit)."""

    def crash(self):
        """Simulate a full-process crash: committed-but-unflushed data is
        lost; the store image rolls back to the durable watermark."""

    def close(self):
        pass

    # ---- checkpoint / truncation (bounded-replay recovery) ---------------
    # A checkpointing backend periodically captures the full table image as
    # a *checkpoint record* inside the log store and truncates the log
    # records below that watermark, so a warm restart replays only
    # O(records-since-last-checkpoint) work instead of O(pipeline lifetime).
    # Backends without a durable log (memory) have nothing to truncate; the
    # defaults make checkpointing a no-op for them.

    #: True when ``checkpoint()`` actually truncates a durable log.
    supports_checkpoint: bool = False

    #: Senders whose EVENT_DATA payloads must survive checkpoint GC — the
    #: engine registers the predecessors of replay operators (and lineage-
    #: scoped producers) here: a replay flip can turn done inputs back
    #: into needed ones (Sec. 5), so their payloads are never final-done.
    gc_protect: frozenset = frozenset()

    def set_gc_protect(self, ops: Iterable[str]):
        self.gc_protect = frozenset(ops)

    def checkpoint(self):
        """Write a checkpoint record and truncate log records below it."""

    def checkpoint_due(self) -> bool:
        """True once enough records accumulated since the last checkpoint
        (the configured checkpoint interval) that ``checkpoint()`` should
        run."""
        return False

    def maybe_checkpoint(self):
        """Checkpoint iff the cadence watermark has been reached — the
        engine calls this from its supervision loops (cheap when not due)."""
        if self.checkpoint_due():
            self.checkpoint()

    def recovery_replay_count(self) -> int:
        """Log records replayed when this store (re)opened its durable
        image — the bounded-replay metric: with checkpoint interval K this
        stays O(K) regardless of pipeline lifetime."""
        return 0

    # ---- recovery queries -----------------------------------------------
    @abc.abstractmethod
    def fetch_resend_events(self, op_id: str) -> List[Tuple[Event, str]]:
        """Alg 7 step 1: undone, sender==op, InSet null, real output events."""

    @abc.abstractmethod
    def fetch_ack_events(self, op_id: str, include_done: bool = False
                         ) -> List[Tuple[Event, str, str]]:
        """Alg 9 step 2: undone, receiver==op, InSet assigned.

        ``include_done`` additionally returns DONE rows — needed when the
        receiver recovers from an epoch-mode (interval-snapshotted, hence
        possibly stale) state snapshot and must replay the global-state
        contributions of inputs it already completed."""

    @abc.abstractmethod
    def fetch_replay_outputs(self, op_id: str) -> List[Tuple[int, str, str]]:
        """Sender-side rows marked REPLAY by consumers (Alg 10 step 2)."""

    @abc.abstractmethod
    def undone_outputs_after(self, op_id: str, port: str, min_id: int
                             ) -> List[int]:
        """UNDONE outputs on a port with event_id >= min_id (Alg 10)."""

    @abc.abstractmethod
    def get_write_actions(self, op_id: str) -> List[Event]:
        """Alg 8: undone events with null sender port for op."""

    @abc.abstractmethod
    def get_state(self, op_id: str) -> Optional[bytes]:
        """Latest STATE blob for op."""

    @abc.abstractmethod
    def last_sent_ssn(self, op_id: str) -> Dict[str, int]:
        """max event_id per output port (Alg 9 step 1)."""

    @abc.abstractmethod
    def last_acked(self, op_id: str) -> Dict[str, int]:
        """max event_id per input port with an assigned InSet."""

    @abc.abstractmethod
    def event_status(self, key, rec_op: Optional[str] = None
                     ) -> List[Tuple[Optional[str], str]]:
        """[(inset_id, status)] of EVENT_LOG rows for one event key."""

    @abc.abstractmethod
    def get_read_action(self, op_id: str, conn_id: str):
        """Latest read action for (op, conn): (action_id, row) or (None, None)."""

    # ---- scaling queries (Alg 13) ---------------------------------------
    @abc.abstractmethod
    def undone_events_from(self, send_op: str, rec_op: str) -> List[Tuple]:
        """Keys (send_op, send_port, event_id) of UNDONE rows from send_op
        to rec_op, ordered by event_id (the set O of Alg 13 step 1.b)."""

    # ---- lineage queries (Sec. 7.3) -------------------------------------
    @abc.abstractmethod
    def lineage_insets_of(self, event_key) -> List[str]:
        """InSet_IDs that produced an output event (EVENT_LINEAGE)."""

    @abc.abstractmethod
    def lineage_events_of_inset(self, rec_op: str, inset_id: str
                                ) -> List[Tuple]:
        """Input event keys assigned to an Input Set."""

    @abc.abstractmethod
    def lineage_outputs_of_inset(self, send_op: str, inset_id: str
                                 ) -> List[Tuple]:
        """Output event keys produced from an Input Set."""

    @abc.abstractmethod
    def insets_of_event(self, event_key, rec_op: str) -> List[str]:
        """InSet_IDs an input event joined at one receiver."""

    @abc.abstractmethod
    def consumers_of(self, event_key) -> List[str]:
        """Receiver operator ids holding EVENT_LOG rows for an event."""

    # ---- filtered lineage queries (predicate pushdown) -------------------
    # Optional fast paths for the LineageQuery facade. The defaults delegate
    # to the unfiltered ops above and filter client-side, so every backend
    # answers correctly; backends that can evaluate a LineageFilter at the
    # scan (SQL WHERE, secondary indexes, segment sidecar skipping) override
    # these and advertise it via ``supports_query_pushdown``. Results may be
    # a superset restricted by whatever the backend evaluated natively —
    # LineageQuery re-applies the exact predicate, so pushdown only ever
    # changes how much data the scan touches, never the answer.

    #: True when the filtered query ops evaluate predicates at the scan
    #: rather than via the client-side fallback below.
    supports_query_pushdown: bool = False

    def query_lineage_insets(self, event_key,
                             flt: Optional[LineageFilter] = None
                             ) -> List[str]:
        """InSet_IDs that produced an output event (filtered variant of
        ``lineage_insets_of``; the filter applies to the *output* key)."""
        if flt is not None and not flt.matches(event_key[0], event_key[1],
                                               event_key[2]):
            return []
        return self.lineage_insets_of(event_key)

    def query_inset_events(self, rec_op: str, inset_id: str,
                           flt: Optional[LineageFilter] = None
                           ) -> List[Tuple]:
        """Input event keys of one Input Set, filtered on the *sender* side
        of each key (filtered ``lineage_events_of_inset``)."""
        keys = self.lineage_events_of_inset(rec_op, inset_id)
        if flt is None:
            return keys
        return [k for k in keys if flt.matches(k[0], k[1], k[2])]

    def query_inset_outputs(self, send_op: str, inset_id: str,
                            flt: Optional[LineageFilter] = None
                            ) -> List[Tuple]:
        """Output event keys produced from an Input Set (filtered
        ``lineage_outputs_of_inset``)."""
        keys = self.lineage_outputs_of_inset(send_op, inset_id)
        if flt is None:
            return keys
        return [k for k in keys if flt.matches(k[0], k[1], k[2])]

    def query_event_insets(self, event_key, rec_op: str,
                           flt: Optional[LineageFilter] = None
                           ) -> List[str]:
        """InSet_IDs an input event joined at one receiver (filtered
        ``insets_of_event``; the filter applies to the input key)."""
        if flt is not None and not flt.matches(event_key[0], event_key[1],
                                               event_key[2]):
            return []
        return self.insets_of_event(event_key, rec_op)

    def query_consumers(self, event_key,
                        flt: Optional[LineageFilter] = None) -> List[str]:
        """Receiver ids holding rows for an event; ``flt.ops`` restricts the
        receivers considered (filtered ``consumers_of``)."""
        recs = self.consumers_of(event_key)
        if flt is not None and flt.ops is not None:
            recs = [r for r in recs if r in flt.ops]
        return recs

    def query_lineage(self, flt: Optional[LineageFilter] = None
                      ) -> List[Tuple]:
        """Bulk audit scan: all EVENT_LINEAGE rows matching ``flt`` as
        ``(send_op, send_port, event_id, inset_id)`` tuples. Only backends
        holding the lineage table natively implement this."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support bulk lineage scans")

    def get_event_payload(self, event_key) -> Optional[Tuple[Dict, Any]]:
        """EVENT_DATA payload for a key as ``(header, body)``, or None when
        the payload was GC'd or never stored — the replay-from-lineage
        materialization read. Backends without payload access return None."""
        return None

    # ---- query instrumentation ------------------------------------------
    def query_stats(self) -> Dict[str, int]:
        """Deprecated public accessor — the typed metrics plane
        (``Engine.metrics().store``) is the supported surface; backends
        implement ``_query_stats``."""
        warnings.warn(
            "LogBackend.query_stats() is deprecated; read "
            "Engine.metrics().store (repro_torch.core.metrics.StoreMetrics) "
            "instead", DeprecationWarning, stacklevel=2)
        return self._query_stats()

    def _query_stats(self) -> Dict[str, int]:
        """Scan-effort counters for the lineage query paths (rows_scanned /
        rows_returned, plus backend-specific keys such as segment skip
        counts). Purely diagnostic — the pushdown benchmark and tests assert
        on these; backends without instrumentation return {}."""
        return {}

    def reset_query_stats(self):
        """Zero the ``query_stats`` counters."""

    # ---- GC (Sec. 3.6) ---------------------------------------------------
    @abc.abstractmethod
    def gc(self, lineage_ops: Iterable[str] = ()):
        """Drop payloads (and, without lineage, rows) of done events."""
