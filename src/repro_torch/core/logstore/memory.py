"""In-memory LogBackend: dict-based tables behind one lock.

Transactions buffer mutations and apply them under the lock at commit; a
crash between ``begin`` and ``commit`` loses exactly the uncommitted buffer
(the atomicity the protocol needs). Commits are durable immediately
(token ``None``): the store object itself plays the durable HANA instance of
the paper's implementation for engine-level (pod) failures.

``eager_serialize=False`` keeps EVENT_DATA payloads as raw objects and
defers pickling to whoever ships them to a durable medium — the
serialization-off-the-critical-path optimization the group-commit layer
builds on (cf. write-ahead lineage with asynchronous flushing,
arXiv:2403.08062). The zero-copy path stores the *body by reference*:
logged event bodies are part of the log's contract and must not be mutated
after commit (all in-repo operators build fresh bodies per event; an
operator reusing a mutable buffer must copy it before emitting).
"""
from __future__ import annotations

import pickle
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.events import DONE, REPLAY, UNDONE, Event
from repro_torch.core.logstore.base import LineageFilter, LogBackend, TxnAborted

_RAW = "__raw__"


class MemoryLogStore(LogBackend):
    """EVENT_LOG rows: {key: (send_op,send_port,event_id,rec_op,inset_id|None)
    -> dict(status=..., rec_op=..., rec_port=..., inset=...)}."""

    def __init__(self, eager_serialize: bool = True):
        self.lock = threading.RLock()
        self.eager_serialize = eager_serialize
        self.event_log: Dict[Tuple, Dict[str, Any]] = {}
        self.event_data: Dict[Tuple, Any] = {}
        self.read_actions: Dict[Tuple, Dict[str, Any]] = {}
        self.state: Dict[str, List[Tuple[int, bytes]]] = {}
        self.lineage: List[Tuple[int, str, str, str]] = []
        # secondary indexes: the per-event transactions of the hot path
        # (set_status / assign_insets / set_inset_status and their
        # validation) must not scan the whole EVENT_LOG
        self._by_key3: Dict[Tuple, set] = {}            # (so,sp,id) -> keys
        self._by_rec_inset: Dict[Tuple, set] = {}       # (rec_op,ins) -> keys
        # lineage indexes: the LineageQuery pushdown paths walk these
        # instead of scanning the append-only lineage list / EVENT_LOG
        self._lin_by_out: Dict[Tuple, List[str]] = {}   # (so,sp,id) -> insets
        self._lin_by_inset: Dict[Tuple, List[Tuple]] = {}  # (so,ins) -> key3s
        # scan-effort counters (query_stats): rows touched by the legacy
        # full-scan query paths vs rows returned by the indexed ones
        self._qstats: Dict[str, int] = {"rows_scanned": 0, "rows_returned": 0}
        # checkpoint-truncation floors: once a checkpointing subclass GC's
        # done rows, the max-scan queries below would rewind — these floors
        # (persisted in the checkpoint record) pin the pre-truncation maxima
        self._ssn_floor: Dict[Tuple[str, str], int] = {}   # (op,port)->ssn
        self._ack_floor: Dict[Tuple[str, str], int] = {}   # (op,port)->id
        self.commits = 0
        self.bytes_written = 0

    # -- row index maintenance ---------------------------------------------
    def _add_row(self, k: Tuple, row: Dict[str, Any]):
        self.event_log[k] = row
        self._by_key3.setdefault(k[:3], set()).add(k)
        if k[4] is not None:
            self._by_rec_inset.setdefault((row["rec_op"], k[4]),
                                          set()).add(k)

    def _del_row(self, k: Tuple):
        row = self.event_log.pop(k, None)
        if row is None:
            return
        keys = self._by_key3.get(k[:3])
        if keys is not None:
            keys.discard(k)
            if not keys:
                del self._by_key3[k[:3]]
        if k[4] is not None:
            keys = self._by_rec_inset.get((row["rec_op"], k[4]))
            if keys is not None:
                keys.discard(k)
                if not keys:
                    del self._by_rec_inset[(row["rec_op"], k[4])]

    def _reindex(self):
        self._by_key3 = {}
        self._by_rec_inset = {}
        for k, row in self.event_log.items():
            self._by_key3.setdefault(k[:3], set()).add(k)
            if k[4] is not None:
                self._by_rec_inset.setdefault((row["rec_op"], k[4]),
                                              set()).add(k)
        self._lin_by_out = {}
        self._lin_by_inset = {}
        for (eid, so, sp, ins) in self.lineage:
            self._index_lineage(eid, so, sp, ins)

    def _index_lineage(self, eid: int, so: str, sp: str, ins: str):
        self._lin_by_out.setdefault((so, sp, eid), []).append(ins)
        self._lin_by_inset.setdefault((so, ins), []).append((so, sp, eid))

    # -- commit ------------------------------------------------------------
    def _commit(self, ops):
        with self.lock:
            self._validate(ops)
            self._apply_ops(ops)
        return None

    # legacy entry point (kept for subclasses/tests applying raw op lists)
    def _apply(self, ops):
        return self._commit(ops)

    # -- shard protocol (ShardedLogStore composition) ----------------------
    def image(self) -> "MemoryLogStore":
        return self

    @property
    def shard_lock(self):
        return self.lock

    def _commit_routed(self, ops):
        """Apply a pre-validated op slice; caller holds ``shard_lock``."""
        self._apply_ops(ops)
        return None

    def apply_many(self, batches: List[List[Tuple]], epoch=None):
        """Apply a batch of already-committed transactions (group-commit
        flush / WAL replay): one lock acquisition, aborted ones skipped.
        ``epoch`` (2PC prepare tag) is meaningful only for durable inners;
        a memory inner is durable at apply."""
        with self.lock:
            for ops in batches:
                try:
                    self._validate(ops)
                except TxnAborted:
                    continue
                self._apply_ops(ops)

    # -- validation (conditional ops) => atomicity -------------------------
    def _has_inset_rows(self, rec_op: str, inset_id: str) -> bool:
        return bool(self._by_rec_inset.get((rec_op, inset_id)))

    def _has_event_rows(self, key, rec_op: Optional[str]) -> bool:
        keys = self._by_key3.get(key, ())
        if rec_op is None:
            return bool(keys)
        return any(k[3] == rec_op for k in keys)

    def _validate(self, ops):
        for op in ops:
            if op[0] == "set_inset_status" and op[4]:
                if not self._has_inset_rows(op[1], op[2]):
                    raise TxnAborted(
                        f"no EVENT_LOG rows for InSet {op[2]}@{op[1]}")
            elif op[0] == "assign_insets":
                if not self._has_event_rows(op[1], op[3]):
                    # event vanished (reassigned by a scale-down, Alg 13)
                    raise TxnAborted(f"no EVENT_LOG rows for {op[1]}")

    def _apply_ops(self, ops):
        for op in ops:
            self._apply_one(op)
        self.commits += 1

    # -- payload blobs -----------------------------------------------------
    def _make_blob(self, ev: Event):
        if self.eager_serialize:
            blob = pickle.dumps((ev.header, ev.body))
            self.bytes_written += len(blob)
            return blob
        return (_RAW, dict(ev.header), ev.body)

    @staticmethod
    def _load_blob(blob) -> Tuple[dict, Any]:
        if isinstance(blob, tuple) and blob and blob[0] is _RAW:
            return blob[1], blob[2]
        return pickle.loads(blob)

    def _log_event_row(self, ev: Event, status: str,
                       inset_id: Optional[str]):
        key = (ev.send_op, ev.send_port, ev.event_id, ev.rec_op, inset_id)
        self._add_row(key, {"status": status, "rec_op": ev.rec_op,
                            "rec_port": ev.rec_port, "inset": inset_id})

    def _set_status_rows(self, key, status, inset_id, rec_op, only_status):
        for k in list(self._by_key3.get(key, ())):
            if inset_id != "*" and k[4] != inset_id:
                continue
            if rec_op is not None and k[3] != rec_op:
                continue
            if only_status is not None and \
                    self.event_log[k]["status"] != only_status:
                continue
            self.event_log[k]["status"] = status

    def _apply_one(self, op):
        kind = op[0]
        if kind == "log_event":
            _, ev, status, inset_id = op
            self._log_event_row(ev, status, inset_id)
        elif kind == "log_events":
            # vectored run: rows stay individually keyed — only the op
            # framing (lock/WAL/frame/fsync amortization) is batched
            for ev, status, inset_id in op[1]:
                self._log_event_row(ev, status, inset_id)
        elif kind == "put_event_data":
            _, ev = op
            self.event_data[ev.key()] = self._make_blob(ev)
        elif kind == "put_event_blob":
            # pre-serialized payload (the transport's wire encode, shared):
            # stored verbatim — _load_blob handles pickled bytes natively
            _, key, _home, blob = op
            if not isinstance(blob, bytes):
                blob = bytes(blob)
            self.event_data[key] = blob
            if self.eager_serialize:
                self.bytes_written += len(blob)
        elif kind == "delete_event_data":
            self.event_data.pop(op[1], None)
        elif kind == "set_status":
            _, key, status, inset_id, rec_op, only_status = op
            self._set_status_rows(key, status, inset_id, rec_op, only_status)
        elif kind == "set_status_many":
            for key, status, inset_id, rec_op, only_status in op[1]:
                self._set_status_rows(key, status, inset_id, rec_op,
                                      only_status)
        elif kind == "assign_insets":
            _, key, insets, rec = op
            base = key + (rec, None)
            row = self.event_log.get(base)
            if row is None:
                row = next(self.event_log[k]
                           for k in self._by_key3.get(key, ())
                           if rec is None or k[3] == rec)
            for ins in insets:
                self._add_row(key + (rec, ins), dict(row, inset=ins))
            if insets:
                self._del_row(base)
        elif kind == "set_inset_status":
            _, rec_op, inset_id, status, _req = op
            for k in self._by_rec_inset.get((rec_op, inset_id), ()):
                self.event_log[k]["status"] = status
        elif kind == "clear_inset":
            pass   # event-state clearing is in-memory; log rows stay "done"
        elif kind == "put_state":
            _, op_id, state_id, blob, keep = op
            self.bytes_written += len(blob)
            hist = self.state.setdefault(op_id, [])
            if keep:
                hist.append((state_id, blob))
            else:
                self.state[op_id] = [(state_id, blob)]
        elif kind == "put_lineage":
            _, event_id, send_op, send_port, inset_id = op
            self.lineage.append((event_id, send_op, send_port, inset_id))
            self._index_lineage(event_id, send_op, send_port, inset_id)
        elif kind == "put_read_action":
            _, op_id, conn_id, action_id, status, desc = op
            self.read_actions[(op_id, conn_id, action_id)] = {
                "status": status, "desc": desc}
        elif kind == "set_read_action_status":
            _, op_id, conn_id, action_id, status = op
            k = (op_id, conn_id, action_id)
            if k in self.read_actions:
                self.read_actions[k]["status"] = status
        elif kind == "delete_event_rows":
            _, key = op
            for k in list(self._by_key3.get(key, ())):
                self._del_row(k)
        elif kind == "reassign_event":
            # Alg 13 step 1.c: move an undone event to a new destination
            # (+ new event id); rows already done/acked->done are skipped.
            _, old_key, old_rec, new_key, tgt_op, tgt_port = op
            moved = self._del_undone_rows(old_key, old_rec)
            if moved:
                self._ins_row(new_key + (tgt_op, None), tgt_op, tgt_port)
                blob = self.event_data.pop(old_key, None)
                if blob is not None:
                    self.event_data[new_key] = blob
        # micro-ops: a sharded store decomposes reassign_event into these so
        # the delete and the insert can land in different shards
        elif kind == "_del_undone":
            self._del_undone_rows(op[1], op[2])
        elif kind == "_ins_row":
            _, key5, tgt_op, tgt_port = op
            self._ins_row(key5, tgt_op, tgt_port)
        elif kind == "_put_blob":
            self.event_data[op[1]] = op[2]

    def _del_undone_rows(self, old_key, old_rec) -> bool:
        moved = False
        for k in list(self._by_key3.get(old_key, ())):
            if (old_rec is None or k[3] == old_rec) \
                    and self.event_log[k]["status"] == UNDONE:
                self._del_row(k)
                moved = True
        return moved

    def _ins_row(self, key5, tgt_op, tgt_port):
        self._add_row(key5, {"status": UNDONE, "rec_op": tgt_op,
                             "rec_port": tgt_port, "inset": None})

    # -- image transfer (group-commit crash rebuild) -----------------------
    def load_image(self, src: "MemoryLogStore"):
        """Replace this store's tables with a copy of ``src``'s."""
        with self.lock, src.lock:
            self.event_log = {k: dict(r) for k, r in src.event_log.items()}
            self.event_data = dict(src.event_data)
            self.read_actions = {k: dict(v)
                                 for k, v in src.read_actions.items()}
            self.state = {k: list(v) for k, v in src.state.items()}
            self.lineage = list(src.lineage)
            self._ssn_floor = dict(src._ssn_floor)
            self._ack_floor = dict(src._ack_floor)
            self._reindex()

    # -- queries ----------------------------------------------------------
    def _mk_event(self, k, r) -> Event:
        header, body = ({}, None)
        blob = self.event_data.get(k[:3])
        if blob is not None:
            header, body = self._load_blob(blob)
        return Event(event_id=k[2], send_op=k[0], send_port=k[1],
                     rec_op=r["rec_op"], rec_port=r["rec_port"],
                     body=body, header=dict(header))

    def fetch_resend_events(self, op_id: str) -> List[Tuple[Event, str]]:
        with self.lock:
            rows = [(k, r) for k, r in self.event_log.items()
                    if k[0] == op_id and r["status"] in (UNDONE, REPLAY)
                    and k[4] is None and k[1] is not None
                    and r["rec_port"] is not None]
            rows.sort(key=lambda kr: kr[0][2])
            return [(self._mk_event(k, r), r["status"]) for k, r in rows]

    def fetch_ack_events(self, op_id: str, include_done: bool = False
                         ) -> List[Tuple[Event, str, str]]:
        """Returns [(event, inset_id, status)] ordered by (rec_port,
        event_id)."""
        statuses = (UNDONE, REPLAY, DONE) if include_done \
            else (UNDONE, REPLAY)
        with self.lock:
            rows = [(k, r) for k, r in self.event_log.items()
                    if r["rec_op"] == op_id and r["status"] in statuses
                    and k[4] is not None]
            rows.sort(key=lambda kr: (kr[1]["rec_port"] or "", kr[0][2]))
            return [(self._mk_event(k, r), k[4], r["status"])
                    for k, r in rows]

    def fetch_replay_outputs(self, op_id: str) -> List[Tuple[int, str, str]]:
        with self.lock:
            return sorted((k[2], k[1], r["status"])
                          for k, r in self.event_log.items()
                          if k[0] == op_id and k[1] is not None
                          and r["status"] == REPLAY
                          and r["rec_port"] is not None)

    def undone_outputs_after(self, op_id: str, port: str, min_id: int
                             ) -> List[int]:
        with self.lock:
            return sorted({k[2] for k, r in self.event_log.items()
                           if k[0] == op_id and k[1] == port
                           and r["status"] == UNDONE and k[2] >= min_id})

    def get_write_actions(self, op_id: str) -> List[Event]:
        with self.lock:
            rows = [(k, r) for k, r in self.event_log.items()
                    if k[0] == op_id and k[1] is None
                    and r["status"] == UNDONE]
            rows.sort(key=lambda kr: kr[0][2])
            return [self._mk_event(k, r) for k, r in rows]

    def get_state(self, op_id: str) -> Optional[bytes]:
        with self.lock:
            hist = self.state.get(op_id)
            return hist[-1][1] if hist else None

    def last_sent_ssn(self, op_id: str) -> Dict[str, int]:
        with self.lock:
            out: Dict[str, int] = {}
            for (o, p), ssn in self._ssn_floor.items():
                if o == op_id:
                    out[p] = ssn
            for k in self.event_log:
                if k[0] == op_id and k[1] is not None:
                    out[k[1]] = max(out.get(k[1], -1), k[2])
            return out

    def last_acked(self, op_id: str) -> Dict[str, int]:
        with self.lock:
            out: Dict[str, int] = {}
            for (o, p), eid in self._ack_floor.items():
                if o == op_id:
                    out[p] = eid
            for k, r in self.event_log.items():
                if r["rec_op"] == op_id and k[4] is not None:
                    p = r["rec_port"]
                    out[p] = max(out.get(p, -1), k[2])
            return out

    def event_status(self, key, rec_op: Optional[str] = None
                     ) -> List[Tuple[Optional[str], str]]:
        with self.lock:
            return [(k[4], self.event_log[k]["status"])
                    for k in self._by_key3.get(key, ())
                    if rec_op is None or k[3] == rec_op]

    def get_read_action(self, op_id: str, conn_id: str):
        with self.lock:
            cands = [(k, v) for k, v in self.read_actions.items()
                     if k[0] == op_id and k[1] == conn_id]
            if not cands:
                return None, None
            k, v = max(cands, key=lambda kv: kv[0][2])
            return k[2], dict(v)

    # scaling queries ----------------------------------------------------
    def undone_events_from(self, send_op: str, rec_op: str) -> List[Tuple]:
        with self.lock:
            return sorted({k[:3] for k, r in self.event_log.items()
                           if k[0] == send_op and r["rec_op"] == rec_op
                           and r["status"] == UNDONE},
                          key=lambda key: key[2])

    # lineage queries ----------------------------------------------------
    # The unfiltered ops are the paper's Sec. 7.3 reads, kept as deliberate
    # full scans: they are the honest "no pushdown" baseline the benchmark
    # compares against. The query_* variants below answer the same questions
    # through the secondary indexes. Both report scan effort via query_stats.

    def lineage_insets_of(self, event_key) -> List[str]:
        send_op, send_port, event_id = event_key
        with self.lock:
            self._qstats["rows_scanned"] += len(self.lineage)
            out = [ins for (eid, so, sp, ins) in self.lineage
                   if (so, sp, eid) == (send_op, send_port, event_id)]
            self._qstats["rows_returned"] += len(out)
            return out

    def lineage_events_of_inset(self, rec_op: str, inset_id: str
                                ) -> List[Tuple]:
        with self.lock:
            self._qstats["rows_scanned"] += len(self.event_log)
            out = sorted(k[:3] for k, r in self.event_log.items()
                         if r["rec_op"] == rec_op
                         and r.get("inset") == inset_id)
            self._qstats["rows_returned"] += len(out)
            return out

    def lineage_outputs_of_inset(self, send_op: str, inset_id: str
                                 ) -> List[Tuple]:
        with self.lock:
            self._qstats["rows_scanned"] += len(self.lineage)
            out = sorted((so, sp, eid) for (eid, so, sp, ins) in self.lineage
                         if so == send_op and ins == inset_id)
            self._qstats["rows_returned"] += len(out)
            return out

    def insets_of_event(self, event_key, rec_op: str) -> List[str]:
        with self.lock:
            self._qstats["rows_scanned"] += len(self.event_log)
            out = [k[4] for k, r in self.event_log.items()
                   if k[:3] == event_key and k[3] == rec_op
                   and k[4] is not None]
            self._qstats["rows_returned"] += len(out)
            return out

    def consumers_of(self, event_key) -> List[str]:
        with self.lock:
            self._qstats["rows_scanned"] += len(self.event_log)
            out = sorted({r["rec_op"] for k, r in self.event_log.items()
                          if k[:3] == event_key and r["rec_op"] is not None})
            self._qstats["rows_returned"] += len(out)
            return out

    # filtered lineage queries (native pushdown) -------------------------
    supports_query_pushdown = True

    def _count(self, scanned: int, out):
        self._qstats["rows_scanned"] += scanned
        self._qstats["rows_returned"] += len(out)
        return out

    def query_lineage_insets(self, event_key,
                             flt: Optional[LineageFilter] = None
                             ) -> List[str]:
        k3 = tuple(event_key)
        if flt is not None and not flt.matches(k3[0], k3[1], k3[2]):
            return []
        with self.lock:
            out = list(self._lin_by_out.get(k3, ()))
            return self._count(len(out), out)

    def query_inset_events(self, rec_op: str, inset_id: str,
                           flt: Optional[LineageFilter] = None
                           ) -> List[Tuple]:
        with self.lock:
            keys = self._by_rec_inset.get((rec_op, inset_id), ())
            out = sorted(k[:3] for k in keys
                         if flt is None or flt.matches(k[0], k[1], k[2]))
            return self._count(len(keys), out)

    def query_inset_outputs(self, send_op: str, inset_id: str,
                            flt: Optional[LineageFilter] = None
                            ) -> List[Tuple]:
        with self.lock:
            keys = self._lin_by_inset.get((send_op, inset_id), ())
            out = sorted(k for k in keys
                         if flt is None or flt.matches(k[0], k[1], k[2]))
            return self._count(len(keys), out)

    def query_event_insets(self, event_key, rec_op: str,
                           flt: Optional[LineageFilter] = None
                           ) -> List[str]:
        k3 = tuple(event_key)
        if flt is not None and not flt.matches(k3[0], k3[1], k3[2]):
            return []
        with self.lock:
            keys = self._by_key3.get(k3, ())
            out = [k[4] for k in keys if k[3] == rec_op and k[4] is not None]
            return self._count(len(keys), out)

    def query_consumers(self, event_key,
                        flt: Optional[LineageFilter] = None) -> List[str]:
        with self.lock:
            keys = self._by_key3.get(tuple(event_key), ())
            recs = {k[3] for k in keys if k[3] is not None}
            if flt is not None and flt.ops is not None:
                recs &= flt.ops
            return self._count(len(keys), sorted(recs))

    def query_lineage(self, flt: Optional[LineageFilter] = None
                      ) -> List[Tuple]:
        """Bulk audit scan over EVENT_LINEAGE. With an ``ops`` filter the
        scan walks only those senders' inset buckets; otherwise it walks the
        full lineage list."""
        with self.lock:
            if flt is not None and flt.ops is not None:
                scanned = 0
                out = []
                for (so, ins), keys in self._lin_by_inset.items():
                    if so not in flt.ops:
                        continue
                    scanned += len(keys)
                    out.extend((so2, sp, eid, ins)
                               for (so2, sp, eid) in keys
                               if flt.matches(so2, sp, eid))
                return self._count(scanned, sorted(out))
            out = [(so, sp, eid, ins) for (eid, so, sp, ins) in self.lineage
                   if flt is None or flt.matches(so, sp, eid)]
            return self._count(len(self.lineage), sorted(out))

    def get_event_payload(self, event_key):
        with self.lock:
            blob = self.event_data.get(tuple(event_key))
            if blob is None:
                return None
            return self._load_blob(blob)

    def _query_stats(self) -> Dict[str, int]:
        with self.lock:
            return dict(self._qstats)

    def reset_query_stats(self):
        with self.lock:
            for k in self._qstats:
                self._qstats[k] = 0

    # GC (Sec. 3.6) --------------------------------------------------------
    def gc(self, lineage_ops: Iterable[str] = (),
           keep_rows: Optional[bool] = None):
        """``keep_rows`` overrides the "lineage exists => keep rows" guard —
        a sharded store must evaluate it globally, not per shard (lineage
        rows live only in the producing operator's shard)."""
        keep_data_for = set(lineage_ops)
        with self.lock:
            if keep_rows is None:
                keep_rows = bool(self.lineage)
            for k, r in list(self.event_log.items()):
                if r["status"] == DONE and k[0] not in keep_data_for:
                    # the payload serves every receiver of the event: drop
                    # it only once ALL rows for the key are done, or a
                    # straggling receiver would recover an empty body
                    if all(self.event_log[k2]["status"] == DONE
                           for k2 in self._by_key3.get(k[:3], ())):
                        self.event_data.pop(k[:3], None)
                    if not keep_rows:
                        self._del_row(k)


# ---------------------------------------------------------------------------
# Null backend — the benchmarks' "execution baseline" (no rollback recovery)
# ---------------------------------------------------------------------------

class NullLogStore(MemoryLogStore):
    """No-op store: pipelines run with zero logging (no recovery possible).
    Used to measure the paper's 'execution baseline' (Sec. 9.3.1)."""

    def _commit(self, ops):
        return None
