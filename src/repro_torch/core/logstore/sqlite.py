"""Durable SQLite backend — same txn interface as the in-memory store.

Stands in for the HANA instance of the paper's implementation (Sec. 6.1);
used by the e2e training example and the durability tests.

Implementation note: we reuse the in-memory application logic for the
mutation semantics but persist every commit as one SQLite transaction, and
rebuild the in-memory image from disk on open ⇒ genuine durability with the
exact in-memory read paths. ``apply_many`` persists a whole group-commit
batch under a single SQLite transaction — the group-commit throughput win.

Global flush epochs (see ``logstore/epoch.py``): when the store is a shard
of an epoch-flushing stack, ``apply_many`` tags the batch's WAL rows with
the flush epoch id. Epoch-tagged rows are 2PC *prepare* records: durable
but conditional on the coordinator's epoch-commit record. On open (real
restart) and on ``crash()`` (simulated one), rows of epochs that never
committed are rolled back — deleted from the WAL — before the image is
rebuilt, so a crash between prepare and epoch commit leaves no multi-shard
transaction half-durable.
"""
from __future__ import annotations

import pickle
import sqlite3
from typing import List, Optional, Tuple

from repro_torch.core.logstore.base import LineageFilter, TxnAborted
from repro_torch.core.logstore.memory import MemoryLogStore


class SqliteLogStore(MemoryLogStore):

    def __init__(self, path: str, epoch_coord=None):
        super().__init__(eager_serialize=True)
        self.path = path
        self.epoch_coord = epoch_coord
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS wal_ops (seq INTEGER PRIMARY KEY "
            "AUTOINCREMENT, blob BLOB, epoch INTEGER)")
        # EVENT_LINEAGE mirror: put_lineage ops land here relationally (in
        # the same SQLite txn as their WAL row) so the filtered query ops
        # run as indexed SQL WHERE instead of scanning the log image.
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS lineage (eid INTEGER, sop TEXT, "
            "sport TEXT, inset TEXT, epoch INTEGER)")
        self.conn.execute(
            "CREATE INDEX IF NOT EXISTS lineage_out ON lineage "
            "(sop, sport, eid)")
        self.conn.execute(
            "CREATE INDEX IF NOT EXISTS lineage_inset ON lineage "
            "(sop, inset)")
        self.conn.commit()
        self._rollback_uncommitted_epochs()
        self._replay_from_disk()

    def _rollback_uncommitted_epochs(self):
        """Delete prepare records whose flush epoch never committed (the
        restart half of the 2PC protocol)."""
        if self.epoch_coord is None:
            return
        epochs = [e for (e,) in self.conn.execute(
            "SELECT DISTINCT epoch FROM wal_ops WHERE epoch IS NOT NULL")
            if not self.epoch_coord.is_committed(e)]
        if epochs:
            self.conn.executemany("DELETE FROM wal_ops WHERE epoch = ?",
                                  [(e,) for e in epochs])
            self.conn.executemany("DELETE FROM lineage WHERE epoch = ?",
                                  [(e,) for e in epochs])
            self.conn.commit()

    def _replay_from_disk(self):
        cur = self.conn.execute("SELECT blob FROM wal_ops ORDER BY seq")
        for (blob,) in cur.fetchall():
            ops = pickle.loads(blob)
            try:
                self._validate(ops)
            except TxnAborted:
                continue
            self._apply_ops(ops)

    def _persist(self, ops, epoch: Optional[int] = None):
        """Apply one txn's ops and stage its WAL row; caller commits. The
        lineage mirror is staged here (not in WAL replay) so reopening the
        store never double-inserts rows."""
        blob = pickle.dumps(ops)
        self._apply_ops(ops)
        self.conn.execute("INSERT INTO wal_ops (blob, epoch) VALUES (?, ?)",
                          (blob, epoch))
        lin = [(op[1], op[2], op[3], op[4], epoch) for op in ops
               if op[0] == "put_lineage"]
        if lin:
            self.conn.executemany(
                "INSERT INTO lineage (eid, sop, sport, inset, epoch) "
                "VALUES (?, ?, ?, ?, ?)", lin)
        self.bytes_written += len(blob)

    def _commit(self, ops):
        with self.lock:
            self._validate(ops)
            self._persist(ops)
            self.conn.commit()                    # durable point
        return None

    def _commit_routed(self, ops):
        self._persist(ops)
        self.conn.commit()
        return None

    def apply_many(self, batches: List[List[Tuple]],
                   epoch: Optional[int] = None):
        """One SQLite transaction for the whole batch (group commit). With
        ``epoch`` this is the 2PC prepare: rows are durable but count only
        once the epoch-commit record lands."""
        with self.lock:
            for ops in batches:
                try:
                    self._validate(ops)
                except TxnAborted:
                    continue
                self._persist(ops, epoch=epoch)
            self.conn.commit()                    # durable point, once
        return None

    # filtered lineage queries: SQL WHERE over the indexed mirror ---------
    @staticmethod
    def _flt_sql(flt: Optional[LineageFilter]) -> Tuple[str, list]:
        """Translate a LineageFilter into SQL predicate fragments — the
        predicate runs inside SQLite (index-driven), not over fetched rows."""
        conds, params = [], []
        if flt is None:
            return "", params
        if flt.ops is not None:
            conds.append(f"sop IN ({','.join('?' * len(flt.ops))})")
            params.extend(sorted(flt.ops))
        if flt.ports is not None:
            conds.append(f"sport IN ({','.join('?' * len(flt.ports))})")
            params.extend(sorted(flt.ports))
        if flt.ssn_min is not None:
            conds.append("eid >= ?")
            params.append(flt.ssn_min)
        if flt.ssn_max is not None:
            conds.append("eid <= ?")
            params.append(flt.ssn_max)
        return (" AND " + " AND ".join(conds)) if conds else "", params

    def query_lineage_insets(self, event_key,
                             flt: Optional[LineageFilter] = None
                             ) -> List[str]:
        so, sp, eid = tuple(event_key)
        if flt is not None and not flt.matches(so, sp, eid):
            return []
        with self.lock:
            rows = self.conn.execute(
                "SELECT inset FROM lineage WHERE sop = ? AND sport = ? "
                "AND eid = ?", (so, sp, eid)).fetchall()
            return self._count(len(rows), [ins for (ins,) in rows])

    def query_inset_outputs(self, send_op: str, inset_id: str,
                            flt: Optional[LineageFilter] = None
                            ) -> List[Tuple]:
        extra, params = self._flt_sql(flt)
        with self.lock:
            rows = self.conn.execute(
                "SELECT sop, sport, eid FROM lineage WHERE sop = ? "
                "AND inset = ?" + extra, [send_op, inset_id] + params
            ).fetchall()
            return self._count(len(rows), sorted(tuple(r) for r in rows))

    def query_lineage(self, flt: Optional[LineageFilter] = None
                      ) -> List[Tuple]:
        extra, params = self._flt_sql(flt)
        where = ("WHERE " + extra[5:]) if extra else ""
        with self.lock:
            rows = self.conn.execute(
                f"SELECT sop, sport, eid, inset FROM lineage {where}",
                params).fetchall()
            return self._count(len(rows), sorted(tuple(r) for r in rows))

    def crash(self):
        """Simulated process crash: the durable medium (the SQLite file)
        survives; roll back uncommitted prepare records and rebuild the
        image from disk exactly as a real restart would."""
        with self.lock:
            self.conn.rollback()     # anything un-committed dies with us
            self._rollback_uncommitted_epochs()
            self.event_log = {}
            self.event_data = {}
            self.read_actions = {}
            self.state = {}
            self.lineage = []
            self._reindex()
            self._replay_from_disk()

    def close(self):
        self.conn.close()
