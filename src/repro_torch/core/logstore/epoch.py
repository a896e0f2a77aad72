"""Global flush epochs: lightweight 2PC for multi-shard group commits.

The sharded+group stack used to flush behind a coordinated barrier (every
shard lock held while every shard did its I/O) so that a multi-shard
transaction could never end up half-durable. That serializes all commits
against the flush I/O and cannot extend across process boundaries. The
epoch protocol replaces it:

  1. the flush coordinator assigns a fresh **epoch id** and, under a brief
     exclusive *epoch barrier* (no I/O — just list swaps), cuts every
     shard's pending batch.  Commits hold the barrier shared, so no
     transaction can straddle the cut: each txn is entirely inside or
     entirely after the epoch.
  2. **prepare**: each shard persists its cut batch tagged with the epoch
     id (for a SQLite shard: one SQLite transaction inserting the WAL rows
     with an ``epoch`` column).  Prepared rows are durable but
     *conditional* — they count only if the epoch commits.
  3. **commit point**: one durable epoch-commit record is written by the
     :class:`EpochCoordinator`.  This single write makes the whole
     multi-shard flush atomic.
  4. each shard advances its durability watermark past the epoch's tokens.

On restart (or simulated ``crash()``), prepared-but-uncommitted epochs are
rolled back — shards discard WAL rows whose epoch has no commit record —
so a crash anywhere in the protocol leaves no multi-shard transaction
half-durable, and flush I/O runs without holding any shard lock.
"""
from __future__ import annotations

import contextlib
import sqlite3
import threading
from typing import Optional, Set


class ReadWriteLock:
    """Writer-preferring RW lock. Commits hold it shared (many at once);
    the epoch cut phase holds it exclusive — but only for list swaps, never
    for I/O, so the exclusive window is tiny."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0

    def acquire_read(self):
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1

    def release_read(self):
        with self._cond:
            self._readers -= 1
            if self._readers == 0:
                self._cond.notify_all()

    def acquire_write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
            finally:
                self._writers_waiting -= 1
            self._writer = True

    def release_write(self):
        with self._cond:
            self._writer = False
            self._cond.notify_all()

    @contextlib.contextmanager
    def read(self):
        self.acquire_read()
        try:
            yield
        finally:
            self.release_read()

    @contextlib.contextmanager
    def write(self):
        self.acquire_write()
        try:
            yield
        finally:
            self.release_write()


class EpochCoordinator:
    """In-memory epoch coordinator: the committed-epoch set *is* the
    durable epoch-commit record (it survives ``crash()`` by construction,
    mirroring how the memory group-commit store simulates its durable
    medium with the flushed-op history)."""

    def __init__(self):
        self.lock = threading.Lock()
        self._next = 1
        self._committed: Set[int] = set()

    def next_epoch(self) -> int:
        with self.lock:
            eid = self._next
            self._next += 1
            return eid

    def commit_epoch(self, epoch_id: int):
        """The commit point: one durable record makes the epoch atomic."""
        with self.lock:
            self._committed.add(epoch_id)

    def is_committed(self, epoch_id: int) -> bool:
        with self.lock:
            return epoch_id in self._committed

    def crash(self):
        """Commit records are durable; assigned-but-uncommitted epoch ids
        are simply never committed (their prepared batches roll back)."""

    def close(self):
        pass


class SqliteEpochCoordinator(EpochCoordinator):
    """Durable coordinator: epoch-commit records live in their own SQLite
    file next to the shard files. ``commit_epoch`` is one INSERT+COMMIT —
    the single durable write of the protocol's commit point."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self.conn = sqlite3.connect(path, check_same_thread=False)
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS epochs (epoch_id INTEGER PRIMARY KEY)")
        self.conn.commit()
        rows = self.conn.execute("SELECT epoch_id FROM epochs").fetchall()
        self._committed = {r[0] for r in rows}
        self._next = max(self._committed, default=0) + 1

    def commit_epoch(self, epoch_id: int):
        with self.lock:
            self.conn.execute(
                "INSERT OR IGNORE INTO epochs (epoch_id) VALUES (?)",
                (epoch_id,))
            self.conn.commit()
            self._committed.add(epoch_id)

    def crash(self):
        """Simulated process crash: reload the committed set from disk (it
        is durable; uncommitted ids vanish with the process)."""
        with self.lock:
            self.conn.close()
            self.conn = sqlite3.connect(self.path, check_same_thread=False)
            rows = self.conn.execute("SELECT epoch_id FROM epochs").fetchall()
            self._committed = {r[0] for r in rows}
            self._next = max(self._committed, default=0) + 1

    def close(self):
        self.conn.close()


def make_coordinator(base: str, path: Optional[str] = None) -> EpochCoordinator:
    """Coordinator matching a ``build_store`` base: durable (sqlite /
    segment) bases get a durable commit record; memory bases get the
    simulated one."""
    if base in ("sqlite", "segment"):
        if path is None:
            raise ValueError(f"{base} epoch coordinator needs a path")
        return SqliteEpochCoordinator(path)
    return EpochCoordinator()
