"""Group-commit transaction pipelining (commit batching).

The paper's evaluation (Sec. 9) shows per-event pessimistic logging is
LOG.io's overhead driver at high throughput; write-ahead lineage capture
with batched/asynchronous flushing (arXiv:2403.08062) closes that gap
without giving up recoverability. ``GroupCommitStore`` applies that idea at
the log-store layer:

  * ``commit`` validates + applies the transaction to a *speculative view*
    immediately (non-blocking — the operator keeps processing) and enqueues
    the ops into the pending batch; it returns an integer durability token.
  * the pending batch is flushed to the durable inner backend when a
    size/time watermark is reached (``batch_size`` txns or ``interval``
    seconds), advancing the durability watermark; a flush of a SQLite inner
    store is ONE SQLite transaction for the whole batch.
  * the **durability-watermark rule**: externally visible effects — channel
    acks and external-system writes — may only be released once
    ``is_durable(token)`` is true. The operator runtime defers them
    (``OperatorRuntime.drain_durable``), which preserves exactly-once
    recovery semantics while commits pipeline.
  * ``crash()`` simulates a full-process failure: the pending batch is lost
    and the view is rebuilt from the durable image — a crash between
    flushes loses exactly the unflushed batch.
  * as a shard of an epoch-flushing :class:`ShardedLogStore`, the store
    additionally speaks the global-flush-epoch protocol (see
    ``logstore/epoch.py``): ``cut_pending`` snapshots the batch under an
    epoch id, ``persist_prepared`` writes it to the durable medium tagged
    with the epoch (prepare: durable but conditional), and ``finish_epoch``
    advances the durability watermark once the coordinator has committed
    the epoch. A crash rolls back prepared-but-uncommitted epochs.

Without an inner backend the durable image is simulated by retaining the
flushed op history (the moral equivalent of the SQLite WAL, in memory);
engine-level pod failures never lose the store either way.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from repro_torch.core.logstore.base import LogBackend, TxnAborted
from repro_torch.core.logstore.memory import MemoryLogStore


class GroupCommitStore(LogBackend):

    def __init__(self, inner: Optional[LogBackend] = None, *,
                 batch_size: int = 64, interval: float = 0.005,
                 epoch_coord=None):
        self.inner = inner
        self.batch_size = batch_size
        self.interval = interval
        self.epoch_coord = epoch_coord
        self.view = MemoryLogStore(eager_serialize=False)
        if inner is not None:
            # warm restart over a pre-existing durable image (e.g. a SQLite
            # file from before a process crash): serve it from the view
            self.view.load_image(inner)
        self._pending: List[Tuple[int, List[Tuple]]] = []   # (token, ops)
        self._first_ts: Optional[float] = None
        # epoch_id -> cut-but-not-yet-committed batch (2PC prepare buffer)
        self._prepared: Dict[int, List[Tuple[int, List[Tuple]]]] = {}
        self._durable_history: List[List[Tuple]] = []   # inner=None only
        self.commit_seq = 0
        self.durable_seq = 0
        self._lost_tokens: set = set()      # commits dropped by crash()
        self.flushes = 0
        # async flush I/O: commits enqueue + nudge; the flusher thread owns
        # the inner-backend writes (io-overlap — the operator thread never
        # blocks on fsync).  Serialized against explicit flush()/crash()/
        # checkpoint() by _flush_serial (RLock: checkpoint calls flush).
        # Lock order everywhere: _flush_serial -> view.lock.
        self._flush_serial = threading.RLock()
        self._flush_wake = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._flusher_stop = False

    # ---- commit (speculative apply + enqueue) ---------------------------
    def _commit(self, ops):
        with self.view.lock:
            self.view._validate(ops)
            first = not self._pending
            token = self._commit_routed(ops)
            nudge = first or self._watermark_reached()
        # standalone store only: as a shard of an epoch-flushing
        # ShardedLogStore, commits arrive via _commit_routed and the
        # sharded store's epoch flusher owns all flush I/O
        if self._flusher is None:
            self._ensure_flusher()
        if nudge:
            self._flush_wake.set()
        return token

    def _ensure_flusher(self):
        with self.view.lock:
            if self._flusher is None and not self._flusher_stop:
                t = threading.Thread(target=self._flusher_loop, daemon=True,
                                     name="group-commit-flusher")
                self._flusher = t
                t.start()

    def _flusher_loop(self):
        while True:
            ts = self._first_ts
            timeout = None if ts is None else \
                max(0.0, ts + self.interval - time.monotonic())
            self._flush_wake.wait(timeout)
            self._flush_wake.clear()
            if self._flusher_stop:
                return
            if self._watermark_reached():
                self.flush()

    def _commit_routed(self, ops) -> int:
        """Shard-protocol entry: caller holds ``shard_lock`` and has
        already validated the ops against this shard's image."""
        self.view._apply_ops(ops)
        self.commit_seq += 1
        self._pending.append((self.commit_seq, ops))
        if self._first_ts is None:
            self._first_ts = time.monotonic()
        return self.commit_seq

    def _watermark_reached(self) -> bool:
        # callers may probe without the lock: snapshot the fields once so a
        # concurrent flush() nulling them cannot blow up mid-expression
        pending = self._pending
        if not pending:
            return False
        if len(pending) >= self.batch_size:
            return True
        ts = self._first_ts
        # monotonic, not wall-clock: an NTP step must neither stall the
        # interval watermark forever nor fire it spuriously
        return ts is not None and time.monotonic() - ts >= self.interval

    # ---- durability ------------------------------------------------------
    def is_durable(self, token) -> bool:
        return token is None or \
            (token <= self.durable_seq and token not in self._lost_tokens)

    def flush(self):
        with self._flush_serial:
            with self.view.lock:
                batch, self._pending = self._pending, []
                self._first_ts = None
            if not batch:
                return
            ops_lists = [ops for _, ops in batch]
            # the inner-backend write runs OUTSIDE view.lock: commits keep
            # applying to the speculative view while the I/O is in flight
            # (_flush_serial keeps concurrent flushes from reordering)
            if self.inner is not None:
                self.inner.apply_many(ops_lists)
            else:
                self._durable_history.extend(ops_lists)
            with self.view.lock:
                # the watermark is the last flushed token — tokens are never
                # reused, so commits lost in a crash() stay non-durable
                self.durable_seq = max(self.durable_seq, batch[-1][0])
                self.flushes += 1

    def maybe_flush(self):
        # racy fast path: flush() re-checks under the lock.  With the
        # flusher running this is just a nudge — the caller (the operator
        # loop's drain_durable) never blocks on flush I/O.
        if self._watermark_reached():
            if self._flusher is not None and not self._flusher_stop:
                self._flush_wake.set()
            else:
                self.flush()

    # ---- global flush epochs (2PC shard side; see logstore/epoch.py) -----
    def cut_pending(self, epoch_id: int) -> List[Tuple[int, List[Tuple]]]:
        """Phase 1a: atomically cut the pending batch under the epoch id.
        Called under the sharded store's exclusive epoch barrier — no
        transaction can straddle the cut. No I/O here."""
        with self.view.lock:
            batch, self._pending = self._pending, []
            self._first_ts = None
            if batch:
                self._prepared[epoch_id] = batch
            return batch

    def persist_prepared(self, epoch_id: int):
        """Phase 1b (prepare): persist the cut batch tagged with the epoch.
        Durable but conditional — it only counts if the epoch commits.
        Runs WITHOUT any shard lock (the I/O is off the commit path)."""
        batch = self._prepared.get(epoch_id)
        if batch and self.inner is not None:
            self.inner.apply_many([ops for _, ops in batch], epoch=epoch_id)
        # inner=None: the prepare buffer itself plays the conditional
        # durable medium; crash() consults the coordinator's verdict.

    def finish_epoch(self, epoch_id: int):
        """Phase 2: the coordinator committed the epoch — advance the
        durability watermark past the epoch's tokens."""
        with self.view.lock:
            batch = self._prepared.pop(epoch_id, None)
            if not batch:
                return
            if self.inner is None:
                self._durable_history.extend(ops for _, ops in batch)
            self.durable_seq = max(self.durable_seq, batch[-1][0])
            self.flushes += 1

    def crash(self):
        """Full-process crash: lose the unflushed batch, roll back
        prepared-but-uncommitted epochs, rebuild the view from the durable
        image (prepared batches of *committed* epochs are durable — the
        epoch-commit record is the atomicity point).  Holding
        ``_flush_serial`` first parks the crash at a flush-protocol
        quiescent point: an in-flight async flush either completed (its
        batch is durable) or never started (its batch is lost) — never
        half-applied."""
        with self._flush_serial, self.view.lock:
            # tokens of the lost commits must never read as durable, even
            # once later commits push the watermark past their numbers
            self._lost_tokens.update(t for t, _ in self._pending)
            self._pending = []
            self._first_ts = None
            for eid, batch in sorted(self._prepared.items()):
                if self.epoch_coord is not None and \
                        self.epoch_coord.is_committed(eid):
                    # committed before the crash: the prepared batch is
                    # durable even though finish_epoch never ran
                    if self.inner is None:
                        self._durable_history.extend(ops for _, ops in batch)
                    self.durable_seq = max(self.durable_seq, batch[-1][0])
                else:
                    self._lost_tokens.update(t for t, _ in batch)
            self._prepared = {}
            fresh = MemoryLogStore(eager_serialize=False)
            if self.inner is not None:
                self.inner.crash()
                fresh.load_image(self.inner)
            else:
                for ops in self._durable_history:
                    try:
                        fresh._validate(ops)
                    except TxnAborted:
                        continue
                    fresh._apply_ops(ops)
            self.view = fresh

    def _stop_flusher(self):
        self._flusher_stop = True
        self._flush_wake.set()
        t = self._flusher
        if t is not None and t is not threading.current_thread():
            t.join(timeout=2.0)
        self._flusher = None

    def close(self):
        self._stop_flusher()
        self.flush()
        if self.inner is not None:
            self.inner.close()

    # ---- checkpoint compaction (forwarded to a durable inner) ------------
    @property
    def supports_checkpoint(self):
        return getattr(self.inner, "supports_checkpoint", False)

    def checkpoint_due(self):
        return self.inner is not None and self.inner.checkpoint_due()

    def checkpoint(self):
        """Flush the pending batch (so the checkpoint covers every durable
        commit), compact the inner store, then truncate the view the same
        way. NOT epoch-safe: a shard of an epoch-flushing ShardedLogStore
        is checkpointed via ``ShardedLogStore.checkpoint`` instead, which
        runs the epoch protocol and then calls ``_checkpoint_inner``."""
        if not self.supports_checkpoint:
            return
        with self._flush_serial:        # no async flush mid-compaction
            self.flush()
            self._checkpoint_inner()

    def _checkpoint_inner(self, keep_rows=None):
        """Compact the durable inner and mirror the truncation into the
        speculative view (floors + GC), keeping the two read images
        aligned. Caller has already made the pending work durable."""
        self.inner.compact(keep_rows=keep_rows)
        with self.view.lock:
            self.view._ssn_floor = dict(self.inner._ssn_floor)
            self.view._ack_floor = dict(self.inner._ack_floor)
            self.view.gc(self.gc_protect, keep_rows=keep_rows)

    def maybe_checkpoint(self):
        if self.checkpoint_due():
            self.checkpoint()

    def set_gc_protect(self, ops):
        self.gc_protect = frozenset(ops)
        if self.inner is not None:
            self.inner.set_gc_protect(ops)

    def recovery_replay_count(self):
        return self.inner.recovery_replay_count() \
            if self.inner is not None else 0

    # ---- shard protocol --------------------------------------------------
    def image(self) -> MemoryLogStore:
        return self.view

    @property
    def shard_lock(self):
        return self.view.lock

    # ---- bookkeeping -----------------------------------------------------
    @property
    def commits(self):
        return self.view.commits

    @property
    def bytes_written(self):
        return self.view.bytes_written + \
            (self.inner.bytes_written if self.inner is not None else 0)

    # ---- queries: the speculative view is the read image ----------------
    def fetch_resend_events(self, op_id):
        return self.view.fetch_resend_events(op_id)

    def fetch_ack_events(self, op_id, include_done=False):
        return self.view.fetch_ack_events(op_id, include_done=include_done)

    def fetch_replay_outputs(self, op_id):
        return self.view.fetch_replay_outputs(op_id)

    def undone_outputs_after(self, op_id, port, min_id):
        return self.view.undone_outputs_after(op_id, port, min_id)

    def get_write_actions(self, op_id):
        return self.view.get_write_actions(op_id)

    def get_state(self, op_id):
        return self.view.get_state(op_id)

    def last_sent_ssn(self, op_id):
        return self.view.last_sent_ssn(op_id)

    def last_acked(self, op_id):
        return self.view.last_acked(op_id)

    def event_status(self, key, rec_op=None):
        return self.view.event_status(key, rec_op)

    def get_read_action(self, op_id, conn_id):
        return self.view.get_read_action(op_id, conn_id)

    def undone_events_from(self, send_op, rec_op):
        return self.view.undone_events_from(send_op, rec_op)

    def lineage_insets_of(self, event_key):
        return self.view.lineage_insets_of(event_key)

    def lineage_events_of_inset(self, rec_op, inset_id):
        return self.view.lineage_events_of_inset(rec_op, inset_id)

    def lineage_outputs_of_inset(self, send_op, inset_id):
        return self.view.lineage_outputs_of_inset(send_op, inset_id)

    def insets_of_event(self, event_key, rec_op):
        return self.view.insets_of_event(event_key, rec_op)

    def consumers_of(self, event_key):
        return self.view.consumers_of(event_key)

    # filtered lineage queries: the speculative view (a MemoryLogStore with
    # native indexes) answers — committed-but-unflushed rows included
    @property
    def supports_query_pushdown(self):
        return getattr(self.view, "supports_query_pushdown", False)

    def query_lineage_insets(self, event_key, flt=None):
        return self.view.query_lineage_insets(event_key, flt)

    def query_inset_events(self, rec_op, inset_id, flt=None):
        return self.view.query_inset_events(rec_op, inset_id, flt)

    def query_inset_outputs(self, send_op, inset_id, flt=None):
        return self.view.query_inset_outputs(send_op, inset_id, flt)

    def query_event_insets(self, event_key, rec_op, flt=None):
        return self.view.query_event_insets(event_key, rec_op, flt)

    def query_consumers(self, event_key, flt=None):
        return self.view.query_consumers(event_key, flt)

    def query_lineage(self, flt=None):
        return self.view.query_lineage(flt)

    def get_event_payload(self, event_key):
        return self.view.get_event_payload(event_key)

    def _query_stats(self):
        return self.view._query_stats()

    def reset_query_stats(self):
        self.view.reset_query_stats()

    def gc(self, lineage_ops=(), keep_rows=None):
        self.view.gc(lineage_ops, keep_rows=keep_rows)
        if self.inner is not None:
            self.inner.gc(lineage_ops, keep_rows=keep_rows)
