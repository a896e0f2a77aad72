"""Sharded log store: partitions the five tables by operator id.

Every row has a *home operator* — the receiver for EVENT_LOG/EVENT_DATA
rows (write-action and read-action events fall back to the sender, which
equals the receiver or is the only party), the owning operator for
STATE/READ_ACTION rows, and the producing operator for EVENT_LINEAGE rows.
Rows live in ``shard(home) = crc32(home) % n_shards``, each shard a full
backend with its own lock, so the per-event transactions of unrelated
operators never contend on one global lock (the storage-layer analogue of
the paper's "parallelization reduces LOG.io overhead" claim, Sec. 9).

A transaction may span shards (an Output-Set transaction touches the
operator's own shard for STATE/InSet flips and the consumers' shards for
the new EVENT_LOG rows). Commit acquires the involved shard locks in index
order (deadlock-free), validates conditional ops against the union image,
then applies each shard's slice — atomicity is preserved because all locks
are held across validation and application. ``reassign_event`` (Alg 13) is
decomposed into per-shard micro-ops so the delete (old replica's shard) and
the insert (new target's shard) land in their home shards.

Shards compose: ``ShardedLogStore(factory=lambda i: GroupCommitStore(...))``
gives per-shard group commit; durability tokens become ``{shard: seq}`` maps
and ``is_durable`` requires every involved shard to have flushed. Flushes of
group-commit shards run the **global flush epoch protocol** (lightweight
2PC, ``logstore/epoch.py``): a brief exclusive epoch barrier cuts every
shard's pending batch (list swaps only), each shard then *prepares* — it
persists its batch tagged with the epoch id, outside all shard locks — and
a single durable epoch-commit record makes the multi-shard flush atomic.
Prepared-but-uncommitted epochs roll back on restart, so no multi-shard
transaction is ever half-durable and flush I/O never blocks commits.
"""
from __future__ import annotations

import threading
import time
import zlib
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.core.logstore.base import LogBackend, TxnAborted
from repro_torch.core.logstore.epoch import EpochCoordinator, ReadWriteLock
from repro_torch.core.logstore.memory import MemoryLogStore

BROADCAST = None


class ShardedLogStore(LogBackend):

    def __init__(self, n_shards: int = 4,
                 factory: Optional[Callable[[int], LogBackend]] = None,
                 epoch_coord: Optional[EpochCoordinator] = None):
        factory = factory or (lambda i: MemoryLogStore())
        self.n_shards = n_shards
        self.shards: List[LogBackend] = [factory(i) for i in range(n_shards)]
        self._group_shards = [s for s in self.shards
                              if hasattr(s, "cut_pending")]
        if self._group_shards and epoch_coord is None:
            # durable shard media need a durable epoch-commit record: a
            # volatile default coordinator would let prepared-but-
            # uncommitted epochs replay as durable after a real restart —
            # the half-durable outcome the protocol exists to prevent.
            # build_store wires the matching coordinator automatically.
            from repro_torch.core.logstore.segment import SegmentLogStore
            from repro_torch.core.logstore.sqlite import SqliteLogStore
            if any(isinstance(getattr(s, "inner", None),
                              (SqliteLogStore, SegmentLogStore))
                   for s in self._group_shards):
                raise ValueError(
                    "sharded store over durable group-commit shards needs "
                    "a durable epoch coordinator (pass epoch_coord=, or "
                    "assemble the stack via build_store)")
            epoch_coord = EpochCoordinator()
        if epoch_coord is not None:
            # propagate so every shard (and durable inner) consults the
            # same commit record at crash()/reopen time
            for s in self._group_shards:
                if getattr(s, "epoch_coord", None) is None:
                    s.epoch_coord = epoch_coord
                inner = getattr(s, "inner", None)
                if inner is not None and \
                        getattr(inner, "epoch_coord", "n/a") is None:
                    inner.epoch_coord = epoch_coord
        self.epoch_coord = epoch_coord
        # commits hold the barrier shared; the epoch cut holds it exclusive
        self._epoch_barrier = ReadWriteLock()
        self._flush_serial = threading.Lock()   # one epoch flush at a time
        self.epochs_flushed = 0
        # async epoch flushes: commits nudge, the flusher thread runs the
        # 2PC (cut under the barrier, prepare I/O outside all shard locks)
        # — operator threads never block on shard fsyncs
        self._flush_wake = threading.Event()
        self._flusher: Optional[threading.Thread] = None
        self._flusher_stop = False
        self._flusher_idle = False

    # ---- placement -------------------------------------------------------
    def _idx(self, op_id) -> int:
        return zlib.crc32(str(op_id).encode()) % self.n_shards

    def _shard(self, op_id) -> LogBackend:
        return self.shards[self._idx(op_id)]

    def _log_entry_home(self, entry) -> int:
        ev = entry[0]
        return self._idx(ev.rec_op if ev.rec_op is not None else ev.send_op)

    def _status_entry_home(self, entry) -> Optional[int]:
        key, _status, _inset, rec_op, _only = entry
        if rec_op is not None:
            return self._idx(rec_op)
        if key[1] is None:            # write action: receiver == sender
            return self._idx(key[0])
        return BROADCAST

    def _route(self, op) -> Optional[List[int]]:
        """Home shard indices for one op tuple; BROADCAST when the rows it
        touches cannot be located from the op alone (rare recovery paths)."""
        kind = op[0]
        if kind in ("log_event", "put_event_data"):
            ev = op[1]
            return [self._idx(ev.rec_op if ev.rec_op is not None
                              else ev.send_op)]
        if kind == "log_events":
            return sorted({self._log_entry_home(e) for e in op[1]})
        if kind == "set_status_many":
            homes = {self._status_entry_home(e) for e in op[1]}
            return BROADCAST if BROADCAST in homes else sorted(homes)
        if kind == "put_event_blob":
            return [self._idx(op[2])]           # pre-computed home operator
        if kind == "set_status":
            _, key, _status, _inset, rec_op, _only = op
            if rec_op is not None:
                return [self._idx(rec_op)]
            if key[1] is None:        # write action: receiver == sender
                return [self._idx(key[0])]
            return BROADCAST
        if kind == "assign_insets":
            rec = op[3]
            return [self._idx(rec)] if rec is not None else BROADCAST
        if kind in ("set_inset_status", "clear_inset"):
            return [self._idx(op[1])]
        if kind in ("put_state", "put_read_action", "set_read_action_status"):
            return [self._idx(op[1])]
        if kind == "put_lineage":
            return [self._idx(op[2])]           # send_op
        return BROADCAST    # delete_event_data / delete_event_rows / micro-ops

    # ---- commit ----------------------------------------------------------
    def _commit(self, ops):
        if not self._group_shards:
            # no epoch protocol in play (volatile/plain shards flush
            # synchronously inside _commit_routed): the barrier and the
            # flusher probe are pure overhead on the hot path
            return self._commit_under_barrier(ops)
        # shared epoch barrier: an epoch cut cannot run mid-commit, so a
        # multi-shard transaction lands entirely inside one flush epoch
        self._epoch_barrier.acquire_read()
        try:
            token = self._commit_under_barrier(ops)
        finally:
            self._epoch_barrier.release_read()
        if self._flusher is None:
            self._ensure_flusher()
        # wake on a reached watermark, or whenever the flusher sits in
        # its indefinite idle wait (it recomputes the interval deadline
        # from the shards' batch timestamps on wakeup); a racy missed
        # wake only delays until the next commit or maybe_flush nudge
        if self._flusher_idle or \
                any(s._watermark_reached() for s in self._group_shards):
            self._flush_wake.set()
        return token

    def _ensure_flusher(self):
        with self._flush_serial:
            if self._flusher is None and not self._flusher_stop:
                t = threading.Thread(target=self._flusher_loop, daemon=True,
                                     name="epoch-flusher")
                self._flusher = t
                t.start()

    def _flusher_loop(self):
        while True:
            timestamps = [s._first_ts for s in self._group_shards]
            live = [ts for ts in timestamps if ts is not None]
            if live:
                interval = min(getattr(s, "interval", 0.005)
                               for s in self._group_shards)
                timeout = max(0.0, min(live) + interval - time.monotonic())
            else:
                timeout = None
                self._flusher_idle = True
            self._flush_wake.wait(timeout)
            self._flusher_idle = False
            self._flush_wake.clear()
            if self._flusher_stop:
                return
            if any(s._watermark_reached() for s in self._group_shards):
                with self._flush_serial:
                    self._flush_epochs()

    def _commit_under_barrier(self, ops):
        routes = [self._route(op) for op in ops]
        if any(r is BROADCAST for r in routes) or \
                any(op[0] == "reassign_event" for op in ops):
            involved = list(range(self.n_shards))
        else:
            involved = sorted({i for r in routes for i in r})
            if len(involved) == 1:
                # fast path: the whole transaction — including a vectored
                # run of events — homes on one shard, so the run costs
                # exactly one lock acquisition and one routed commit
                i = involved[0]
                sh = self.shards[i]
                with sh.shard_lock:
                    self._validate(ops)
                    t = sh._commit_routed(list(ops))
                return {i: t} if t is not None else None
        locks = [self.shards[i].shard_lock for i in involved]
        for lk in locks:
            lk.acquire()
        try:
            self._validate(ops)
            shard_ops: Dict[int, List[Tuple]] = {i: [] for i in involved}
            for op, route in zip(ops, routes):
                if op[0] == "reassign_event":
                    self._plan_reassign(op, shard_ops)
                elif op[0] in ("log_events", "set_status_many") and \
                        (route is BROADCAST or len(route) > 1):
                    self._split_batch_op(op, involved, shard_ops)
                elif route is BROADCAST:
                    for i in involved:
                        # a broadcast assign (rec_op=None) must only reach
                        # shards that hold rows for the event — applying it
                        # to a rowless shard would fail mid-commit
                        if op[0] == "assign_insets" and not \
                                self.shards[i].image()._has_event_rows(
                                    op[1], op[3]):
                            continue
                        shard_ops[i].append(op)
                else:
                    for i in route:
                        shard_ops[i].append(op)
            token = {}
            for i in involved:
                if shard_ops[i]:
                    t = self.shards[i]._commit_routed(shard_ops[i])
                    if t is not None:
                        token[i] = t
        finally:
            for lk in reversed(locks):
                lk.release()
        return token or None

    def _split_batch_op(self, op, involved, shard_ops):
        """Slice a vectored op so each shard receives only the entries it
        homes (entry order preserved). Replicating the whole run would
        land rows in foreign shards, corrupting the home-routed queries
        and duplicating rows in the sender-side merges."""
        home = self._log_entry_home if op[0] == "log_events" \
            else self._status_entry_home
        for i in involved:
            ents = [e for e in op[1]
                    if home(e) is BROADCAST or home(e) == i]
            if ents:
                shard_ops[i].append((op[0], ents))

    def _validate(self, ops):
        """Conditional-op validation against the union image (locks held)."""
        for op in ops:
            if op[0] == "set_inset_status" and op[4]:
                if not self._shard(op[1]).image()._has_inset_rows(op[1],
                                                                  op[2]):
                    raise TxnAborted(
                        f"no EVENT_LOG rows for InSet {op[2]}@{op[1]}")
            elif op[0] == "assign_insets":
                key, rec = op[1], op[3]
                imgs = [self._shard(rec).image()] if rec is not None \
                    else [s.image() for s in self.shards]
                if not any(img._has_event_rows(key, rec) for img in imgs):
                    raise TxnAborted(f"no EVENT_LOG rows for {key}")

    def _plan_reassign(self, op, shard_ops):
        """Decompose reassign_event into home-shard micro-ops (locks held)."""
        _, old_key, old_rec, new_key, tgt_op, tgt_port = op
        from repro_torch.core.events import UNDONE
        moved = False
        blob = None
        blob_shard = None
        for i, sh in enumerate(self.shards):
            img = sh.image()
            if any((old_rec is None or k[3] == old_rec)
                   and img.event_log[k]["status"] == UNDONE
                   for k in img._by_key3.get(old_key, ())):
                moved = True
                shard_ops[i].append(("_del_undone", old_key, old_rec))
            if blob is None and old_key in img.event_data:
                blob = img.event_data[old_key]
                blob_shard = i
        if not moved:
            return
        t = self._idx(tgt_op)
        shard_ops[t].append(("_ins_row", new_key + (tgt_op, None),
                             tgt_op, tgt_port))
        if blob is not None:
            shard_ops[blob_shard].append(("delete_event_data", old_key))
            shard_ops[t].append(("_put_blob", new_key, blob))

    # ---- durability ------------------------------------------------------
    def is_durable(self, token) -> bool:
        if token is None:
            return True
        return all(self.shards[i].is_durable(t) for i, t in token.items())

    def flush(self):
        """Global flush epoch (lightweight 2PC), replacing the old
        all-shard-locks barrier:

          1. under a brief exclusive epoch barrier (no I/O — commits hold
             it shared), cut every shard's pending batch under a fresh
             epoch id, so no transaction straddles the cut;
          2. prepare: each shard persists its batch tagged with the epoch,
             with NO shard lock held — commits keep flowing during the I/O;
          3. commit point: one durable epoch-commit record marks the whole
             multi-shard flush atomic;
          4. each shard advances its durability watermark.

        A crash anywhere in the protocol rolls back prepared-but-
        uncommitted epochs on restart — the durable images always form a
        consistent cut and no multi-shard transaction is half-durable."""
        if not self._group_shards:
            for s in self.shards:
                s.flush()
            return
        with self._flush_serial:
            self._flush_epochs()

    def _flush_epochs(self):
        """One epoch flush; caller holds ``_flush_serial``."""
        with self._epoch_barrier.write():
            epoch_id = self.epoch_coord.next_epoch()
            cut = [(s, s.cut_pending(epoch_id))
                   for s in self._group_shards]
        prepared = False
        for s, batch in cut:
            if batch:
                s.persist_prepared(epoch_id)
                prepared = True
        if not prepared:
            return
        self.epoch_coord.commit_epoch(epoch_id)
        for s, _batch in cut:
            s.finish_epoch(epoch_id)
        self.epochs_flushed += 1

    def maybe_flush(self):
        if any(s._watermark_reached() for s in self.shards
               if hasattr(s, "_watermark_reached")):
            if self._group_shards and self._flusher is not None \
                    and not self._flusher_stop:
                self._flush_wake.set()      # async: never block the caller
            else:
                self.flush()

    # ---- checkpoint compaction ------------------------------------------
    @property
    def supports_checkpoint(self):
        return any(getattr(s, "supports_checkpoint", False)
                   for s in self.shards)

    def checkpoint_due(self):
        return any(s.checkpoint_due() for s in self.shards)

    def checkpoint(self):
        """Checkpoint every shard. For group-commit shards this must run
        the global-flush-epoch protocol first AND hold ``_flush_serial``
        across the shard compactions: a concurrent epoch flush could
        otherwise persist prepare records of a not-yet-committed epoch into
        a shard image mid-compaction, baking conditional records into the
        checkpoint unconditionally."""
        if not self.supports_checkpoint:
            return
        # the "lineage exists => keep rows" guard is global (see gc())
        keep_rows = any(s.image().lineage for s in self.shards)
        if not self._group_shards:
            for s in self.shards:
                s.compact(keep_rows=keep_rows)
            return
        with self._flush_serial:
            self._flush_epochs()
            for s in self.shards:
                if hasattr(s, "_checkpoint_inner"):
                    if getattr(s, "supports_checkpoint", False):
                        s._checkpoint_inner(keep_rows=keep_rows)
                else:
                    s.compact(keep_rows=keep_rows)

    def maybe_checkpoint(self):
        if self.checkpoint_due():
            self.checkpoint()

    def set_gc_protect(self, ops):
        self.gc_protect = frozenset(ops)
        for s in self.shards:
            s.set_gc_protect(ops)

    def recovery_replay_count(self):
        return sum(s.recovery_replay_count() for s in self.shards)

    def crash(self):
        # _flush_serial parks the crash at a protocol-quiescent point: an
        # in-flight async epoch flush either fully committed or never cut
        with self._flush_serial:
            # the coordinator first: shards consult its (durable) committed
            # set when deciding which prepared epochs survive
            if self.epoch_coord is not None:
                self.epoch_coord.crash()
            for s in self.shards:
                s.crash()

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
        for s in self.shards:
            s.close()
        if self.epoch_coord is not None:
            self.epoch_coord.close()

    # ---- bookkeeping -----------------------------------------------------
    @property
    def commits(self):
        return sum(s.commits for s in self.shards)

    @property
    def bytes_written(self):
        return sum(s.bytes_written for s in self.shards)

    # ---- queries ---------------------------------------------------------
    # receiver-/owner-homed: answered by one shard
    def fetch_ack_events(self, op_id, include_done=False):
        return self._shard(op_id).fetch_ack_events(
            op_id, include_done=include_done)

    def last_acked(self, op_id):
        return self._shard(op_id).last_acked(op_id)

    def get_write_actions(self, op_id):
        return self._shard(op_id).get_write_actions(op_id)

    def get_state(self, op_id):
        return self._shard(op_id).get_state(op_id)

    def get_read_action(self, op_id, conn_id):
        return self._shard(op_id).get_read_action(op_id, conn_id)

    def undone_events_from(self, send_op, rec_op):
        return self._shard(rec_op).undone_events_from(send_op, rec_op)

    def lineage_insets_of(self, event_key):
        return self._shard(event_key[0]).lineage_insets_of(event_key)

    def lineage_events_of_inset(self, rec_op, inset_id):
        return self._shard(rec_op).lineage_events_of_inset(rec_op, inset_id)

    def lineage_outputs_of_inset(self, send_op, inset_id):
        return self._shard(send_op).lineage_outputs_of_inset(send_op,
                                                             inset_id)

    def insets_of_event(self, event_key, rec_op):
        return self._shard(rec_op).insets_of_event(event_key, rec_op)

    # filtered lineage queries: same home-shard routing; the fan-out ones
    # skip shards the filter's ``ops`` prove uninvolved (per-shard pushdown
    # composes with shard pruning)
    @property
    def supports_query_pushdown(self):
        return all(getattr(s, "supports_query_pushdown", False)
                   for s in self.shards)

    def query_lineage_insets(self, event_key, flt=None):
        return self._shard(event_key[0]).query_lineage_insets(event_key, flt)

    def query_inset_events(self, rec_op, inset_id, flt=None):
        return self._shard(rec_op).query_inset_events(rec_op, inset_id, flt)

    def query_inset_outputs(self, send_op, inset_id, flt=None):
        return self._shard(send_op).query_inset_outputs(send_op, inset_id,
                                                        flt)

    def query_event_insets(self, event_key, rec_op, flt=None):
        return self._shard(rec_op).query_event_insets(event_key, rec_op, flt)

    def query_consumers(self, event_key, flt=None):
        out = set()
        for s in self.shards:
            out.update(s.query_consumers(event_key, flt))
        return sorted(out)

    def query_lineage(self, flt=None):
        if flt is not None and flt.ops is not None:
            involved = sorted({self._idx(o) for o in flt.ops})
        else:
            involved = range(self.n_shards)
        rows = []
        for i in involved:
            rows.extend(self.shards[i].query_lineage(flt))
        return sorted(rows)

    def get_event_payload(self, event_key):
        # EVENT_DATA is receiver-homed and the receiver isn't in the key:
        # probe shards until one holds the payload
        for s in self.shards:
            payload = s.get_event_payload(event_key)
            if payload is not None:
                return payload
        return None

    def _query_stats(self):
        out: Dict[str, int] = {}
        for s in self.shards:
            for k, v in s._query_stats().items():
                out[k] = out.get(k, 0) + v
        return out

    def reset_query_stats(self):
        for s in self.shards:
            s.reset_query_stats()

    # sender-side: rows live in the consumers' shards — merge
    def fetch_resend_events(self, op_id):
        rows = []
        for s in self.shards:
            rows.extend(s.fetch_resend_events(op_id))
        rows.sort(key=lambda es: es[0].event_id)
        return rows

    def fetch_replay_outputs(self, op_id):
        rows = []
        for s in self.shards:
            rows.extend(s.fetch_replay_outputs(op_id))
        return sorted(rows)

    def undone_outputs_after(self, op_id, port, min_id):
        ids = set()
        for s in self.shards:
            ids.update(s.undone_outputs_after(op_id, port, min_id))
        return sorted(ids)

    def last_sent_ssn(self, op_id):
        out: Dict[str, int] = {}
        for s in self.shards:
            for port, last in s.last_sent_ssn(op_id).items():
                out[port] = max(out.get(port, -1), last)
        return out

    def event_status(self, key, rec_op=None):
        if rec_op is not None:
            return self._shard(rec_op).event_status(key, rec_op)
        rows = []
        for s in self.shards:
            rows.extend(s.event_status(key))
        return rows

    def consumers_of(self, event_key):
        out = set()
        for s in self.shards:
            out.update(s.consumers_of(event_key))
        return sorted(out)

    def gc(self, lineage_ops: Iterable[str] = ()):
        ops = list(lineage_ops)
        # the "lineage exists => keep rows" guard is global: EVENT_LINEAGE
        # rows live only in the producing operator's shard
        keep_rows = any(s.image().lineage for s in self.shards)
        for s in self.shards:
            s.gc(ops, keep_rows=keep_rows)
