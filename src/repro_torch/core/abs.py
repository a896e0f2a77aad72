"""ABS baseline: aligned Asynchronous Barrier Snapshotting (Sec. 8.1.1),
the SAP-DI variant (no 2PC across writers; per-epoch WAL committed at epoch
completion), used as the comparison protocol in Sec. 9.

Mechanics:
  * sources inject marker events every ``epoch_events`` outputs and record
    their read offset per epoch;
  * an operator receiving marker e on a port BLOCKS that port (alignment)
    until marker e arrived on all ports, then snapshots its full state
    (global + event state) asynchronously and forwards the marker;
  * write actions are buffered into a per-epoch WAL and committed (executed
    on the external system) only when the epoch is complete;
  * on ANY failure the WHOLE pipeline restarts from the last complete epoch:
    channels cleared, operators restored from snapshots, sources rewound —
    the blocking behaviour LOG.io's non-blocking recovery is measured
    against.

Counterpart of ``repro.core.abs`` with three fixes, at each of which
``repro.core.abs`` can lose or reorder outputs under load:

  * a group thread runs under the generation of the restart that launched
    it. ``repro.core.abs`` reads the generation when the thread starts, so
    the threads of a restart that a second crash supersedes can take the
    second restart's generation and run beside its restore;
  * ``wait`` ends a run only when no global restart is pending or in
    progress and no group thread is inside a step. A restart clears the
    channels before it rewinds the sources, and an operator acks an event
    before it sends the event's outputs: either moment reads as a drained
    pipeline beside exhausted sources;
  * the final flush commits the remaining epochs under the epoch lock, so
    a snapshot thread still committing an earlier epoch finishes first.
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Dict, List, Tuple

from repro_torch.core.builtin import GeneratorSource, TerminalSink
from repro_torch.core.events import Event
from repro_torch.core.operator import Operator, SimulatedCrash

# per-class volatile state captured in snapshots
STATE_ATTRS = {
    "MapOperator": ("_queue",),
    "CountWindowOperator": ("count", "insets"),
    "SyncJoinOperator": ("counts", "windows"),
    "TerminalSink": ("seen", "_pending", "received"),
    "DispatcherOperator": ("rr", "routes", "_queue"),
    "MergerOperator": ("_queue",),
}


def snapshot_op(op: Operator) -> bytes:
    attrs = STATE_ATTRS.get(type(op).__name__, ())
    return pickle.dumps({a: getattr(op, a) for a in attrs})


def restore_op(op: Operator, blob: bytes):
    for a, v in pickle.loads(blob).items():
        setattr(op, a, v)


class SnapshotStore:
    """Durable store for epoch snapshots + per-epoch write WAL.

    ``backend`` (optional) is a :class:`~repro_torch.core.logstore.LogBackend`:
    snapshots are additionally persisted through the formal log interface
    (STATE rows keyed ``abs:<op>``), so the ABS baseline can run over the
    exact same storage stack (sqlite / sharded / group commit) as LOG.io —
    an epoch's WAL is only committed to the external system once the
    backend's durability watermark covers its snapshots."""

    def __init__(self, backend=None):
        self.lock = threading.Lock()
        self.backend = backend
        self.snaps: Dict[int, Dict[str, bytes]] = {}
        self.offsets: Dict[int, Dict[str, int]] = {}
        self.wal: Dict[int, List[Tuple[str, str, int, Any]]] = {}
        self.committed_epochs: set = set()
        self.complete: set = set()
        self.bytes_written = 0

    def put_snapshot(self, epoch: int, op_id: str, blob: bytes):
        with self.lock:
            self.snaps.setdefault(epoch, {})[op_id] = blob
            self.bytes_written += len(blob)
        if self.backend is not None:
            txn = self.backend.begin()
            txn.put_state(f"abs:{op_id}", epoch, blob, keep_history=True)
            txn.commit()

    def put_offset(self, epoch: int, op_id: str, off: int):
        with self.lock:
            self.offsets.setdefault(epoch, {})[op_id] = off

    def add_write(self, epoch: int, op_id: str, conn: str, n: int, body):
        with self.lock:
            self.wal.setdefault(epoch, []).append((op_id, conn, n, body))
            self.bytes_written += len(pickle.dumps(body))

    def snapshot_count(self, epoch: int) -> int:
        with self.lock:
            return len(self.snaps.get(epoch, {}))

    def last_complete(self) -> int:
        with self.lock:
            return max(self.complete) if self.complete else -1


class _AbsOpState:
    def __init__(self, op: Operator):
        self.op = op
        self.blocked: Dict[str, int] = {}     # port -> epoch blocking it
        self.markers: Dict[int, set] = {}     # epoch -> ports seen
        # writes buffered between markers e-1 and e belong to epoch e
        self.epoch = 1
        self.write_ssn = 0


class AbsEngineDriver:
    """Every group runs in epoch mode under this driver — the barrier
    aligns the whole pipeline, so per-group ``recovery_mode`` freedom does
    not exist here.  ``Engine.recovery_mode_of()`` reports ``"epoch"`` for
    all groups under ``protocol="abs"``, and the engine rejects an explicit
    ``recovery_modes={...: "log"}`` request at construction; the adaptive
    per-group hybrid lives in the log engine (``recovery_modes=`` /
    ``set_recovery_mode``, driven by ``repro_torch.core.controller``)."""

    def __init__(self, engine, *, epoch_events: int = 15,
                 snapshot_async: bool = True, durable_store=None):
        if any(m == "log" for m in engine.recovery_modes.values()):
            raise ValueError(
                "ABS cannot honor per-group recovery_mode 'log' — the "
                "barrier aligns every group")
        self.e = engine
        self.epoch_events = epoch_events
        self.snapshot_async = snapshot_async
        self.store = SnapshotStore(backend=durable_store)
        self.states: Dict[str, _AbsOpState] = {}
        self.src_emit_count: Dict[str, int] = {}
        self.src_epoch: Dict[str, int] = {}
        self._restart_lock = threading.Lock()
        self._epoch_lock = threading.Lock()
        self._stop = engine._stop
        self._done = engine._done
        self.snapshot_threads: List[threading.Thread] = []
        self._next_commit = 1
        self._tl = threading.local()
        # group threads inside a step section; a global restart must see
        # this reach zero before restoring, or an old-generation thread
        # (e.g. the sink draining pre-crash outputs, or a source mid-emit)
        # races the restore and pollutes the WAL/offsets it just rebuilt
        self._active = 0
        self._active_lock = threading.Lock()
        # crashes whose global restart has not finished yet; wait() must
        # not read the restart's cleared channels and not-yet-rewound
        # sources as the end of the run
        self._restarts_pending = 0

    # ------------------------------------------------------------------
    def start(self):
        self._init_states()
        for g in set(self.e.pipeline.groups.values()):
            self._start_group(g, self._generation)

    def _init_states(self, epoch: int = 0):
        self.states = {oid: _AbsOpState(op) for oid, op in self.e.ops.items()}
        for st in self.states.values():
            st.epoch = max(epoch, 0) + 1
        for oid, op in self.e.ops.items():
            if isinstance(op, GeneratorSource):
                self.src_emit_count.setdefault(oid, 0)
                self.src_epoch.setdefault(oid, 0)
                op._effect = op.source.effect(op.desc, 0)
                op._abs_offset = getattr(op, "_abs_offset", 0)

    def _start_group(self, group: str, gen: int):
        t = threading.Thread(target=self._run_group, args=(group, gen),
                             daemon=True, name=f"abs-{group}")
        self.e.threads[group] = t
        t.start()

    def _run_group(self, group: str, gen: int):
        # ``gen`` is the generation that launched this thread: read at the
        # thread's start instead, a restart that began in between would
        # pass for its own and the thread would run beside its restore
        self._tl.gen = gen
        try:
            while not self._stop.is_set() and not self._done.is_set():
                progressed = False
                with self._active_lock:
                    self._active += 1
                try:
                    # the generation re-check sits INSIDE the active
                    # section: entering after a restart observed zero is
                    # harmless because such a thread exits without stepping
                    if gen != self._generation:
                        return      # superseded by a restart
                    for op_id in self.e.group_ops(group):
                        op = self.e.ops[op_id]
                        progressed |= self._step(op)
                except SimulatedCrash:
                    with self._active_lock:
                        self._restarts_pending += 1
                    raise
                finally:
                    with self._active_lock:
                        self._active -= 1
                if not progressed:
                    time.sleep(0.001)
        except SimulatedCrash as exc:
            try:
                self._global_restart(exc)
            finally:
                with self._active_lock:
                    self._restarts_pending -= 1

    _generation = 0

    # ------------------------------------------------------------------
    def _step(self, op: Operator) -> bool:
        if isinstance(op, GeneratorSource):
            return self._step_source(op)
        st = self.states[op.id]
        progressed = False
        for port in op.input_ports:
            ch = op.in_channels.get(port)
            if ch is None or port in st.blocked:
                continue
            ev = ch.peek()
            if ev is None:
                continue
            if "marker" in ev.header:
                ch.ack()
                self._on_marker(op, st, port, ev.header["marker"])
                progressed = True
                continue
            self.e.injector(op.id, "abs_input")
            ch.ack()
            op.update_global(ev)
            insets = op.on_event(ev)
            for inset in op.triggers():
                op.simulate_work()
                outputs, writes = op.generate(inset)
                self.e.injector(op.id, "abs_post_generate")
                for port_out, body in outputs:
                    self._send(op, port_out, body)
                for conn, body in writes:
                    st.write_ssn += 1
                    self.store.add_write(st.epoch, op.id, conn,
                                         st.write_ssn, body)
                op.clear_inset(inset)
            if isinstance(op, TerminalSink) and op.seen >= op.target:
                self._done.set()
            progressed = True
        return progressed

    def _step_source(self, op: GeneratorSource) -> bool:
        if op._effect is None:
            op._effect = op.source.effect(op.desc, 0)
        off = getattr(op, "_abs_offset", 0)
        if off >= len(op._effect):
            op.exhausted = True
            if not getattr(op, "_final_marker", False):
                self._emit_marker(op)
                op._final_marker = True
            return False
        delay = op.rate_fn(off) if op.rate_fn is not None else op.rate
        if delay > 0:
            time.sleep(delay)
        self.e.injector(op.id, "abs_source")
        body = op._effect[off]
        op._abs_offset = off + 1
        self._send(op, "out", body)
        self.src_emit_count[op.id] += 1
        if self.src_emit_count[op.id] % self.epoch_events == 0:
            self._emit_marker(op)
        return True

    def _emit_marker(self, op: GeneratorSource):
        self.src_epoch[op.id] += 1
        epoch = self.src_epoch[op.id]
        self.store.put_offset(epoch, op.id, getattr(op, "_abs_offset", 0))
        self.store.put_snapshot(epoch, op.id, snapshot_op(op))
        for ch in op.out_channels.get("out", []):
            ch.put(Event(-epoch, op.id, "out", ch.rec_op, ch.rec_port,
                         header={"marker": epoch}), stop_flag=self._stopflag)

    def _send(self, op: Operator, port: str, body):
        st = self.states.get(op.id)
        for ch in op.out_channels.get(port, []):
            ch.put(Event(0, op.id, port, ch.rec_op, ch.rec_port, body=body),
                   stop_flag=self._stopflag)

    # ------------------------------------------------------------------
    def _on_marker(self, op: Operator, st: _AbsOpState, port: str, epoch: int):
        seen = st.markers.setdefault(epoch, set())
        seen.add(port)
        if len(seen) < len([p for p in op.input_ports
                            if p in op.in_channels]):
            st.blocked[port] = epoch          # alignment: block this port
            return
        # all markers in: snapshot, forward, unblock
        st.blocked = {p: e for p, e in st.blocked.items() if e != epoch}
        blob = snapshot_op(op)

        def do_snap():
            time.sleep(0)                      # async hand-off
            self.store.put_snapshot(epoch, op.id, blob)
            self._maybe_complete(epoch)

        if self.snapshot_async:
            t = threading.Thread(target=do_snap, daemon=True)
            t.start()                       # start BEFORE publishing: the
            self.snapshot_threads.append(t)  # flush path joins this list
        else:
            do_snap()
        st.epoch = epoch + 1
        for port_out in op.output_ports:
            for ch in op.out_channels.get(port_out, []):
                ch.put(Event(-epoch, op.id, port_out, ch.rec_op, ch.rec_port,
                             header={"marker": epoch}),
                       stop_flag=self._stopflag)

    def _stopflag(self) -> bool:
        gen = getattr(self._tl, "gen", self._generation)
        return self._stop.is_set() or gen != self._generation

    def _maybe_complete(self, epoch: int):
        with self._epoch_lock:
            if self.store.snapshot_count(epoch) >= len(self.e.ops) \
                    and epoch not in self.store.complete:
                self.store.complete.add(epoch)
            # commit strictly in epoch order
            while self._next_commit in self.store.complete:
                self._commit_epoch(self._next_commit)
                self._next_commit += 1

    def _commit_epoch(self, epoch: int):
        """Execute the epoch's WAL on the external system (exactly once).
        With a log backend attached, the external writes are gated on its
        durability watermark (same rule as LOG.io's write actions)."""
        if epoch in self.store.committed_epochs:
            return
        if self.store.backend is not None:
            self.store.backend.flush()
        self.store.committed_epochs.add(epoch)
        for (op_id, conn, n, body) in self.store.wal.get(epoch, []):
            self.e.external.execute(op_id, conn, (epoch, n), body)

    # ------------------------------------------------------------------
    def _global_restart(self, exc):
        with self._restart_lock:
            if self._stop.is_set() or self._done.is_set():
                return
            self.e.failures += 1
            self._generation += 1
            gen = self._generation
            # quiesce: every other group thread must leave its step section
            # before state is restored (they observe the generation bump at
            # their loop top; a blocked channel put aborts via stop_flag).
            # The crashing thread itself already unwound out of its step.
            deadline = time.time() + 30.0
            while time.time() < deadline:
                with self._active_lock:
                    if self._active == 0:
                        break
                time.sleep(0.001)
            for t in list(self.snapshot_threads):
                t.join(timeout=5.0)
            self.snapshot_threads = [t for t in self.snapshot_threads
                                     if t.is_alive()]
            time.sleep(self.e.restart_delay * len(self.e.ops))  # whole-pipeline restart
            epoch = self.store.last_complete()
            for ch in self.e.channels:
                ch.clear()
            # fresh instances, restore from snapshots
            self.e._build(first=False)
            self.e.restarts += 1
            for oid, op in self.e.ops.items():
                blob = self.store.snaps.get(epoch, {}).get(oid)
                if blob is not None:
                    restore_op(op, blob)
                if isinstance(op, GeneratorSource):
                    op._abs_offset = self.store.offsets.get(epoch, {}).get(oid, 0)
                    op._effect = op.source.effect(op.desc, 0)
                    op.exhausted = False
                    op._final_marker = False
            # drop WAL + snapshots of incomplete epochs
            for e in list(self.store.wal):
                if e > epoch:
                    del self.store.wal[e]
            for e in list(self.store.snaps):
                if e > epoch:
                    del self.store.snaps[e]
            self._init_states(epoch)
            for oid in self.src_epoch:
                self.src_epoch[oid] = max(epoch, 0)
                self.src_emit_count[oid] = self.store.offsets.get(
                    epoch, {}).get(oid, 0)
        for g in set(self.e.pipeline.groups.values()):
            self._start_group(g, gen)

    def wait(self, timeout: float) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self._done.is_set():
                self._stop.set()
                self._final_flush()
                return True
            # drained: no restart pending or in progress (a restart clears
            # the channels while the old sources still read as exhausted),
            # no group thread inside a step (an event it acked may not have
            # reached its output channel yet), every source exhausted and
            # every channel empty
            with self._restart_lock, self._active_lock:
                drained = (self._restarts_pending == 0 and self._active == 0
                           and self.e._sources_exhausted()
                           and all(len(c) == 0 for c in self.e.channels))
            if drained:
                self._final_flush()
                return True
            time.sleep(0.005)
        self._stop.set()
        return False

    def _final_flush(self):
        """Drain shutdown: join pending snapshots, then commit every
        remaining WAL epoch in order (the job finished cleanly, so the final
        partial epoch commits too — Flink's commit-on-finish)."""
        for t in list(self.snapshot_threads):
            try:
                t.join(0.5)
            except RuntimeError:
                pass    # racing with thread start: snapshot not yet live
        # under the epoch lock: a snapshot thread still committing an
        # earlier epoch must finish it first, or the epochs' writes reach
        # the external system out of order
        with self._epoch_lock:
            for e in sorted(set(self.store.wal) | self.store.complete):
                self._commit_epoch(e)
