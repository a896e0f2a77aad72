"""LOG.io operators + the per-operator protocol runtime (Algorithms 1-5).

The runtime owns the LOG.io context (Sec. 3.4): SSN counters per output port,
the last-acked event id per input port (obsolete filter), the array of latest
event ids that updated the global state, and the InSet counter. The context
is serialized into STATE inside the same atomic transaction that logs each
Output Set (Step 4 of Algorithm 3) — the *only* state LOG.io checkpoints;
event state is always rebuilt from logged input events on recovery.

User-defined operators implement small hooks; the runtime implements the
protocol, exposing the paper's API (Tables 7-9) via ``LogioAPI``.
"""
from __future__ import annotations

import pickle
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.events import DONE, UNDONE, Event, ReadAction
from repro_torch.core.logstore import LogBackend, TxnAborted


class SimulatedCrash(Exception):
    """Raised by the failure injector at a crash point; the engine treats it
    as the operator's pod dying (volatile state lost, logs+channels live)."""


class ExternalSystem:
    """Durable external system accepting write actions (Sec. 2.2).

    Write actions must be *checkable* (status()) or idempotent. The default
    implementation is a durable KV/list sink keyed by (op_id, conn_id,
    event_id) — checkable and idempotent.
    """

    def __init__(self, fail_rate: float = 0.0):
        self.lock = threading.Lock()
        self.writes: Dict[Tuple, Any] = {}
        self.order: List[Tuple] = []

    def execute(self, op_id: str, conn_id: str, event_id: int, body) -> bool:
        with self.lock:
            k = (op_id, conn_id, event_id)
            if k not in self.writes:
                self.writes[k] = body
                self.order.append(k)
            return True

    def status(self, op_id: str, conn_id: str, event_id: int) -> str:
        with self.lock:
            return "success" if (op_id, conn_id, event_id) in self.writes \
                else "unknown"

    def committed(self) -> List[Any]:
        with self.lock:
            return [self.writes[k] for k in self.order]


class ReadSource:
    """External system serving read actions. ``effect(action, from_offset)``
    returns the action's effect — a list of record batches. Replayable
    sources return a superset on later reads (Sec. 2.2)."""

    def __init__(self, batches: Sequence[Any], replayable: bool = True):
        self._batches = list(batches)
        self.replayable = replayable

    def effect(self, desc: str, from_offset: int = 0) -> List[Any]:
        return self._batches[from_offset:]


# ---------------------------------------------------------------------------
# Context
# ---------------------------------------------------------------------------

class LogioContext:
    """In-memory LOG.io context, serialized into STATE."""

    def __init__(self, op: "Operator"):
        self.ssn = {p: 0 for p in op.output_ports}       # next event_id per port
        self.write_ssn: Dict[str, int] = {}              # per connection
        self.last_acked = {p: -1 for p in op.input_ports}
        self.global_updated = {p: -1 for p in op.input_ports}
        self.inset_counter = 0
        self.read_offset = 0                             # source resume point
        self.state_counter = 0

    def snapshot(self) -> dict:
        return dict(ssn=dict(self.ssn), write_ssn=dict(self.write_ssn),
                    global_updated=dict(self.global_updated),
                    inset_counter=self.inset_counter,
                    read_offset=self.read_offset,
                    state_counter=self.state_counter)

    def restore(self, d: dict):
        self.ssn.update(d.get("ssn", {}))
        self.write_ssn.update(d.get("write_ssn", {}))
        self.global_updated.update(d.get("global_updated", {}))
        self.inset_counter = d.get("inset_counter", 0)
        self.read_offset = d.get("read_offset", 0)
        self.state_counter = d.get("state_counter", 0)


# ---------------------------------------------------------------------------
# Operator base
# ---------------------------------------------------------------------------

class Operator:
    """Base class. Subclasses define ports + hooks; the engine wires
    channels and drives ``step()`` (normal processing) after ``recover()``.
    """
    input_ports: Tuple[str, ...] = ("in",)
    output_ports: Tuple[str, ...] = ("out",)

    #: operators that are deterministic AND have lineage on all ports may be
    #: run as replay operators (Sec. 5) — no payload logging.
    deterministic: bool = True

    def __init__(self, op_id: str, *, processing_time: float = 0.0):
        self.id = op_id
        self.processing_time = processing_time
        # wiring (set by the engine)
        self.in_channels: Dict[str, Any] = {}
        self.out_channels: Dict[str, List[Any]] = {p: [] for p in self.output_ports}
        self.runtime: Optional["OperatorRuntime"] = None
        self.state = "running"         # running | dead | restarted | replay

    # ---- hooks ----------------------------------------------------------
    def on_event(self, event: Event, *, recovery_inset: Optional[str] = None
                 ) -> List[str]:
        """State Update (Alg 2 step 2): update event state, return the
        InSet_IDs assigned to this event. Stateless default: fresh singleton
        inset per event."""
        return [self.runtime.new_inset_id()]

    def update_global(self, event: Event) -> None:
        """Update the global state from one event (counters/timers)."""

    def triggers(self) -> List[str]:
        """Return InSet_IDs whose generation should fire now."""
        return list(self._pending_singletons())

    def generate(self, inset_id: str) -> Tuple[List[Tuple[str, Any]],
                                               List[Tuple[str, Any]]]:
        """Compute the Output Set for an Input Set.

        Returns (outputs, writes): outputs = [(port, body)], writes =
        [(conn_id, body)]. May call ``self.runtime.read_action(...)`` for
        side-effect reads (Alg 4)."""
        raise NotImplementedError

    def global_state(self) -> Any:
        return None

    def restore_global(self, blob: Any) -> None:
        pass

    def clear_inset(self, inset_id: str) -> None:
        """Input Sets with done events are emptied (Alg 3 step 4)."""

    def has_pending(self) -> bool:
        """True while the operator holds undelivered work the engine's
        idle-drain detection must wait for (e.g. a train-feed sink whose
        consumer has not acknowledged all batches)."""
        return False

    # ---- helpers ---------------------------------------------------------
    def _pending_singletons(self):
        return getattr(self, "_singleton_insets", [])

    def simulate_work(self):
        if self.processing_time > 0:
            time.sleep(self.processing_time)


# ---------------------------------------------------------------------------
# Protocol runtime
# ---------------------------------------------------------------------------

class OperatorRuntime:
    """Implements LOG.io normal processing for one operator instance."""

    def __init__(self, op: Operator, store: LogBackend, *,
                 lineage_in: Iterable[str] = (), lineage_out: Iterable[str] = (),
                 external: Optional[ExternalSystem] = None,
                 crash_point: Callable[[str, str], None] = lambda op, pt: None,
                 stop_flag: Callable[[], bool] = lambda: False,
                 replay_mode: bool = False,
                 keep_state_history: bool = False,
                 state_interval: int = 1):
        self.op = op
        op.runtime = self
        self.store = store
        self.ctx = LogioContext(op)
        # "epoch" recovery mode: snapshot state every N generate txns
        # instead of every txn (ABS-style amortization on the LOG.io log).
        # Lineage-scoped ops pin to 1 — their per-InSet state history IS
        # the lineage record.  Transactions carrying write actions always
        # snapshot regardless (write SSNs have no log-scan recovery floor,
        # so a stale write_ssn would reissue colliding write event ids).
        self.state_interval = 1 if keep_state_history \
            else max(1, int(state_interval))
        self._since_state = 0
        self.lineage_in = set(lineage_in)
        self.lineage_out = set(lineage_out)
        self.external = external or ExternalSystem()
        self.crash_point = crash_point
        self.stop_flag = stop_flag
        self.replay_mode = replay_mode      # Sec. 5: no payload logging
        self.keep_state_history = keep_state_history
        self.pending_reads: List[Tuple[ReadAction, Any]] = []
        self.stats = {"events_in": 0, "events_out": 0, "txns": 0,
                      # recovery-replay accounting (the bounded-replay
                      # claim: with checkpoint compaction these stay
                      # O(records since the last checkpoint))
                      "recovered_resends": 0, "recovered_inputs": 0,
                      # vectored recovery reads (one range scan per
                      # operator per table, not per-event iteration)
                      "recovery_scan_batches": 0,
                      # micro-batched hot path (runs of >1 event applied
                      # through one vectored transaction)
                      "batched_runs": 0, "batched_events": 0,
                      # metrics-plane latency accounting (cumulative µs):
                      # time inside store commits / blocked in credit-gated
                      # channel puts — the controller's mode signals
                      "commit_us": 0, "send_stall_us": 0}
        #: optional :class:`repro_torch.core.batching.BatchGovernor`; set by the
        #: engine/worker when micro-batching is enabled for this operator
        self.governor = None
        # externally visible effects (channel acks, external-system writes)
        # awaiting the store's durability watermark (group commit); FIFO
        self._deferred: List[Tuple[Any, Callable[[], None]]] = []
        # guards ctx mutations when an external driver (train loop) calls
        # generate() concurrently with the engine thread's handle_input()
        self.op_lock = threading.RLock()

    # ---- durability-watermark rule (group-commit pipelining) --------------
    def _after_durable(self, token, fn: Callable[[], None]):
        """Run ``fn`` once the commit behind ``token`` is durable. Plain
        backends are durable at commit, so this is immediate for them.
        Effects release strictly FIFO: once one is queued behind the
        watermark, every later effect queues behind it (external writes must
        reach the external system in commit order)."""
        if not self._deferred and self.store.is_durable(token):
            fn()
        else:
            self._deferred.append((token, fn))

    def _ack(self, ch, token):
        """Release the channel ack for the event just logged — immediately
        when durable, else deferred until the batch flushes."""
        if not self._deferred and self.store.is_durable(token):
            ch.ack()
        else:
            ch.defer_ack()
            self._deferred.append((token, ch.release_ack))

    def drain_durable(self, force: bool = False) -> bool:
        """Release deferred effects whose commits became durable, in FIFO
        order, stopping at the first still-volatile one. Called by the
        engine between steps; ``force`` flushes the store first.
        Returns True if anything was released."""
        if not self._deferred:
            return False
        if force:
            self.store.flush()
        else:
            self.store.maybe_flush()
        released = False
        with self.op_lock:
            while self._deferred and \
                    self.store.is_durable(self._deferred[0][0]):
                _, fn = self._deferred.pop(0)
                fn()
                released = True
        return released

    # ---- id generation (paper API: GetActionID / GetStateID / InSet ids) --
    def new_inset_id(self) -> str:
        self.ctx.inset_counter += 1
        return f"{self.op.id}:{self.ctx.inset_counter}"

    def new_state_id(self) -> int:
        self.ctx.state_counter += 1
        return self.ctx.state_counter

    def next_ssn(self, port: str) -> int:
        ssn = self.ctx.ssn[port]
        self.ctx.ssn[port] = ssn + 1
        return ssn

    def next_write_ssn(self, conn: str) -> int:
        ssn = self.ctx.write_ssn.get(conn, 0)
        self.ctx.write_ssn[conn] = ssn + 1
        return ssn

    # ---- serialization ----------------------------------------------------
    def _state_blob(self) -> bytes:
        return pickle.dumps({"ctx": self.ctx.snapshot(),
                             "global": self.op.global_state()})

    def restore_state(self):
        blob = self.store.get_state(self.op.id)
        if blob is not None:
            d = pickle.loads(blob)
            self.ctx.restore(d["ctx"])
            self.op.restore_global(d["global"])
        # advance SSNs past anything already logged (Alg 9 step 1)
        for port, last in self.store.last_sent_ssn(self.op.id).items():
            if port in self.ctx.ssn:
                self.ctx.ssn[port] = max(self.ctx.ssn[port], last + 1)
        for port, last in self.store.last_acked(self.op.id).items():
            if port in self.ctx.last_acked:
                self.ctx.last_acked[port] = max(
                    self.ctx.last_acked[port], last)

    def _commit(self, txn):
        """Commit with latency accounting (``commit_us`` feeds the
        adaptive controller's commit-share signal)."""
        t0 = time.perf_counter()
        try:
            return txn.commit()
        finally:
            self.stats["commit_us"] += int((time.perf_counter() - t0) * 1e6)

    # ---- normal processing: one input event (Algorithm 2) ----------------
    def handle_input(self, port: str, ev: Event) -> bool:
        """Peeked event at head of channel. Returns True if consumed."""
        with self.op_lock:
            return self._handle_input_locked(port, ev)

    def _handle_input_locked(self, port: str, ev: Event) -> bool:
        ch = self.op.in_channels[port]
        self.crash_point(self.op.id, "pre_filter")
        # Alg 11 step 4.a: while awaiting regenerated events on a port fed by
        # a replay operator, every event there but an awaited one is stale
        # FIFO residue (the replay pred regenerates that whole suffix) —
        # discard it. That includes a regenerated event from the pred's own
        # earlier restart: processed ahead of the awaited ones it would
        # join their window out of order (repro.core lets it through; see
        # test_replay_mode_recovers_where_repro_core_does_not).
        if (getattr(self.op, "_awaiting_replay", None)
                and port in getattr(self.op, "_replay_pred_ports", ())
                and self._awaited(port, ev) is None):
            ch.ack()
            return True
        # Step 1: obsolete filter
        if self._obsolete(port, ev):
            ch.ack()
            return True
        if ev.is_replay and self._awaited(port, ev) is not None:
            return self._handle_replay_input(port, ev, ch)
        self.crash_point(self.op.id, "pre_state_update")
        # Step 2: state update
        if ev.event_id > self.ctx.global_updated.get(port, -1):
            self.op.update_global(ev)
            self.ctx.global_updated[port] = ev.event_id
        insets = self.op.on_event(ev)
        txn = self.store.begin()
        if ev.is_replay:   # regenerated-but-never-processed: back to normal
            txn.set_status((ev.send_op, ev.send_port, ev.event_id), UNDONE,
                           rec_op=self.op.id)
        txn.assign_insets((ev.send_op, ev.send_port, ev.event_id), insets,
                          rec_op=self.op.id)
        try:
            token = self._commit(txn)
        except TxnAborted:
            # the event was reassigned away (scale-down, Alg 13): drop it
            ch.ack()
            return True
        self.stats["txns"] += 1
        self.ctx.last_acked[port] = max(self.ctx.last_acked.get(port, -1),
                                        ev.event_id)
        self.crash_point(self.op.id, "post_ack_log")
        # event leaves the channel only once acknowledged — and the ack is
        # released only once its transaction is durable (watermark rule)
        self._ack(ch, token)
        self.stats["events_in"] += 1
        # Step 3: triggering
        for inset in self.op.triggers():
            self.generate(inset)
        return True

    # ---- normal processing: a run of input events (micro-batching) --------
    def handle_inputs(self, port: str, evs: List[Event]) -> int:
        """Vectored Algorithm 2: apply a *run* of peeked events through one
        log transaction and one coalesced ack pass. Returns the number of
        events consumed from the channel head (the caller acks nothing —
        consumption happens here, exactly as in ``handle_input``).

        Exactly-once at every batch boundary: the run's log records stay
        individually keyed, the whole run shares one commit (and thus one
        durability token), and channel acks are issued only after that
        commit — a crash anywhere in the run replays exactly the unacked
        suffix through the obsolete filter."""
        if len(evs) == 1:
            return 1 if self.handle_input(port, evs[0]) else 0
        with self.op_lock:
            return self._handle_inputs_locked(port, evs)

    def _handle_inputs_locked(self, port: str, evs: List[Event]) -> int:
        op = self.op
        ch = op.in_channels[port]
        awaiting = getattr(op, "_awaiting_replay", None)
        residue_ports = getattr(op, "_replay_pred_ports", ())
        # -- phase 1: classify + state-update, strictly in FIFO order ------
        plan: List[Tuple] = []     # ("drop", ev) | ("log", ev, insets)
        flips: List[Tuple] = []    # set_status_many entries (replay->UNDONE)
        last = self.ctx.last_acked.get(port, -1)
        for ev in evs:
            if ev.is_replay and self._awaited(port, ev) is not None:
                # an awaited regenerated event cuts the run: it takes the
                # scalar Example-10 path on the next engine pass
                break
            self.crash_point(op.id, "pre_filter")
            if awaiting and port in residue_ports:
                plan.append(("drop", ev))       # stale FIFO residue
                continue
            if ev.event_id <= last:
                plan.append(("drop", ev))       # obsolete filter
                continue
            self.crash_point(op.id, "pre_state_update")
            if ev.event_id > self.ctx.global_updated.get(port, -1):
                op.update_global(ev)
                self.ctx.global_updated[port] = ev.event_id
            insets = op.on_event(ev)
            if ev.is_replay:    # regenerated-but-never-processed
                flips.append(((ev.send_op, ev.send_port, ev.event_id),
                              UNDONE, "*", op.id, None))
            plan.append(("log", ev, insets))
            last = max(last, ev.event_id)
        if not plan:
            # run cut at its own head (awaited replay event): take the
            # scalar Example-10 path now so a governed loop cannot spin
            return 1 if self._handle_input_locked(port, evs[0]) else 0
        # -- phase 2: ONE vectored transaction for the whole run -----------
        logged = [p for p in plan if p[0] == "log"]
        token = None
        if logged:
            txn = self.store.begin()
            if flips:
                txn.set_status_many(flips)
            for _, ev, insets in logged:
                txn.assign_insets((ev.send_op, ev.send_port, ev.event_id),
                                  insets, rec_op=op.id)
            try:
                token = self._commit(txn)
            except TxnAborted:
                # some event was reassigned away (Alg 13): fall back to
                # per-event commits, reusing the phase-1 state updates
                return self._apply_run_fallback(port, ch, plan)
            self.stats["txns"] += 1
            self.ctx.last_acked[port] = max(
                self.ctx.last_acked.get(port, -1), last)
            for _ in logged:
                self.crash_point(op.id, "post_ack_log")
            self.stats["events_in"] += len(logged)
            self.stats["batched_runs"] += 1
            self.stats["batched_events"] += len(logged)
        # -- phase 3: coalesced FIFO channel verbs -------------------------
        if not self._deferred and self.store.is_durable(token):
            ch.ack_run(len(plan))
        else:
            # interleave in plan order, coalescing same-verb stretches:
            # drops ack immediately, logged events defer behind the run's
            # single durability token (watermark rule)
            i = 0
            while i < len(plan):
                kind = plan[i][0]
                j = i
                while j < len(plan) and plan[j][0] == kind:
                    j += 1
                if kind == "drop":
                    ch.ack_run(j - i)
                else:
                    ch.defer_run(j - i)
                    for _ in range(i, j):
                        self._deferred.append((token, ch.release_ack))
                i = j
        trig = op.triggers()
        if trig:
            self.generate_many(trig)
        return len(plan)

    def _apply_run_fallback(self, port: str, ch, plan) -> int:
        """The run's vectored commit aborted: re-commit per event so only
        the reassigned-away events drop (scalar semantics). Phase 1 already
        applied the state updates — ``on_event`` must not run twice."""
        op = self.op
        consumed = 0
        for entry in plan:
            if entry[0] == "drop":
                ch.ack()
                consumed += 1
                continue
            _, ev, insets = entry
            txn = self.store.begin()
            if ev.is_replay:
                txn.set_status((ev.send_op, ev.send_port, ev.event_id),
                               UNDONE, rec_op=op.id)
            txn.assign_insets((ev.send_op, ev.send_port, ev.event_id),
                              insets, rec_op=op.id)
            try:
                token = self._commit(txn)
            except TxnAborted:
                ch.ack()
                consumed += 1
                continue
            self.stats["txns"] += 1
            self.ctx.last_acked[port] = max(
                self.ctx.last_acked.get(port, -1), ev.event_id)
            self.crash_point(op.id, "post_ack_log")
            self._ack(ch, token)
            self.stats["events_in"] += 1
            consumed += 1
        trig = op.triggers()
        if trig:
            self.generate_many(trig)
        return consumed

    def _awaited(self, port: str, ev: Event):
        """The awaited (port, event id, Input Set) that ``ev`` fills, or
        None. Only the lowest awaited id of a port is taken: the replay
        predecessor regenerates the awaited events in id order, so a
        higher one arriving first is residue of a replay round cut short
        by this operator's crash, and its regeneration follows. Taken out
        of order, it would advance the global-state guard past the ids
        still to come (repro.core takes any awaited id; see
        ``test_replay_mode_recovers_where_repro_core_does_not``)."""
        first = None
        for t in getattr(self.op, "_awaiting_replay", ()):
            if t[0] == port and (first is None or t[1] < first[1]):
                first = t
        return first if first is not None and first[1] == ev.event_id \
            else None

    def _obsolete(self, port: str, ev: Event) -> bool:
        # Example 10: a replay event the receiver never processed is handled
        # like a normal event; one already acked is obsolete — unless this
        # operator is explicitly awaiting it (Alg 11).
        if ev.is_replay and self._awaited(port, ev) is not None:
            return False
        return ev.event_id <= self.ctx.last_acked.get(port, -1)

    def _handle_replay_input(self, port: str, ev: Event, ch) -> bool:
        """Process an awaited regenerated event: re-mark UNDONE, assign its
        original InSet, update event state, trigger (Example 10)."""
        op = self.op
        match = [self._awaited(port, ev)]
        inset = match[0][2]
        txn = self.store.begin()
        txn.set_status((ev.send_op, ev.send_port, ev.event_id), UNDONE,
                       rec_op=self.op.id)
        token = self._commit(txn)
        if ev.event_id > self.ctx.global_updated.get(port, -1):
            op.update_global(ev)
            self.ctx.global_updated[port] = ev.event_id
        op.on_event(ev, recovery_inset=inset)
        op._awaiting_replay.discard(match[0])
        self.ctx.last_acked[port] = max(self.ctx.last_acked.get(port, -1),
                                        ev.event_id)
        self._ack(ch, token)
        self.stats["events_in"] += 1
        for ins2 in op.triggers():
            self.generate(ins2)
        return True

    # ---- generation (Algorithm 3) -----------------------------------------
    def generate(self, inset_id: str, *, replay_events: Optional[dict] = None):
        with self.op_lock:
            return self._generate_locked(inset_id, replay_events=replay_events)

    def _generate_locked(self, inset_id: str, *,
                         replay_events: Optional[dict] = None):
        op = self.op
        op.simulate_work()
        self.pending_reads = []
        outputs, writes = op.generate(inset_id)
        self.crash_point(op.id, "pre_log")
        # Step 3: assign SSNs
        out_events: List[Event] = []
        for port, body in outputs:
            # one SSN per port; the same event fans out per channel
            ssn = self.next_ssn(port)
            for ch in op.out_channels.get(port, []):
                out_events.append(Event(ssn, op.id, port, ch.rec_op,
                                        ch.rec_port, body=body))
        write_events: List[Event] = []
        for conn, body in writes:
            wssn = self.next_write_ssn(conn)
            write_events.append(Event(wssn, op.id, None, op.id, conn,
                                      body=body))
        # Step 2+4: atomic transaction — the run of new output events goes
        # through one vectored log_events op (single-op framing for the
        # segment/WAL append and one routing decision per run in the
        # sharded store); single-output transactions keep the scalar op
        # sequence byte-identical to the per-event path
        # "epoch" recovery mode skips the per-txn snapshot between
        # intervals; recovery then replays from the last snapshot with
        # DONE rows included (see recovery.recover_operator).  Write
        # actions always force a snapshot — stale write SSNs have no
        # recovery floor.
        snap_state = (self.state_interval <= 1 or bool(write_events)
                      or self._since_state + 1 >= self.state_interval)
        txn = self.store.begin()
        log_entries: List[Tuple[Event, str, Optional[str]]] = []
        data_events: List[Event] = []
        for e in out_events:
            if replay_events and (e.send_port, e.event_id) in replay_events:
                # the REPLAY mark stays until the consumer takes the event
                # (it sets UNDONE then): cleared here, a crash between this
                # commit and the send would lose an event the consumer
                # awaits (repro.core clears it here; see
                # test_replay_mode_recovers_where_repro_core_does_not)
                e.header["replay"] = True
            else:
                if not self.replay_mode and \
                        any(getattr(ch, "prefer_blob", False)
                            for ch in op.out_channels.get(e.send_port, ())):
                    # byte transport downstream: serialize the payload once
                    # here and share the encode between the log
                    # (put_event_blob) and the wire (superframe payload)
                    e.cache_blob()
                log_entries.append((e, UNDONE, None))
                if not self.replay_mode:
                    data_events.append(e)
        if len(log_entries) == 1:
            txn.log_event(log_entries[0][0], UNDONE)
        elif log_entries:
            txn.log_events(log_entries)
        for e in data_events:
            txn.put_event_data(e)
        for w in write_events:
            txn.log_event(w, UNDONE)
            txn.put_event_data(w)
        if snap_state:
            txn.put_state(op.id, self.new_state_id(), self._state_blob(),
                          keep_history=self.keep_state_history)
        txn.set_inset_status(op.id, inset_id, DONE, require_rows=True)
        if self.lineage_out:
            for ra, effect in self.pending_reads:
                rev = Event(ra.action_id, op.id, f"{ra.conn_id}.r", None, None,
                            body=effect)
                txn.log_event(rev, DONE, inset_id)
                txn.put_event_data(rev)
            seen = set()
            for e in out_events:
                if e.send_port in self.lineage_out and \
                        (e.send_port, e.event_id) not in seen:
                    txn.put_lineage(e.event_id, op.id, e.send_port, inset_id)
                    seen.add((e.send_port, e.event_id))
        try:
            token = self._commit(txn)
        except TxnAborted:
            # InSet vanished (scaled-down reassignment, Alg 13) — drop output
            for port, _ in outputs:
                self.ctx.ssn[port] -= 1     # roll back the SSN we took
            return
        self.stats["txns"] += 1
        self._since_state = 0 if snap_state else self._since_state + 1
        self.crash_point(op.id, "post_log")
        # Step 5: send — may pipeline ahead of durability (duplicates are
        # dropped by the receivers' obsolete filters on recovery)
        for e in out_events:
            self._send(e)
        self.stats["events_out"] += len(out_events)
        self.crash_point(op.id, "post_send")
        # Step 6: write actions (Algorithm 5) — externally visible, so they
        # are released only once the logging transaction is durable
        for w in write_events:
            self._after_durable(token, lambda w=w: self.execute_write(w))
        op.clear_inset(inset_id)

    def generate_many(self, inset_ids: Sequence[str]) -> None:
        """Vectored Algorithm 3 over a run of triggered Input Sets: all
        their Output Sets go through ONE atomic transaction (one vectored
        ``log_events``, one state snapshot, one commit) and one batched
        dispatch pass.  Used by the batched hot path only — recovery keeps
        the scalar per-InSet generates."""
        if len(inset_ids) == 1:
            return self.generate(inset_ids[0])
        with self.op_lock:
            return self._generate_many_locked(list(inset_ids))

    def _generate_many_locked(self, inset_ids: List[str]) -> None:
        op = self.op
        # SSN counters rewind to this snapshot if the vectored commit
        # aborts (scaled-down reassignment) and the run falls back to
        # scalar generates
        ssn_snap = dict(self.ctx.ssn)
        wssn_snap = dict(self.ctx.write_ssn)
        runs: List[Tuple[str, List[Event], List[Event], List[Tuple]]] = []
        for inset_id in inset_ids:
            op.simulate_work()
            self.pending_reads = []
            outputs, writes = op.generate(inset_id)
            self.crash_point(op.id, "pre_log")
            out_events: List[Event] = []
            for port, body in outputs:
                ssn = self.next_ssn(port)
                for ch in op.out_channels.get(port, []):
                    out_events.append(Event(ssn, op.id, port, ch.rec_op,
                                            ch.rec_port, body=body))
            write_events: List[Event] = []
            for conn, body in writes:
                wssn = self.next_write_ssn(conn)
                write_events.append(Event(wssn, op.id, None, op.id, conn,
                                          body=body))
            runs.append((inset_id, out_events, write_events,
                         list(self.pending_reads)))
        any_writes = any(r[2] for r in runs)
        snap_state = (self.state_interval <= 1 or any_writes
                      or self._since_state + len(runs) >= self.state_interval)
        txn = self.store.begin()
        log_entries: List[Tuple[Event, str, Optional[str]]] = []
        for inset_id, out_events, write_events, reads in runs:
            for e in out_events:
                if not self.replay_mode and \
                        any(getattr(ch, "prefer_blob", False)
                            for ch in op.out_channels.get(e.send_port, ())):
                    e.cache_blob()
                log_entries.append((e, UNDONE, None))
        if len(log_entries) == 1:
            txn.log_event(log_entries[0][0], UNDONE)
        elif log_entries:
            txn.log_events(log_entries)
        for inset_id, out_events, write_events, reads in runs:
            if not self.replay_mode:
                for e in out_events:
                    txn.put_event_data(e)
            for w in write_events:
                txn.log_event(w, UNDONE)
                txn.put_event_data(w)
            txn.set_inset_status(op.id, inset_id, DONE, require_rows=True)
            if self.lineage_out:
                for ra, effect in reads:
                    rev = Event(ra.action_id, op.id, f"{ra.conn_id}.r",
                                None, None, body=effect)
                    txn.log_event(rev, DONE, inset_id)
                    txn.put_event_data(rev)
                seen = set()
                for e in out_events:
                    if e.send_port in self.lineage_out and \
                            (e.send_port, e.event_id) not in seen:
                        txn.put_lineage(e.event_id, op.id, e.send_port,
                                        inset_id)
                        seen.add((e.send_port, e.event_id))
        if snap_state:
            txn.put_state(op.id, self.new_state_id(), self._state_blob(),
                          keep_history=self.keep_state_history)
        try:
            token = self._commit(txn)
        except TxnAborted:
            # one of the InSets vanished under the whole-run transaction
            # (Alg 13): rewind the SSNs and fall back to scalar generates,
            # so only the reassigned-away InSets drop their outputs
            self.ctx.ssn.clear()
            self.ctx.ssn.update(ssn_snap)
            self.ctx.write_ssn.clear()
            self.ctx.write_ssn.update(wssn_snap)
            for inset_id in inset_ids:
                self._generate_locked(inset_id)
            return
        self.stats["txns"] += 1
        self._since_state = 0 if snap_state \
            else self._since_state + len(runs)
        for inset_id, out_events, write_events, _ in runs:
            self.crash_point(op.id, "post_log")
            for e in out_events:
                self._send(e)
            self.stats["events_out"] += len(out_events)
            self.crash_point(op.id, "post_send")
            for w in write_events:
                self._after_durable(token, lambda w=w: self.execute_write(w))
            op.clear_inset(inset_id)

    def _send(self, e: Event):
        t0 = time.perf_counter()
        for ch in self.op.out_channels.get(e.send_port, []):
            if ch.rec_op == e.rec_op and ch.rec_port == e.rec_port:
                ch.put(e, stop_flag=self.stop_flag)
        # time blocked against the credit window (back-pressure from a
        # slow downstream) — the controller's stall-share signal
        self.stats["send_stall_us"] += int((time.perf_counter() - t0) * 1e6)

    # ---- side-effect reads (Algorithm 4) ----------------------------------
    def read_action(self, conn_id: str, desc: str, source: ReadSource):
        effect = source.effect(desc)
        if self.lineage_out:
            aid = len(self.pending_reads)
            ra = ReadAction(aid, self.op.id, conn_id, desc,
                            source.replayable)
            self.pending_reads.append((ra, effect))
        return effect

    # ---- write actions (Algorithm 5 + recovery Alg 8) ---------------------
    def execute_write(self, w: Event):
        self.crash_point(self.op.id, "pre_write")
        ok = self.external.execute(w.send_op, w.rec_port, w.event_id, w.body)
        if ok:
            self.crash_point(self.op.id, "post_write_pre_done")
            txn = self.store.begin()
            txn.set_status((w.send_op, w.send_port, w.event_id), DONE)
            txn.commit()

    def recover_writes(self):
        """Algorithm 8."""
        for w in self.store.get_write_actions(self.op.id):
            if self.external.status(w.send_op, w.rec_port, w.event_id) == "success":
                txn = self.store.begin()
                txn.set_status((w.send_op, w.send_port, w.event_id), DONE)
                txn.commit()
            else:
                self.execute_write(w)
