"""The ``routed`` transport: supervisor-pumped pipe channels (process mode).

Every channel's authoritative buffer lives in the supervisor (the reliable
piece — it survives any worker death); the supervisor streams each
channel's unprocessed suffix to the receiving worker's replica and the
replica forwards ``ack``/``defer_ack``/``release_ack`` back.  Kept next to
the newer ``socket`` transport for debuggability: every event crosses the
supervisor, so one process sees all traffic.

Credit-based back-pressure (replaces the old unbounded ``force_put``
absorption): the supervisor grants each *sender* worker a per-channel
credit window ``W = capacity - len(buffer)`` at spawn; a worker spends one
credit per put and blocks (FIFO, abortable on stop) at zero; the
supervisor returns one credit whenever an event leaves the authoritative
buffer — at ``ack`` and at ``release_ack`` (durability-watermark release),
*not* at ``defer_ack`` (deferred events still occupy capacity).  The
supervisor's buffer therefore never exceeds ``W``, and a slow consumer
back-pressures its senders instead of growing supervisor memory.  On a
sender restart the window is recomputed from the surviving buffer; on a
receiver restart occupancy is unchanged, so sender credits stay valid and
flow resumes as the fresh receiver acks (no stranded senders).

Intra-group edges (both operators in one worker) use a plain local
:class:`Channel` inside the worker: routing them through the supervisor
would deadlock a single-threaded worker blocked on its own consumer, and
the group loop drains them every iteration anyway.  Their reliability
story is the log: a group death loses both endpoints and the sender's
recovery resends the undone suffix (Alg 6/7).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.transport.base import (SupervisorTransport, WorkerTransport,
                                       register_transport)
from repro_torch.core.transport.local import Channel, ChannelClosed


# ---------------------------------------------------------------------------
# worker side
# ---------------------------------------------------------------------------

class RoutedWorkerChannel(Channel):
    """Worker-local replica of one authoritative supervisor channel. The
    supervisor streams deliveries into ``deliver``; consumption verbs
    forward so the authoritative buffer (which survives this process)
    tracks the replica exactly; ``put`` spends supervisor-granted credits."""

    def __init__(self, wt: "RoutedWorker", send_op, send_port, rec_op,
                 rec_port):
        # replica capacity is nominal: deliveries are bounded by the
        # authoritative buffer, itself bounded by the credit window
        super().__init__(send_op, send_port, rec_op, rec_port,
                         capacity=1_000_000)
        self._wt = wt

    def deliver(self, ev):
        with self._cv:
            self._buf.append(ev)

    def put(self, ev, stop_flag=None, timeout: float = 0.05) -> bool:
        return self._wt.credit_put(self.name, ev, stop_flag)

    def ack(self):
        ev = super().ack()
        if ev is not None:
            self._wt.conn.send(("ack", self.name))
        return ev

    def defer_ack(self):
        with self._cv:
            if len(self._buf) > self._pending:
                self._pending += 1
                self._wt.conn.send(("defer", self.name))

    def release_ack(self):
        ev = super().release_ack()
        if ev is not None:
            self._wt.conn.send(("release", self.name))
        return ev

    # vectored verbs: one control message per run instead of one per event
    def ack_run(self, n: int) -> int:
        k = Channel.ack_run(self, n)
        if k:
            self._wt.conn.send(("ackn", self.name, k))
        return k

    def defer_run(self, n: int) -> int:
        k = Channel.defer_run(self, n)
        if k:
            self._wt.conn.send(("defern", self.name, k))
        return k


class RoutedWorker(WorkerTransport):
    """Worker half: replica channels + the credit ledger + the pipe pump.
    The worker is single-threaded, so the pump doubles as the wait loop of
    a credit-blocked put (deliveries and credit grants keep flowing while
    the sender waits — no self-deadlock)."""

    def __init__(self, bootstrap, group: str, tr_conn):
        self.group = group
        self.conn = tr_conn
        self.stopped = False
        self._force = False
        self.n_received = 0
        self.credits: Dict[str, int] = {}
        self._last_idle: Optional[dict] = None
        self.channels: Dict[str, Channel] = {}
        groups = bootstrap.groups
        for ch in bootstrap.channels:
            send_in = groups.get(ch.send_op) == group
            rec_in = groups.get(ch.rec_op) == group
            if send_in and rec_in:
                # intra-group: pure local channel (see module docstring)
                self.channels[ch.name] = Channel(
                    ch.send_op, ch.send_port, ch.rec_op, ch.rec_port,
                    capacity=1_000_000)
            elif send_in or rec_in:
                self.channels[ch.name] = RoutedWorkerChannel(
                    self, ch.send_op, ch.send_port, ch.rec_op, ch.rec_port)

    # -- pump --------------------------------------------------------------
    def pump(self, timeout: float) -> None:
        conn = self.conn
        if not conn.poll(timeout):
            return
        while True:
            msg = conn.recv()
            kind = msg[0]
            if kind == "ev":
                ch = self.channels.get(msg[1])
                if isinstance(ch, RoutedWorkerChannel):
                    ch.deliver(msg[2])
                self.n_received += 1
            elif kind == "credit":
                self.credits[msg[1]] = self.credits.get(msg[1], 0) + msg[2]
            elif kind == "force":
                self._force = True
            elif kind == "stop":
                self.stopped = True
            if not conn.poll(0):
                return

    def credit_put(self, name: str, ev, stop_flag) -> bool:
        """Spend one credit and forward the event; block while the window
        is exhausted (the supervisor returns credits at ack/release)."""
        while self.credits.get(name, 0) <= 0:
            if self.stopped or (stop_flag is not None and stop_flag()):
                return False
            self.pump(0.02)
        self.credits[name] -= 1
        self.conn.send(("put", name, ev))
        return True

    # -- reporting ---------------------------------------------------------
    def take_force(self) -> bool:
        f, self._force = self._force, False
        return f

    def boundary(self, state: dict) -> None:
        pass            # the supervisor's own delivery counters are the
        # consistent view in routed mode (pipe FIFO makes put-before-idle
        # ordering visible to the router)

    def report_idle(self, state: dict) -> None:
        state = dict(state, n_received=self.n_received)
        if state != self._last_idle:
            self.conn.send(("idle", state))
            self._last_idle = state

    def send_stats(self, stats: dict) -> None:
        self.conn.send(("stats", stats))


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------

class RoutedSupervisor(SupervisorTransport):
    name = "routed"

    def __init__(self, driver):
        super().__init__(driver)
        # channel -> events delivered to the receiver, not yet consumed
        self.inflight: Dict[str, int] = {}
        self.sync_channels()

    # -- channel registry --------------------------------------------------
    def sync_channels(self):
        d = self.driver
        with d.lock:
            for name in d.ch_by_name:
                self.inflight.setdefault(name, 0)
            for name in list(self.inflight):
                if name not in d.ch_by_name:
                    del self.inflight[name]

    def _intra(self, ch) -> bool:
        g = self.driver.e.pipeline.groups
        return g.get(ch.send_op) == g.get(ch.rec_op)

    # -- delivery pump -----------------------------------------------------
    def _pump(self, name: str):
        """Stream the channel's undelivered suffix to its receiving
        worker. Cursor reads/updates happen under ``driver.lock``; the
        (possibly blocking) pipe send happens OUTSIDE it, under the
        worker's ``pump_lock``, so one slow worker's full pipe never
        stalls routing for the other workers or the supervisor."""
        d = self.driver
        with d.lock:
            ch = d.ch_by_name.get(name)
            if ch is None or self._intra(ch):
                return
            h = d.workers.get(d.e.pipeline.groups.get(ch.rec_op))
        if h is None:
            return
        with h.pump_lock:
            while True:
                with d.lock:
                    if d.ch_by_name.get(name) is not ch or not h.alive:
                        return
                    ev = ch.peek_index(self.inflight.get(name, 0))
                if ev is None:
                    return
                if not h.send(("ev", name, ev)):
                    return
                with d.lock:
                    self.inflight[name] += 1
                    h.sent += 1

    def _pump_group(self, group: str):
        d = self.driver
        with d.lock:
            names = [name for name, ch in d.ch_by_name.items()
                     if d.e.pipeline.groups.get(ch.rec_op) == group]
        for name in names:
            self._pump(name)

    def after_rewire(self):
        """Deliver any undelivered suffix on every channel (used after
        dynamic-scaling rewires put events in from the parent side)."""
        self.sync_channels()
        d = self.driver
        with d.lock:
            names = list(d.ch_by_name)
        for name in names:
            self._pump(name)

    def reinject(self, ev):
        """Alg 13 step 1.d re-send into the authoritative buffer. The
        event is already logged as sent, so the buffer must absorb it
        (the set is bounded by the reassignment, not by the stream)."""
        d = self.driver
        with d.lock:
            chans = list(d.ch_by_name.values())
        for ch in chans:
            if ch.send_op == ev.send_op and ch.send_port == ev.send_port \
                    and ch.rec_op == ev.rec_op and ch.rec_port == ev.rec_port:
                ch.force_put(ev)

    # -- credit ledger -----------------------------------------------------
    def _sender_of_locked(self, ch):
        """(handle, incarnation) of the channel's sender worker — captured
        under the driver lock at buffer-pop time, so the grant can be
        pinned to the incarnation whose window the pop belongs to."""
        h = self.driver.workers.get(
            self.driver.e.pipeline.groups.get(ch.send_op))
        return (h, h.incarnation if h is not None else 0)

    def on_spawn_locked(self, h) -> List:
        """Fresh incarnation: (re)compute its send windows from surviving
        buffer occupancy — a restart never strands a sender, and because
        this runs in the spawn critical section (same lock hold as the
        incarnation bump) no concurrent ack-grant can double-count a pop
        this window already reflects."""
        d = self.driver
        msgs: List = []
        for name, ch in d.ch_by_name.items():
            if self._intra(ch):
                continue
            if d.e.pipeline.groups.get(ch.send_op) == h.group:
                n = max(0, ch.capacity - len(ch))
                if n:
                    msgs.append(("credit", name, n))
        return msgs

    def on_spawned(self, h):
        self._pump_group(h.group)

    def before_respawn(self, h):
        """Receiver-side rewind: unreleased deliveries become deliverable
        again; the restarted group's obsolete filters drop what recovery
        already covered. Holds the pump lock so a stale pump of the dead
        incarnation finishes or fails before the cursors move."""
        d = self.driver
        with h.pump_lock:
            with d.lock:
                for name, ch in d.ch_by_name.items():
                    if d.e.pipeline.groups.get(ch.rec_op) == h.group \
                            and not self._intra(ch):
                        ch.reset_pending()
                        self.inflight[name] = 0

    # -- router thread -----------------------------------------------------
    def tr_loop(self, h):
        d = self.driver
        conn = h.tr_conn
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
            kind = msg[0]
            pump = grant = None
            with d.lock:
                if kind == "put":
                    _, name, ev = msg
                    ch = d.ch_by_name.get(name)
                    if ch is not None:
                        # the sender spent a credit, so occupancy stays
                        # within the window; absorb (the event is logged
                        # as sent — dropping it would strand UNDONE rows)
                        try:
                            ch.force_put(ev)
                        except ChannelClosed:
                            pass           # engine stopping
                        pump = name
                elif kind == "ack":
                    ch = d.ch_by_name.get(msg[1])
                    if ch is not None and ch.ack() is not None:
                        self.inflight[msg[1]] -= 1
                        grant = (msg[1],) + self._sender_of_locked(ch) + (1,)
                elif kind == "ackn":
                    # vectored ack: k events leave the authoritative buffer
                    # under one lock hold, one credit grant of k returns
                    ch = d.ch_by_name.get(msg[1])
                    if ch is not None:
                        k = ch.ack_run(msg[2])
                        if k:
                            self.inflight[msg[1]] -= k
                            grant = (msg[1],) + self._sender_of_locked(ch) \
                                + (k,)
                elif kind == "defer":
                    ch = d.ch_by_name.get(msg[1])
                    if ch is not None:
                        ch.defer_ack()
                        self.inflight[msg[1]] -= 1
                        # no grant: deferred events still hold their credit
                elif kind == "defern":
                    ch = d.ch_by_name.get(msg[1])
                    if ch is not None:
                        k = ch.defer_run(msg[2])
                        self.inflight[msg[1]] -= k
                elif kind == "release":
                    ch = d.ch_by_name.get(msg[1])
                    if ch is not None and ch.release_ack() is not None:
                        grant = (msg[1],) + self._sender_of_locked(ch) + (1,)
                elif kind == "idle":
                    h.last_idle = msg[1]
                elif kind == "stats":
                    d.record_stats(h.group, msg[1])
            # pipe sends outside driver.lock: a full pipe toward a slow
            # worker must not stall this router thread's peers. The grant
            # is pinned to the sender incarnation captured at pop time —
            # a fresh incarnation's initial window already reflects the
            # pop, so landing it there would double-grant.
            if grant is not None:
                name, gh, inc, k = grant
                if gh is not None:
                    gh.send(("credit", name, k), incarnation=inc)
            if pump is not None:
                self._pump(pump)

    # -- termination / drain ----------------------------------------------
    def check_done(self) -> bool:
        d = self.driver
        to_force: List = []
        with d.lock:
            deferred = 0
            for h in d.workers.values():
                if d.e.group_state.get(h.group) == "removed":
                    continue
                st = h.last_idle
                if not h.alive or st is None \
                        or st["n_received"] != h.sent \
                        or not st["exhausted"] or st["pending"]:
                    return False
                deferred += st["deferred"]
            if any(self.inflight.get(n, 0) for n in d.ch_by_name):
                return False
            if deferred == 0 and \
                    all(len(ch) == 0 for ch in d.ch_by_name.values()):
                return True
            # quiescent but effects still gated on the durability
            # watermark: force-drain (end of stream — batches cannot grow)
            for h in d.workers.values():
                if h.alive and (h.last_idle or {}).get("deferred"):
                    h.last_idle = None
                    to_force.append(h)
        for h in to_force:       # pipe sends outside the driver lock
            h.send(("force",))
        return False

    def wait_group_drained(self, group: str, timeout: float = 5.0) -> bool:
        import time
        d = self.driver
        group_ops = set(d.e.group_ops(group))
        deadline = time.time() + timeout
        while time.time() < deadline:
            with d.lock:
                h = d.workers.get(group)
                chans = [ch for ch in d.ch_by_name.values()
                         if ch.rec_op in group_ops or ch.send_op in group_ops]
                st = h.last_idle if h is not None else None
                if h is not None and h.alive and st is not None \
                        and st["n_received"] == h.sent \
                        and st["deferred"] == 0 \
                        and all(len(c) == 0 for c in chans):
                    return True
            time.sleep(0.005)
        return False


register_transport("routed", RoutedSupervisor,
                   lambda bootstrap, group, conn: RoutedWorker(
                       bootstrap, group, conn))
