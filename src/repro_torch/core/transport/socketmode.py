"""The ``socket`` / ``tcp`` transports: direct worker-to-worker channels.

Event payloads travel on point-to-point sockets between worker processes
(one duplex connection per sender-group -> receiver-group pair, channels
multiplexed by name); the supervisor never touches an event.  The
connection handshake still speaks `multiprocessing.connection` (the
per-run ``authkey`` HMAC challenge + a ``hello`` frame), but once a pair
is introduced both sides drop to a **batched binary wire protocol**
(:mod:`repro_torch.core.transport.wire`): every event, ack, defer and release
queued for a peer since the last flusher wakeup coalesces into one
length-prefixed superframe written with a single vectored write.  Event
payloads are pickled exactly once (``Event.cache_blob`` — the same bytes
the log persists via ``put_event_blob``) and travel as buffer slices;
reconnect-replay re-transmits the cached blob without re-pickling.  Acks
are *delayed*: a flush that would carry only control entries lingers for
a small ``ack_flush`` window (default 2ms) so credit grants piggyback on
each other (and on any event heading the other way is not possible —
acks flow opposite to events — so they batch among themselves); any
queued event flushes immediately.

The listener **family is per-engine configuration**
(``transport_options={"family": "unix" | "inet"}``), not an import-time
constant: ``socket`` defaults to ``AF_UNIX`` where available, and the
registered ``tcp`` transport is the same implementation pinned to
``AF_INET`` — ``(host, port)`` listener addresses brokered through the
supervisor, so workers need not share a filesystem (the multi-host
prerequisite).

The supervisor retains only the authoritative *recovery* view: the log.
The **sender-side worker holds the reliable buffer** for each of its
channels, bounded at the credit window (= the channel capacity): ``put``
appends + enqueues for the wire and blocks while the buffer is full; the
receiver's ``ack``/``release`` entries returning over the socket are the
credit grants that free a slot.  Deferred acks advance a pending cursor
on the sender's buffer and keep holding their credit until ``release``
(the durability-watermark rule), exactly like the local transport.

Ack entries carry the event id and the sender matches them against its
FIFO head, so a stale ack (a duplicate the receiver obsolete-filtered
after a reconnect) can never pop the wrong event.

Crash anatomy (why a lost buffer is safe):

* **receiver dies** — the sender's buffer still holds every unreleased
  event.  The supervisor respawns the receiver, which reports a fresh
  listener address; the supervisor brokers it to the senders, which
  reconnect, ``reset_pending`` and re-transmit the whole buffer suffix
  (cached blobs, no re-pickle).  The receiver's obsolete filter (rebuilt
  from the log by Alg 9) drops the already-recovered prefix.  Blocked
  puts wake as the fresh receiver acks — a SIGKILL'd receiver never
  strands a sender.
* **sender dies** — its buffer is gone, but every buffered event was
  logged before send (Alg 3 step 4 precedes step 5), so the respawned
  worker's recovery resends the undone + unacknowledged suffix from the
  log (Alg 6/7) into a fresh buffer; receivers drop duplicates.  Events
  the receiver had already processed are acknowledged *in the log*
  (their InSet assignment) and are not resent.
* **whole tree dies** — both cases at once, per group, on restart.

A queued-but-unwritten entry is covered by the same invariant that
covers the wire: the event still occupies its sender channel's buffer
(it leaves only on an ack), so "all send buffers empty" subsumes the
flusher queues.  Delayed acks merely postpone quiescence by at most the
``ack_flush`` window.

Termination detection: with no central router the supervisor cannot
count deliveries, so it runs a two-wave probe (Mattern-style).  Workers
publish a snapshot only at main-loop iteration boundaries (never
mid-transaction): monotonic activity counter, send-buffer occupancy,
unprocessed receive backlog, deferred effects, exhaustion.  The run is
complete when two consecutive probe waves return all-empty snapshots
with unchanged activity counters from unchanged incarnations.  An event
in flight always occupies its sender's buffer (it leaves only on an
ack), so "all send buffers empty" covers the wire.
"""
from __future__ import annotations

import os
import socket as _socket
import threading
import time
from multiprocessing import AuthenticationError
from multiprocessing import connection as mpc
from typing import Dict, List, Optional, Tuple

from repro_torch.core.events import Event
from repro_torch.core.transport import wire
from repro_torch.core.transport.base import (SupervisorTransport, WorkerBootstrap,
                                       WorkerTransport, register_transport)
from repro_torch.core.transport.local import Channel

#: default linger before flushing an ack-only wire queue (seconds) —
#: long enough to coalesce the ack burst a processing loop emits,
#: short enough to be invisible next to the credit window
DEFAULT_ACK_FLUSH = 0.002


def default_family() -> str:
    """Platform default for the ``socket`` transport (``tcp`` always
    resolves to ``inet``)."""
    return "unix" if hasattr(_socket, "AF_UNIX") else "inet"


def _listener_for(options: Dict) -> mpc.Listener:
    """A fresh worker listener per the engine's transport options —
    family is per-engine config (testable AF_INET on hosts that also have
    AF_UNIX), never an import-time constant."""
    family = options.get("family") or default_family()
    authkey = options.get("authkey")
    if family == "inet":
        host = options.get("host", "127.0.0.1")
        return mpc.Listener((host, 0), family="AF_INET", authkey=authkey)
    if family == "unix":
        return mpc.Listener(family="AF_UNIX", authkey=authkey)
    raise ValueError(f"unknown socket family {family!r} "
                     "(expected 'unix' or 'inet')")


# ---------------------------------------------------------------------------
# batched peer connections
# ---------------------------------------------------------------------------

class BatchedConn:
    """A peer connection with a wire queue and a flusher thread.

    ``send_event``/``send_ctrl`` only append to the queue (cheap, called
    under channel locks); the flusher drains the queue into superframes.
    Entries for a dead peer are dropped best-effort — the log, not the
    wire, is the recovery authority.  Subclasses supply the byte I/O
    (socket fd here, shared-memory ring in ``shmring``).
    """

    def __init__(self, ack_flush: float = DEFAULT_ACK_FLUSH):
        self.alive = True
        self._q: List[Tuple] = []
        self._cv = threading.Condition()
        self._urgent = False        # an event entry is queued: flush now
        self._wt: Optional["SocketWorker"] = None
        self._ack_flush = ack_flush

    # -- producer side (channel locks held) --------------------------------
    def send_event(self, name: str, event_id: int, blob: bytes) -> bool:
        with self._cv:
            if not self.alive:
                return False
            self._q.append(("ev", name, event_id, blob))
            self._urgent = True
            self._cv.notify()
            return True

    def send_ctrl(self, kind: str, name: str, event_id: int) -> bool:
        with self._cv:
            if not self.alive:
                return False
            self._q.append((kind, name, event_id))
            self._cv.notify()
            return True

    def send_ctrl_many(self, kind: str, name: str, event_ids) -> bool:
        """A run of same-kind control entries under one queue lock — the
        batched consumption verbs emit one credit per event (id-matched
        FIFO on the sender), but need not pay the lock per entry."""
        with self._cv:
            if not self.alive:
                return False
            self._q.extend((kind, name, eid) for eid in event_ids)
            self._cv.notify()
            return True

    # -- threads -----------------------------------------------------------
    def start(self, wt: "SocketWorker", tag: str) -> None:
        self._wt = wt
        threading.Thread(target=self._flush_loop, daemon=True,
                         name=f"wire-flush-{tag}").start()
        threading.Thread(target=self._read_loop, daemon=True,
                         name=f"wire-read-{tag}").start()

    def _flush_loop(self):
        while True:
            with self._cv:
                while self.alive and not self._q:
                    self._cv.wait()
                if not self.alive:
                    return
                if not self._urgent and self._ack_flush > 0:
                    # ack-only queue: linger so credit grants coalesce;
                    # any event arriving during the linger flushes now
                    deadline = time.monotonic() + self._ack_flush
                    while self.alive and not self._urgent:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        self._cv.wait(left)
                    if not self.alive:
                        return
                batch, self._q = self._q, []
                self._urgent = False
            try:
                self._write_batch(batch)
            except (OSError, ValueError):
                self.alive = False
                return

    # -- I/O (subclass responsibility) -------------------------------------
    def _write_batch(self, batch: List[Tuple]) -> None:
        raise NotImplementedError

    def _read_loop(self) -> None:
        raise NotImplementedError

    def close(self) -> None:
        with self._cv:
            self.alive = False
            self._cv.notify_all()


class _WireConn(BatchedConn):
    """Socket-backed peer connection.  The `multiprocessing.connection`
    object performed the authkey challenge + hello handshake and now only
    owns the fd: all subsequent traffic is raw superframes (safe to mix —
    mpc reads are unbuffered exact-length reads, so nothing of the byte
    stream is sitting in a library buffer when we take over)."""

    def __init__(self, conn, ack_flush: float = DEFAULT_ACK_FLUSH):
        super().__init__(ack_flush)
        self.conn = conn
        self.fd = conn.fileno()

    def _write_batch(self, batch):
        bufs, total, n_ev, n_ctrl = wire.encode_superframe(batch)
        wire.write_buffers(self.fd, bufs, total)
        wt = self._wt
        if wt is not None:
            wt.wire_note(total, n_ev, n_ctrl)

    def _read_loop(self):
        dec = wire.SuperframeDecoder()
        wt = self._wt
        while True:
            try:
                data = os.read(self.fd, 1 << 16)
            except (OSError, ValueError):
                self.alive = False
                return
            if not data:
                self.alive = False
                return
            entries = list(dec.feed(data))
            if entries:
                wt.dispatch_many(entries)

    def close(self):
        super().close()
        try:
            self.conn.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# worker-side channels
# ---------------------------------------------------------------------------

class SocketSendChannel(Channel):
    """Sender-held reliable buffer, bounded at the credit window.  Only the
    worker's main thread puts; reader threads apply remote acks.

    FIFO discipline on reconnect: every wire entry for this channel is
    queued under the buffer lock, and ``_entry`` (the live connection)
    becomes visible only once ``resend_all`` has replayed the buffer on
    it.  A put racing a reconnect therefore either lands before the
    replay (covered by it, in order) or queues after it — a fresh entry
    can never overtake the re-transmission of older buffered events,
    which would ratchet the receiver's obsolete filter past unprocessed
    ids and silently drop them.  Each connection's queue drains FIFO into
    its superframes, preserving the order entries were enqueued."""

    #: tells the operator hot path to pre-pickle (``Event.cache_blob``)
    #: before logging, so the log and the wire share one encode
    prefer_blob = True

    def __init__(self, wt: "SocketWorker", send_op, send_port, rec_op,
                 rec_port, capacity: int):
        super().__init__(send_op, send_port, rec_op, rec_port,
                         capacity=capacity)
        self._wt = wt
        self._entry: Optional[BatchedConn] = None

    def put(self, ev, stop_flag=None, timeout: float = 0.05) -> bool:
        wt = self._wt
        blob = ev.cache_blob()          # pickle once, outside the lock
        with self._cv:
            while len(self._buf) >= self.capacity:
                if wt.stopped or (stop_flag is not None and stop_flag()):
                    return False
                self._cv.wait(timeout)
            if wt.stopped:
                return False
            self._buf.append(ev)
            self.total_put += 1
            entry = self._entry
            if entry is not None and entry.alive:
                entry.send_event(self.name, ev.event_id, blob)
        wt.bump()
        return True

    def resend_all(self, entry: BatchedConn):
        """Fresh connection to a (possibly restarted) receiver: rewind the
        deferred cursor, re-queue the full buffer suffix in order (cached
        blobs — no re-pickle), and only then adopt the connection for
        subsequent puts."""
        with self._cv:
            self._pending = 0
            for ev in self._buf:
                entry.send_event(self.name, ev.event_id, ev.cache_blob())
            self._entry = entry

    # -- remote consumption verbs (applied by reader threads) --------------
    def remote_ack(self, event_id) -> None:
        with self._cv:
            if len(self._buf) > self._pending \
                    and self._buf[self._pending].event_id == event_id:
                self._buf.pop(self._pending)
                self._cv.notify_all()
        self._wt.bump()

    def remote_defer(self, event_id) -> None:
        with self._cv:
            if len(self._buf) > self._pending \
                    and self._buf[self._pending].event_id == event_id:
                self._pending += 1
        self._wt.bump()

    def remote_release(self, event_id) -> None:
        with self._cv:
            if self._pending > 0 and self._buf \
                    and self._buf[0].event_id == event_id:
                self._pending -= 1
                self._buf.pop(0)
                self._cv.notify_all()
        self._wt.bump()


class SocketRecvChannel(Channel):
    """Receiver-side replica: reader threads deliver, the main loop
    consumes, and each consumption verb returns a credit to the sender as
    an id-matched ack entry (coalesced into the next superframe toward
    the sender)."""

    def __init__(self, wt: "SocketWorker", send_op, send_port, rec_op,
                 rec_port):
        super().__init__(send_op, send_port, rec_op, rec_port,
                         capacity=1_000_000)
        self._wt = wt

    def deliver_wire(self, event_id: int, header: dict, body) -> None:
        """Rebuild the event from this channel's identity + the wire
        payload — routing fields never travel, only (header, body)."""
        ev = Event(event_id, self.send_op, self.send_port,
                   self.rec_op, self.rec_port, body=body, header=header)
        with self._cv:
            self._buf.append(ev)
        self._wt.bump()

    def deliver_wire_many(self, payloads) -> None:
        """A decoded run of events for this channel: rebuild outside the
        lock, append under one acquisition, bump once."""
        evs = [Event(eid, self.send_op, self.send_port,
                     self.rec_op, self.rec_port, body=body, header=header)
               for (eid, header, body) in payloads]
        with self._cv:
            self._buf.extend(evs)
        self._wt.bump()

    def put(self, ev, stop_flag=None, timeout: float = 0.05) -> bool:
        raise RuntimeError(f"{self.name}: put on the receiving endpoint")

    def _ctrl(self, kind: str, ev):
        entry = self._wt.conn_in_for(self.name)
        if entry is not None:
            entry.send_ctrl(kind, self.name, ev.event_id)

    def ack(self):
        ev = super().ack()
        if ev is not None:
            self._ctrl("ack", ev)
            self._wt.bump()
        return ev

    def defer_ack(self):
        with self._cv:
            if len(self._buf) > self._pending:
                ev = self._buf[self._pending]
                self._pending += 1
            else:
                ev = None
        if ev is not None:
            self._ctrl("defer", ev)
            self._wt.bump()

    def release_ack(self):
        ev = super().release_ack()
        if ev is not None:
            self._ctrl("release", ev)
            self._wt.bump()
        return ev

    # -- batched consumption verbs -----------------------------------------
    # The inherited Channel.ack_run/defer_run mutate only the local replica;
    # here every consumed event must also return its credit to the sender,
    # so the vectored verbs collect the run under one lock and enqueue the
    # whole credit burst with one queue acquisition.

    def ack_run(self, n: int) -> int:
        with self._cv:
            k = min(n, len(self._buf) - self._pending)
            evs = self._buf[self._pending:self._pending + k]
            if k > 0:
                del self._buf[self._pending:self._pending + k]
                self._cv.notify_all()
        if evs:
            entry = self._wt.conn_in_for(self.name)
            if entry is not None:
                entry.send_ctrl_many("ack", self.name,
                                     [ev.event_id for ev in evs])
            self._wt.bump()
        return k

    def defer_run(self, n: int) -> int:
        with self._cv:
            k = min(n, len(self._buf) - self._pending)
            evs = self._buf[self._pending:self._pending + k]
            self._pending += k
        if evs:
            entry = self._wt.conn_in_for(self.name)
            if entry is not None:
                entry.send_ctrl_many("defer", self.name,
                                     [ev.event_id for ev in evs])
            self._wt.bump()
        return k


# ---------------------------------------------------------------------------
# worker transport
# ---------------------------------------------------------------------------

class SocketWorker(WorkerTransport):
    def __init__(self, bootstrap: WorkerBootstrap, group: str, tr_conn):
        self.group = group
        self.conn = tr_conn
        self.options = dict(bootstrap.transport_options)
        self.authkey = self.options.get("authkey")
        self.ack_flush = float(self.options.get("ack_flush",
                                                DEFAULT_ACK_FLUSH))
        self.stopped = False
        self._force = False
        self._reg = threading.Lock()       # conn registries + peer addrs
        self._tr_send_lock = threading.Lock()
        self._act_lock = threading.Lock()
        self.activity = 0
        self._snap_lock = threading.Lock()
        self._wire_lock = threading.Lock()
        self._wire = {"frames": 0, "bytes": 0, "events": 0,
                      "ctrl": 0, "ctrl_frames": 0}
        # True while the main loop is inside an iteration (or still in
        # recovery): consumption verbs may have run with their effects
        # (generation, write actions) still pending in-step, invisible to
        # any buffer — probes must treat the worker as busy
        self._stepping = True
        # until the first boundary the worker counts as busy (recovery)
        self._snap = {"exhausted": False, "pending": True, "deferred": 0}
        self.channels: Dict[str, Channel] = {}
        self._send_chs: Dict[str, SocketSendChannel] = {}
        self._recv_chs: Dict[str, SocketRecvChannel] = {}
        self._local_chs: Dict[str, Channel] = {}
        self._peer_of: Dict[str, str] = {}         # channel -> peer group
        groups = bootstrap.groups
        for ch in bootstrap.channels:
            send_in = groups.get(ch.send_op) == group
            rec_in = groups.get(ch.rec_op) == group
            if send_in and rec_in:
                c = Channel(ch.send_op, ch.send_port, ch.rec_op, ch.rec_port,
                            capacity=1_000_000)
                self._local_chs[ch.name] = c
            elif send_in:
                c = SocketSendChannel(self, ch.send_op, ch.send_port,
                                      ch.rec_op, ch.rec_port, ch.capacity)
                self._send_chs[ch.name] = c
                self._peer_of[ch.name] = groups.get(ch.rec_op)
            elif rec_in:
                c = SocketRecvChannel(self, ch.send_op, ch.send_port,
                                      ch.rec_op, ch.rec_port)
                self._recv_chs[ch.name] = c
                self._peer_of[ch.name] = groups.get(ch.send_op)
            else:
                continue
            self.channels[ch.name] = c
        self._out: Dict[str, BatchedConn] = {}     # peer group -> conn
        self._in: Dict[str, BatchedConn] = {}
        self._peer_addr: Dict[str, Tuple] = {}     # peer -> (addr, gen)
        self.listener = _listener_for(self.options)
        self._setup(bootstrap)
        threading.Thread(target=self._accept_loop, daemon=True,
                         name=f"sock-accept-{group}").start()
        threading.Thread(target=self._control_loop, daemon=True,
                         name=f"sock-ctl-{group}").start()
        self._tr_send(("addr", self._addr_payload()))

    # -- subclass hooks ----------------------------------------------------
    def _setup(self, bootstrap: WorkerBootstrap) -> None:
        """Extra transport state created before the address broadcast
        (the shm transport allocates its rings here)."""

    def _addr_payload(self):
        """What the supervisor brokers to peers as this worker's address."""
        return self.listener.address

    def _dial(self, peer: str, addr) -> Optional[BatchedConn]:
        """Open a fresh outbound connection to ``peer`` at ``addr`` (not
        yet started).  None if the peer is unreachable — a newer address
        broadcast will retry."""
        try:
            c = mpc.Client(self._sock_addr(addr), authkey=self.authkey)
            c.send(("hello", self.group))
        except (OSError, EOFError, AuthenticationError):
            return None
        return _WireConn(c, self.ack_flush)

    def _sock_addr(self, addr):
        """The socket address inside a brokered address payload."""
        return addr

    def _on_stop(self) -> None:
        """Clean-stop resource teardown (shm rings unlink here)."""

    # -- plumbing ----------------------------------------------------------
    def bump(self):
        with self._act_lock:
            self.activity += 1

    def wire_note(self, nbytes: int, n_ev: int, n_ctrl: int) -> None:
        with self._wire_lock:
            w = self._wire
            w["frames"] += 1
            w["bytes"] += nbytes
            w["events"] += n_ev
            w["ctrl"] += n_ctrl
            if n_ctrl:
                w["ctrl_frames"] += 1

    def _tr_send(self, msg):
        with self._tr_send_lock:
            try:
                self.conn.send(msg)
            except (OSError, ValueError):
                pass                      # supervisor gone: we exit soon

    def conn_in_for(self, ch_name: str) -> Optional[BatchedConn]:
        with self._reg:
            e = self._in.get(self._peer_of.get(ch_name))
        return e if e is not None and e.alive else None

    def dispatch(self, entry: Tuple) -> None:
        """Apply one decoded wire entry (called from reader threads)."""
        kind = entry[0]
        if kind == "ev":
            ch = self._recv_chs.get(entry[1])
            if ch is not None:
                ch.deliver_wire(entry[2], entry[3], entry[4])
        else:
            ch = self._send_chs.get(entry[1])
            if ch is not None:
                if kind == "ack":
                    ch.remote_ack(entry[2])
                elif kind == "defer":
                    ch.remote_defer(entry[2])
                elif kind == "release":
                    ch.remote_release(entry[2])

    def dispatch_many(self, entries: List[Tuple]) -> None:
        """Apply a decoded superframe worth of entries: consecutive event
        entries for the same channel land as one ``deliver_wire_many``
        (one lock, one activity bump); control entries keep their relative
        order against the events around them."""
        i, n = 0, len(entries)
        while i < n:
            entry = entries[i]
            if entry[0] != "ev":
                self.dispatch(entry)
                i += 1
                continue
            name = entry[1]
            j = i + 1
            while j < n and entries[j][0] == "ev" and entries[j][1] == name:
                j += 1
            ch = self._recv_chs.get(name)
            if ch is not None:
                if j - i == 1:
                    ch.deliver_wire(entry[2], entry[3], entry[4])
                else:
                    ch.deliver_wire_many(
                        [(e[2], e[3], e[4]) for e in entries[i:j]])
            i = j

    # -- threads -----------------------------------------------------------
    def _accept_loop(self):
        while not self.stopped:
            try:
                c = self.listener.accept()
                hello = c.recv()
            except AuthenticationError:
                continue                  # wrong/missing authkey: reject
            except (OSError, EOFError):
                if self.stopped:
                    return                # listener closed (stop)
                # a peer was SIGKILLed mid-handshake (the authkey
                # challenge adds blocking round-trips inside accept());
                # the listener itself is fine — a dead accept loop would
                # leave this worker unreachable and strand the next
                # connector inside its answer_challenge forever.  The
                # brief sleep bounds the spin if accept() itself fails
                # persistently (EMFILE, broken listener)
                time.sleep(0.01)
                continue
            if not (isinstance(hello, tuple) and hello[0] == "hello"):
                c.close()
                continue
            entry = _WireConn(c, self.ack_flush)
            with self._reg:
                self._in[hello[1]] = entry
            entry.start(self, f"{hello[1]}->{self.group}")

    def _control_loop(self):
        while True:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError):
                self.stopped = True
                return
            kind = msg[0]
            if kind == "peer":
                self._connect(msg[1], msg[2], msg[3])
            elif kind == "probe":
                self._tr_send(("snap", msg[1], self._probe_snapshot()))
            elif kind == "force":
                self._force = True
            elif kind == "stop":
                self.stopped = True
                try:
                    self.listener.close()
                except OSError:
                    pass
                self._on_stop()
                return

    def _connect(self, peer: str, addr, gen: int):
        """(Re)connect to a peer's fresh address and re-transmit the
        reliable buffers of every channel toward it."""
        with self._reg:
            cur = self._peer_addr.get(peer)
            e = self._out.get(peer)
            if cur == (addr, gen) and e is not None and e.alive:
                return                     # duplicate broadcast
            self._peer_addr[peer] = (addr, gen)
        entry = self._dial(peer, addr)
        if entry is None:
            return      # peer died again; a newer broadcast will follow
        with self._reg:
            old, self._out[peer] = self._out.get(peer), entry
        if old is not None:
            old.close()
        entry.start(self, f"{self.group}->{peer}")
        for name, ch in self._send_chs.items():
            if self._peer_of.get(name) == peer:
                ch.resend_all(entry)

    def _probe_snapshot(self) -> dict:
        """A probe reply. Buffer occupancy and the activity counter are
        read LIVE (a cached boundary snapshot could make two probe waves
        agree while work is in flight); ``exhausted``/``pending``/
        ``deferred`` come from the last boundary — their transitions only
        happen inside a step, and a step in progress is flagged by
        ``stepping`` while a completed one bumped ``activity``."""
        with self._snap_lock:
            snap = dict(self._snap)
        snap["outbuf"] = sum(len(c) for c in self._send_chs.values())
        # deferred-ack events held in the send buffers: they keep outbuf
        # non-zero until the durability watermark releases them, so the
        # supervisor must distinguish them from genuinely in-flight work
        # (quiescent-except-deferral triggers the force-drain)
        snap["outheld"] = sum(c.held() for c in self._send_chs.values())
        snap["inbuf"] = (
            sum(c.unprocessed() for c in self._recv_chs.values())
            + sum(c.unprocessed() for c in self._local_chs.values()))
        with self._act_lock:
            snap["activity"] = self.activity
        snap["stepping"] = self._stepping
        snap["pid"] = os.getpid()
        return snap

    # -- WorkerTransport ---------------------------------------------------
    def pump(self, timeout: float) -> None:
        if self.stopped:
            return
        if timeout:
            time.sleep(timeout)        # deliveries/acks arrive on threads

    def begin_step(self) -> None:
        self._stepping = True

    def take_force(self) -> bool:
        f, self._force = self._force, False
        return f

    def boundary(self, state: dict) -> None:
        snap = {
            "exhausted": state["exhausted"],
            "pending": state["pending"],
            "deferred": state["deferred"],
        }
        with self._snap_lock:
            self._snap = snap
        self._stepping = False

    def report_idle(self, state: dict) -> None:
        self.boundary(state)

    def send_stats(self, stats: dict) -> None:
        with self._wire_lock:
            wire_snap = dict(self._wire)
        stats = dict(stats)
        stats["__wire__"] = wire_snap
        self._tr_send(("stats", stats))


# ---------------------------------------------------------------------------
# supervisor side
# ---------------------------------------------------------------------------

class SocketSupervisor(SupervisorTransport):
    name = "socket"

    def __init__(self, driver):
        super().__init__(driver)
        self.addr: Dict[str, Tuple] = {}    # group -> (address, gen)
        self._gen = 0
        self._round = 0
        self._sig: Optional[Dict[str, Tuple[int, int]]] = None

    # -- address brokering -------------------------------------------------
    def _peer_msgs_locked(self, group: str) -> List[Tuple]:
        """(handle, msg) peer broadcasts involving ``group``'s channels:
        tell ``group`` where its receivers listen, and tell the workers
        that send into ``group`` about its (fresh) address."""
        d = self.driver
        groups = d.e.pipeline.groups
        out = {}
        for ch in d.ch_by_name.values():
            sg, rg = groups.get(ch.send_op), groups.get(ch.rec_op)
            if sg == rg:
                continue
            if sg == group and rg in self.addr:
                out[(group, rg)] = (d.workers.get(group),
                                    ("peer", rg) + self.addr[rg])
            if rg == group and group in self.addr:
                out[(sg, group)] = (d.workers.get(sg),
                                    ("peer", group) + self.addr[group])
        return [(h, m) for h, m in out.values() if h is not None]

    def tr_loop(self, h):
        d = self.driver
        conn = h.tr_conn
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
            kind = msg[0]
            sends: List[Tuple] = []
            with d.lock:
                if kind == "addr":
                    self._gen += 1
                    self.addr[h.group] = (msg[1], self._gen)
                    sends = self._peer_msgs_locked(h.group)
                elif kind == "snap":
                    h.probe = (msg[1], msg[2])
                elif kind == "stats":
                    d.record_stats(h.group, msg[1])
            for ph, pm in sends:           # pipe sends outside driver.lock
                ph.send(pm)

    def on_spawned(self, h):
        h.probe = None              # wait for the fresh incarnation

    def before_respawn(self, h):
        d = self.driver
        with d.lock:
            addr = self.addr.pop(h.group, None)  # stale listener died too
            h.probe = None
            self._sig = None
        if addr is not None:
            self._reclaim_addr(h.group, addr[0])

    def _reclaim_addr(self, group: str, addr) -> None:
        """Release any supervisor-reclaimable resources named in a dead
        group's address payload (shm rings; sockets die with the pid)."""

    def after_rewire(self):
        """Topology changed: re-broadcast every known address (workers
        ignore duplicates; restarted parties re-enter via the addr flow)."""
        d = self.driver
        sends: List[Tuple] = []
        with d.lock:
            for g in list(self.addr):
                sends.extend(self._peer_msgs_locked(g))
        seen = set()
        for ph, pm in sends:
            key = (id(ph), pm[1])
            if key not in seen:
                seen.add(key)
                ph.send(pm)

    def reinject(self, ev):
        """Alg 13 step 1.d: nothing to do — the dispatcher is restarted
        with ``recover=True`` right after the reassignment transaction and
        its log recovery resends every undone + unacknowledged output
        (including the reassigned ones) through its fresh buffers."""

    # -- termination (two-wave probe) --------------------------------------
    def _quiescent_sig(self, handles) -> Optional[Dict]:
        """None unless every worker's current-round snapshot is quiescent
        (at most deferral effects outstanding); else the
        {group: (pid, activity)} wave signature, or a ``__force__`` marker
        when the only outstanding work is gated on the durability
        watermark.  Deferred acks keep their events in the *sender's*
        buffer (``outheld``), so 'all send buffers empty' would deadlock
        against the end-of-stream force-drain — in-flight work is
        ``outbuf - outheld``."""
        sig = {}
        gated = False
        for h in handles:
            p = getattr(h, "probe", None)
            if p is None or p[0] != self._round:
                return None                       # wave incomplete
            s = p[1]
            if h.proc is None or s["pid"] != h.proc.pid:
                return None                       # stale incarnation
            if not s["exhausted"] or s["pending"] or s["inbuf"] \
                    or s["stepping"] or s["outbuf"] - s["outheld"]:
                return None
            if s["deferred"] or s["outheld"]:
                gated = True
            sig[h.group] = (s["pid"], s["activity"])
        if gated:
            # quiescent but effects still held by the durability
            # watermark: force-drain every worker (end of stream —
            # batches cannot grow, Alg 3 step 6 effects must release)
            return {"__force__": list(handles)}
        return sig

    def check_done(self) -> bool:
        d = self.driver
        to_force: List = []
        probes: List = []
        done = False
        with d.lock:
            handles = [h for h in d.workers.values()
                       if d.e.group_state.get(h.group) != "removed"]
            if not handles or not all(h.alive for h in handles):
                self._sig = None
            else:
                sig = self._quiescent_sig(handles)
                if isinstance(sig, dict) and "__force__" in sig:
                    to_force = sig["__force__"]
                    self._sig = None
                elif sig is not None:
                    if self._sig == sig:
                        done = True
                    self._sig = sig
                elif all(getattr(h, "probe", None) is not None
                         and h.probe[0] == self._round for h in handles):
                    self._sig = None              # wave complete, busy
                if not done:
                    # open (or repeat) a wave; repeats re-probe laggards
                    incomplete = [h for h in handles
                                  if getattr(h, "probe", None) is None
                                  or h.probe[0] != self._round]
                    if not incomplete:
                        self._round += 1
                        probes = list(handles)
                    else:
                        probes = incomplete
        for h in to_force:
            h.send(("force",))
        r = self._round
        for h in probes:
            h.send(("probe", r))
        return done

    def wait_group_drained(self, group: str, timeout: float = 5.0) -> bool:
        """Two stable all-empty snapshots from the group's worker: its
        send buffers acked empty (outputs reached their receivers' logs),
        no unprocessed backlog, no deferred effects."""
        d = self.driver
        deadline = time.time() + timeout
        prev = None
        while time.time() < deadline:
            with d.lock:
                h = d.workers.get(group)
                if h is None or not h.alive:
                    return False
                self._round += 1
                r = self._round
            h.send(("probe", r))
            t0 = time.time()
            snap = None
            while time.time() - t0 < 0.5:
                with d.lock:
                    p = getattr(h, "probe", None)
                    if p is not None and p[0] == r:
                        snap = p[1]
                        break
                time.sleep(0.002)
            if snap is not None and not snap["outbuf"] and not snap["inbuf"] \
                    and not snap["deferred"] and not snap["pending"] \
                    and not snap["stepping"]:
                if prev is not None and prev == snap["activity"]:
                    return True
                prev = snap["activity"]
            else:
                prev = None
            time.sleep(0.005)
        return False


class TcpSupervisor(SocketSupervisor):
    """``transport="tcp"``: the socket transport pinned to the ``AF_INET``
    listener family — ``(host, port)`` addresses brokered between workers
    that need not share a filesystem or a parent process.  The supervisor
    half is address-family-agnostic (addresses are opaque to the broker);
    only the name differs so CI matrices and engine config can select the
    family explicitly."""

    name = "tcp"


register_transport("socket", SocketSupervisor,
                   lambda bootstrap, group, conn: SocketWorker(
                       bootstrap, group, conn))
register_transport("tcp", TcpSupervisor,
                   lambda bootstrap, group, conn: SocketWorker(
                       bootstrap, group, conn))
