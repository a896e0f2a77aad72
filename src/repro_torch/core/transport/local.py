"""The ``local`` transport: reliable in-memory FIFO channels with capacity
back-pressure (Sec. 2.1) — one shared buffer is both endpoints.

Semantics:
  * ``put`` blocks while the buffer is full (the credit window: capacity
    minus buffered events is exactly the sender's credit balance); a
    blocked put aborts if the engine is stopping or the channel closed.
  * ``peek``/``ack``: the receiver *peeks* the head, runs its State-Update
    transaction, then ``ack``s to remove it — an event leaves the channel
    only once acknowledged (assigned an InSet_ID). A receiver crash between
    peek and ack leaves the event in place.
  * deferred acks (group-commit pipelining): with a batched log backend the
    ack may only be *released* once the State-Update transaction is durable
    (the durability-watermark rule). ``defer_ack`` marks the head event
    processed-but-unreleased and advances the peek cursor so the receiver
    keeps processing; ``release_ack`` later removes it FIFO. Deferred events
    still occupy capacity (their credit returns only at release) and still
    count in ``len`` (the engine's idle detection waits for the flush). On
    a receiver restart ``reset_pending`` rewinds the cursor: unreleased
    events are simply re-delivered and the obsolete filter drops the
    already-recovered ones.
  * Channel contents survive operator restarts (the transport is the
    reliable piece, like the in-house TCP messaging + buffers in SAP DI).
  * A closed channel accepts no further events: ``put``/``try_put`` report
    failure and ``force_put`` raises — an event silently absorbed after
    ``close()`` would be stranded forever (nobody drains a closed buffer).
"""
from __future__ import annotations

import threading
from typing import List, Optional

from repro_torch.core.events import Event
from repro_torch.core.transport.base import ChannelEndpoint


class ChannelClosed(Exception):
    pass


class Channel(ChannelEndpoint):
    def __init__(self, send_op: str, send_port: str, rec_op: str,
                 rec_port: str, capacity: int = 64):
        self.send_op, self.send_port = send_op, send_port
        self.rec_op, self.rec_port = rec_op, rec_port
        self.capacity = capacity
        self._buf: List[Event] = []
        self._pending = 0       # processed-but-unreleased events at the head
        self._cv = threading.Condition()
        self._closed = False
        self.total_put = 0

    def put(self, ev: Event, stop_flag=None, timeout: float = 0.05) -> bool:
        """Blocking put with back-pressure. Returns False if stopping."""
        with self._cv:
            while len(self._buf) >= self.capacity:
                if self._closed or (stop_flag is not None and stop_flag()):
                    return False
                self._cv.wait(timeout)
            if self._closed:
                return False
            self._buf.append(ev)
            self.total_put += 1
            self._cv.notify_all()
            return True

    def try_put(self, ev: Event) -> bool:
        with self._cv:
            if self._closed or len(self._buf) >= self.capacity:
                return False
            self._buf.append(ev)
            self.total_put += 1
            self._cv.notify_all()
            return True

    def force_put(self, ev: Event):
        """Append ignoring capacity — reserved for supervisor-side paths
        that must absorb an already-logged event (Alg 13 reassignment
        re-sends): the set is bounded by the reassignment, and dropping
        one would strand an UNDONE row forever. Raises on a closed
        channel instead of stranding the event in a buffer nobody reads."""
        with self._cv:
            if self._closed:
                raise ChannelClosed(self.name)
            self._buf.append(ev)
            self.total_put += 1
            self._cv.notify_all()

    def peek(self) -> Optional[Event]:
        """Head of the unprocessed suffix (skips deferred-ack events)."""
        with self._cv:
            return self._buf[self._pending] \
                if len(self._buf) > self._pending else None

    def peek_index(self, i: int) -> Optional[Event]:
        """i-th event of the unprocessed suffix — the routed transport's
        delivery cursor (events stay here, the reliable buffer, until the
        remote receiver acks)."""
        with self._cv:
            j = self._pending + i
            return self._buf[j] if len(self._buf) > j else None

    def peek_run(self, n: int) -> List[Event]:
        """Up to ``n`` events from the head of the unprocessed suffix, in
        FIFO order — the receiver's micro-batch. A snapshot only: events
        stay buffered until individually acked/deferred, so a crash
        mid-run re-delivers the unacked suffix."""
        with self._cv:
            j = self._pending
            return list(self._buf[j:j + n])

    def ack(self) -> Optional[Event]:
        """Immediately remove the event ``peek`` returned."""
        with self._cv:
            ev = self._buf.pop(self._pending) \
                if len(self._buf) > self._pending else None
            self._cv.notify_all()
            return ev

    def ack_run(self, n: int) -> int:
        """Vectored ``ack``: remove the first ``n`` unprocessed events in
        one lock acquisition. Returns the count actually removed."""
        with self._cv:
            k = min(n, len(self._buf) - self._pending)
            if k > 0:
                del self._buf[self._pending:self._pending + k]
                self._cv.notify_all()
            return k

    def defer_run(self, n: int) -> int:
        """Vectored ``defer_ack``: mark the first ``n`` unprocessed events
        processed-but-unreleased in one lock acquisition."""
        with self._cv:
            k = min(n, len(self._buf) - self._pending)
            self._pending += k
            return k

    def defer_ack(self):
        """Mark the event ``peek`` returned as processed; it stays buffered
        until ``release_ack`` (durability watermark reached)."""
        with self._cv:
            if len(self._buf) > self._pending:
                self._pending += 1

    def release_ack(self) -> Optional[Event]:
        """Release the oldest deferred ack (FIFO)."""
        with self._cv:
            if self._pending == 0:
                return None
            self._pending -= 1
            ev = self._buf.pop(0)
            self._cv.notify_all()
            return ev

    def reset_pending(self):
        """Receiver restart: unreleased events become deliverable again."""
        with self._cv:
            self._pending = 0

    def __len__(self):
        with self._cv:
            return len(self._buf)

    def unprocessed(self) -> int:
        """Events awaiting processing (buffered minus deferred)."""
        with self._cv:
            return len(self._buf) - self._pending

    def held(self) -> int:
        """Deferred-ack events still occupying capacity (the durability
        watermark has not released them yet)."""
        with self._cv:
            return self._pending

    def clear(self):
        """Used only by the ABS baseline (global restart discards in-flight
        events) — never by LOG.io recovery."""
        with self._cv:
            self._buf.clear()
            self._pending = 0
            self._cv.notify_all()

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()
