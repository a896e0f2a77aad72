"""The ``shm`` transport: shared-memory ring channels for co-located pairs.

Same-host worker pairs exchange superframes through a pair of fixed-size
single-producer/single-consumer byte rings over
``multiprocessing.shared_memory`` — a *data* ring (sender -> receiver)
and an *ack* ring (receiver -> sender) — instead of a socket: an event
hop is two ``memcpy``s and two cursor stores, no syscalls on the data
path.  Placement decides per pair: the engine injects its
:class:`~repro_torch.core.transport.base.Placement` node map into the
transport options, and a sender whose peer lives on another node falls
back to the brokered socket dial unchanged (the ``shm`` transport *is*
the socket transport plus rings for co-located pairs).

Everything above the byte pipe is shared with ``socketmode``: the same
superframe format (:mod:`repro_torch.core.transport.wire`), the same
:class:`~repro_torch.core.transport.socketmode.BatchedConn` queue + flusher
(delayed acks included), the same sender-held reliable buffers and
credit semantics — so SIGKILL recovery and reconnect-replay hold
verbatim.  The ring is just a byte stream: partially-written superframes
are fine (the decoder is incremental), and a writer blocked on a full
ring never deadlocks because the peer's reader thread always drains.

Ring layout (64-byte header + data)::

    u64 head         # writer cursor, monotonic byte count
    u64 tail         # reader cursor, monotonic byte count
    u32 attach_gen   # bumped by the attaching (non-creator) side
    u32 sync_gen     # creator's acknowledgement of attach_gen

``head``/``tail`` never wrap (positions are ``cursor % capacity``); the
free space is ``capacity - (head - tail)``.  Cursor stores are 8-byte
aligned single stores under x86-TSO — the data ``memcpy`` is globally
visible before the cursor store that publishes it.

**Incarnation resync.**  The receiver creates both rings; the sender
attaches.  A respawned sender must not inherit the byte stream mid-frame
(the dead incarnation may have died between the chunked writes of one
superframe, or mid-read with a frame prefix swallowed into its decoder),
so each ring runs a generation dance on attach:

* data ring (attacher = writer): the fresh sender bumps ``attach_gen``
  and waits; the receiver's reader loop notices, discards unread bytes
  (``tail = head``), resets its decoder, and publishes ``sync_gen`` —
  only then does the sender write.  Discarded bytes are events the
  *dead* incarnation sent; the fresh incarnation re-sends its whole
  reliable buffer (reconnect-replay) right after the dance.
* ack ring (attacher = reader): the fresh sender bumps ``attach_gen``
  and waits; the receiver's *write path* notices before its next frame,
  discards unread acks (``tail = head``) and publishes ``sync_gen`` —
  the fresh reader then starts at a frame boundary.  Dropped acks
  belonged to the dead incarnation; the events they acknowledged are
  re-sent by recovery and the receiver's obsolete filter re-acks them.

**Lifecycle.**  This Python registers every segment with the
``resource_tracker`` on create *and* attach, which would let a dying
worker's tracker unlink rings still in use — so every handle is
unregistered immediately and unlinking is explicit: a worker unlinks its
own rings on clean stop, the supervisor unlinks a dead incarnation's
rings before respawning it (``_reclaim_addr``) and sweeps all known
rings at engine stop.  ``FileNotFoundError`` on unlink is always
tolerated (both ends may race to clean the same name).
"""
from __future__ import annotations

import os
import struct
import time
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, Optional, Tuple

from repro_torch.core.transport import wire
from repro_torch.core.transport.base import WorkerBootstrap, register_transport
from repro_torch.core.transport.socketmode import (BatchedConn, SocketSupervisor,
                                             SocketWorker)

#: default ring capacity (bytes) per direction; ``transport_options
#: ["ring_bytes"]`` overrides
DEFAULT_RING_BYTES = 4 * 1024 * 1024

_HDR = 64
_U64 = struct.Struct("<Q")
_U32 = struct.Struct("<I")
_OFF_HEAD = 0
_OFF_TAIL = 8
_OFF_AGEN = 16
_OFF_SGEN = 20

#: reader/writer poll interval while the ring is empty/full
_POLL = 0.0002

_name_seq = 0


def _ring_name() -> str:
    global _name_seq
    _name_seq += 1
    return f"logio-{os.getpid()}-{_name_seq}"


def _untrack(shm: shared_memory.SharedMemory) -> None:
    """This Python's ``SharedMemory`` registers with the resource tracker
    on attach as well as create; ring lifetime is managed explicitly."""
    try:
        resource_tracker.unregister(shm._name, "shared_memory")
    except Exception:
        pass


def unlink_ring(name: str) -> None:
    """Best-effort unlink of a ring segment by name (idempotent).  Goes
    straight to ``shm_unlink`` — attaching first would re-register with
    the resource tracker and the eventual double-unregister makes the
    tracker process log spurious KeyErrors."""
    try:
        _posixshmem = shared_memory._posixshmem
    except AttributeError:
        return                     # non-POSIX platform: nothing to unlink
    try:
        _posixshmem.shm_unlink("/" + name)
    except (FileNotFoundError, OSError):
        pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def sweep_stale_rings() -> int:
    """Unlink ring segments whose creator pid is gone — the backstop for
    a SIGKILL of the *whole* engine tree (supervisor included), after
    which no live process knows the names.  Ring names embed the creator
    pid (``logio-<pid>-<seq>``); a fresh shm supervisor sweeps on start."""
    shm_dir = "/dev/shm"
    if not os.path.isdir(shm_dir):
        return 0
    n = 0
    for fn in os.listdir(shm_dir):
        if not fn.startswith("logio-"):
            continue
        parts = fn.split("-")
        try:
            pid = int(parts[1])
        except (IndexError, ValueError):
            continue
        if _pid_alive(pid):
            continue
        unlink_ring(fn)
        n += 1
    return n


class ShmRing:
    """One SPSC byte ring. The creator zeroes the header; the attacher
    runs the generation dance before first use (see module docstring)."""

    def __init__(self, shm: shared_memory.SharedMemory, creator: bool):
        self.shm = shm
        self.creator = creator
        self.capacity = shm.size - _HDR
        self._buf = shm.buf
        self._seen_agen: Optional[int] = None   # creator-writer resync state

    # -- construction ------------------------------------------------------
    @classmethod
    def create(cls, size: int) -> "ShmRing":
        shm = shared_memory.SharedMemory(name=_ring_name(), create=True,
                                         size=_HDR + size)
        _untrack(shm)
        shm.buf[:_HDR] = bytes(_HDR)
        return cls(shm, creator=True)

    @classmethod
    def attach(cls, name: str) -> "ShmRing":
        shm = shared_memory.SharedMemory(name=name)
        _untrack(shm)
        return cls(shm, creator=False)

    @property
    def name(self) -> str:
        return self.shm.name

    # -- header accessors --------------------------------------------------
    def _u64(self, off: int) -> int:
        return _U64.unpack_from(self._buf, off)[0]

    def _set_u64(self, off: int, v: int) -> None:
        _U64.pack_into(self._buf, off, v)

    def _u32(self, off: int) -> int:
        return _U32.unpack_from(self._buf, off)[0]

    def _set_u32(self, off: int, v: int) -> None:
        _U32.pack_into(self._buf, off, v)

    # -- attach dance ------------------------------------------------------
    def attacher_handshake(self, alive) -> bool:
        """Bump ``attach_gen`` and wait for the creator's ``sync_gen`` to
        catch up.  Returns False if ``alive()`` goes false first."""
        gen = (self._u32(_OFF_AGEN) + 1) & 0xFFFFFFFF
        self._set_u32(_OFF_AGEN, gen)
        while self._u32(_OFF_SGEN) != gen:
            if not alive():
                return False
            time.sleep(_POLL)
        return True

    def reader_resync_check(self) -> bool:
        """Creator-reader duty (data ring): acknowledge a fresh attacher
        by discarding unread bytes.  True when the caller must reset its
        decoder."""
        agen = self._u32(_OFF_AGEN)
        if agen == self._u32(_OFF_SGEN):
            return False
        self._set_u64(_OFF_TAIL, self._u64(_OFF_HEAD))
        self._set_u32(_OFF_SGEN, agen)
        return True

    def _writer_resync_check(self) -> None:
        """Creator-writer duty (ack ring): acknowledge a fresh attacher
        before the next frame, discarding acks addressed to the dead
        incarnation (the stream restarts at a frame boundary)."""
        agen = self._u32(_OFF_AGEN)
        if self._seen_agen is None:
            self._seen_agen = self._u32(_OFF_SGEN)
        if agen != self._seen_agen:
            self._set_u64(_OFF_TAIL, self._u64(_OFF_HEAD))
            self._set_u32(_OFF_SGEN, agen)
            self._seen_agen = agen

    # -- byte pipe ---------------------------------------------------------
    def write_bytes(self, data, alive) -> None:
        """Blocking write of the whole buffer; raises OSError if
        ``alive()`` goes false while the ring is full."""
        mv = memoryview(data)
        if mv.format != "B":
            mv = mv.cast("B")
        n = len(mv)
        off = 0
        cap = self.capacity
        buf = self._buf
        while off < n:
            if self.creator:
                self._writer_resync_check()
            head = self._u64(_OFF_HEAD)
            space = cap - (head - self._u64(_OFF_TAIL))
            if space == 0:
                if not alive():
                    raise OSError("shm ring peer gone")
                time.sleep(_POLL)
                continue
            pos = head % cap
            k = min(space, n - off, cap - pos)
            buf[_HDR + pos:_HDR + pos + k] = mv[off:off + k]
            off += k
            self._set_u64(_OFF_HEAD, head + k)

    def read_avail(self, maxn: int = 1 << 16) -> bytes:
        """Up to ``maxn`` available bytes (empty bytes when none)."""
        tail = self._u64(_OFF_TAIL)
        avail = self._u64(_OFF_HEAD) - tail
        if avail <= 0:
            return b""
        pos = tail % self.capacity
        k = min(avail, maxn, self.capacity - pos)
        data = bytes(self._buf[_HDR + pos:_HDR + pos + k])
        self._set_u64(_OFF_TAIL, tail + k)
        return data

    # -- lifecycle ---------------------------------------------------------
    def close(self) -> None:
        self._buf = None
        try:
            self.shm.close()
        except (OSError, BufferError):
            pass

    def unlink(self) -> None:
        # raw unlink: the handle was unregistered from the tracker at
        # construction, so SharedMemory.unlink()'s unregister would be a
        # noisy double-remove
        unlink_ring(self.shm.name)


class _ShmConn(BatchedConn):
    """A peer connection over a ring pair.  ``out_ring`` carries this
    side's superframes, ``in_ring`` the peer's.  The attacher (sender
    side) runs the generation dance on both rings before first use."""

    def __init__(self, out_ring: ShmRing, in_ring: ShmRing,
                 ack_flush: float):
        super().__init__(ack_flush)
        self.out_ring = out_ring
        self.in_ring = in_ring
        self._attached_out = False

    def _write_batch(self, batch):
        if self.out_ring.creator is False and not self._attached_out:
            # fresh attacher: resync the stream before the first frame
            if not self.out_ring.attacher_handshake(lambda: self.alive):
                raise OSError("shm ring peer gone during attach")
            self._attached_out = True
        bufs, total, n_ev, n_ctrl = wire.encode_superframe(batch)
        for b in bufs:
            self.out_ring.write_bytes(b, lambda: self.alive)
        wt = self._wt
        if wt is not None:
            wt.wire_note(total, n_ev, n_ctrl)

    def _read_loop(self):
        ring = self.in_ring
        wt = self._wt
        if not ring.creator:
            # ack-ring reader attach: wait for the peer's write path to
            # restart the stream at a frame boundary
            if not ring.attacher_handshake(lambda: self.alive):
                return
        dec = wire.SuperframeDecoder()
        idle = 0
        while self.alive:
            if ring.creator and ring.reader_resync_check():
                dec = wire.SuperframeDecoder()   # fresh sender incarnation
            data = ring.read_avail()
            if data:
                idle = 0
                entries = list(dec.feed(data))
                if entries:
                    wt.dispatch_many(entries)
            else:
                # spin briefly (a burst is usually mid-flight), then doze
                idle += 1
                if idle > 50:
                    time.sleep(_POLL)

    def close(self):
        super().close()
        self.out_ring.close()
        self.in_ring.close()


class ShmWorker(SocketWorker):
    """Socket worker + rings toward co-located peers.  Ring pairs for
    every co-located *inbound* peer are created before the address
    broadcast and travel inside the address payload; co-located senders
    attach instead of dialing.  Cross-node (or unplaced) peers use the
    brokered socket path unchanged."""

    def _setup(self, bootstrap: WorkerBootstrap) -> None:
        self.placement: Dict[str, str] = dict(
            self.options.get("placement") or {})
        self.ring_bytes = int(self.options.get("ring_bytes",
                                               DEFAULT_RING_BYTES))
        self._rings: Dict[str, Tuple[ShmRing, ShmRing]] = {}
        for name in self._recv_chs:
            peer = self._peer_of.get(name)
            if peer is None or peer in self._rings:
                continue
            if not self._colocated(peer):
                continue
            data_ring = ShmRing.create(self.ring_bytes)
            ack_ring = ShmRing.create(self.ring_bytes)
            self._rings[peer] = (data_ring, ack_ring)
            entry = _ShmConn(ack_ring, data_ring, self.ack_flush)
            with self._reg:
                self._in[peer] = entry
            entry.start(self, f"shm:{peer}->{self.group}")

    def _colocated(self, peer: str) -> bool:
        # an unplaced pair defaults to co-located (single-host runs)
        return self.placement.get(peer) == self.placement.get(self.group)

    def _addr_payload(self):
        rings = {peer: (d.name, a.name)
                 for peer, (d, a) in self._rings.items()}
        return ("shmaddr", self.listener.address, rings)

    def _sock_addr(self, addr):
        if isinstance(addr, tuple) and addr and addr[0] == "shmaddr":
            return addr[1]
        return addr

    def _dial(self, peer: str, addr) -> Optional[BatchedConn]:
        if isinstance(addr, tuple) and addr and addr[0] == "shmaddr":
            names = addr[2].get(self.group)
            if names is not None:
                try:
                    data_ring = ShmRing.attach(names[0])
                    ack_ring = ShmRing.attach(names[1])
                except (FileNotFoundError, OSError):
                    return None   # receiver died; a fresh broadcast follows
                return _ShmConn(data_ring, ack_ring, self.ack_flush)
        return super()._dial(peer, addr)

    def _on_stop(self) -> None:
        with self._reg:
            rings = list(self._rings.values())
            self._rings = {}
        for d, a in rings:
            d.unlink()
            a.unlink()


class ShmSupervisor(SocketSupervisor):
    """``transport="shm"``: socket supervisor + ring reclamation.  The
    broker is payload-agnostic; the only extra duty is unlinking the ring
    segments named in a dead incarnation's address payload (its creator
    is gone and cannot) and sweeping all known rings at engine stop."""

    name = "shm"

    def __init__(self, driver):
        super().__init__(driver)
        sweep_stale_rings()

    @staticmethod
    def _ring_names(addr) -> list:
        if isinstance(addr, tuple) and addr and addr[0] == "shmaddr":
            return [n for names in addr[2].values() for n in names]
        return []

    def _reclaim_addr(self, group: str, addr) -> None:
        for name in self._ring_names(addr):
            unlink_ring(name)

    def request_stop(self):
        super().request_stop()
        d = self.driver
        with d.lock:
            names = [n for addr, _gen in self.addr.values()
                     for n in self._ring_names(addr)]
        for name in names:
            unlink_ring(name)


register_transport("shm", ShmSupervisor,
                   lambda bootstrap, group, conn: ShmWorker(
                       bootstrap, group, conn))
