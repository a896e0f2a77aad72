"""Batched binary wire format for worker-to-worker transports.

One **superframe** coalesces every event, ack, defer and release queued
for a peer into a single length-prefixed binary frame, written with one
vectored write (``os.writev``) per flusher wakeup — the per-event
``multiprocessing.connection`` object protocol (one pickle + one
``send()`` syscall per event, one more per ack) amortizes to a few
syscalls per *batch*.  Event payloads are pickled **once** at ``put()``
time (the same encode the log's ``put_event_blob`` op persists) and
carried here as buffer slices; the encoder never copies or re-pickles
them — reconnect-replay re-transmits the cached blob bytes verbatim.

Frame layout (little-endian)::

    u32 body_len                      # bytes after this word
    entry*                            # back to back until body_len

    event entry:
      u8  kind = 0
      u16 name_len                    # channel name (utf-8)
      i64 event_id
      u32 payload_len
      name bytes
      payload bytes                   # pickle((header, body))

    control entry (ack=1 / defer=2 / release=3):
      u8  kind
      u16 name_len
      i64 event_id
      name bytes

Channel identity rides as the channel *name* only: the receiver rebuilds
the :class:`~repro_torch.core.events.Event` routing fields from its own
channel spec, so the wire never carries pickled Event objects — just the
(header, body) payload blob both the transport and the log share.

The decoder is stateful (``feed`` accepts arbitrary byte chunks) and
yields fully-decoded entries: payloads are unpickled immediately from a
view over the receive buffer, so the buffer can compact without keeping
exported memoryviews alive.
"""
from __future__ import annotations

import os
import pickle
import struct
from typing import Any, Iterable, List, Tuple

EV = 0
ACK = 1
DEFER = 2
RELEASE = 3

_CTRL_KINDS = {"ack": ACK, "defer": DEFER, "release": RELEASE}
_CTRL_NAMES = {ACK: "ack", DEFER: "defer", RELEASE: "release"}

_EV_HDR = struct.Struct("<BHqI")      # kind, name_len, event_id, payload_len
_CTRL_HDR = struct.Struct("<BHq")     # kind, name_len, event_id
_LEN = struct.Struct("<I")

#: cap on buffers per writev call (POSIX guarantees IOV_MAX >= 16; linux
#: has 1024 — stay under it and loop)
_IOV_MAX = 512


def encode_payload(header: dict, body: Any) -> bytes:
    """The shared event-payload encode: what the transport ships and what
    ``put_event_blob`` persists (also ``MemoryLogStore._make_blob``'s
    eager format, so log reads decode it unchanged)."""
    return pickle.dumps((header, body))


def entry_size(entry: Tuple) -> int:
    """Encoded size of one wire entry (shm framing uses it to split
    batches into frames that fit the ring)."""
    if entry[0] == "ev":
        return _EV_HDR.size + len(entry[1].encode("utf-8")) + len(entry[3])
    return _CTRL_HDR.size + len(entry[1].encode("utf-8"))


def encode_superframe(entries: Iterable[Tuple]) -> Tuple[List, int, int, int]:
    """Encode entries into writev-ready buffers.

    ``entries`` are ``("ev", name, event_id, payload_bytes)`` or
    ``("ack"|"defer"|"release", name, event_id)``.  Returns
    ``(buffers, total_bytes, n_events, n_ctrl)`` — payload bytes appear
    in ``buffers`` as-is (zero copy); everything else accumulates into
    shared header chunks.
    """
    head = bytearray(_LEN.size)           # body_len patched at the end
    bufs: List = [head]
    cur = head
    n_ev = n_ctrl = 0
    total = _LEN.size
    for entry in entries:
        name = entry[1].encode("utf-8")
        if entry[0] == "ev":
            payload = entry[3]
            cur += _EV_HDR.pack(EV, len(name), entry[2], len(payload))
            cur += name
            total += _EV_HDR.size + len(name) + len(payload)
            bufs.append(payload)
            cur = bytearray()             # next header chunk after payload
            bufs.append(cur)
            n_ev += 1
        else:
            cur += _CTRL_HDR.pack(_CTRL_KINDS[entry[0]], len(name), entry[2])
            cur += name
            total += _CTRL_HDR.size + len(name)
            n_ctrl += 1
    if not bufs[-1]:
        bufs.pop()
    _LEN.pack_into(head, 0, total - _LEN.size)
    return bufs, total, n_ev, n_ctrl


def write_buffers(fd: int, bufs: List, total: int) -> None:
    """Vectored write of ``bufs`` to a blocking fd, handling partial
    writes and the IOV_MAX cap."""
    bufs = [b for b in bufs if len(b)]
    i = 0
    offset = 0                        # into bufs[i]
    remaining = total
    while remaining > 0:
        batch = bufs[i:i + _IOV_MAX]
        if offset:
            batch[0] = memoryview(batch[0])[offset:]
        n = os.writev(fd, batch)
        remaining -= n
        # advance (i, offset) past the n bytes written
        n += offset
        while i < len(bufs) and n >= len(bufs[i]):
            n -= len(bufs[i])
            i += 1
        offset = n


class SuperframeDecoder:
    """Incremental superframe decoder: ``feed`` arbitrary chunks, get
    back fully-decoded entries — ``("ev", name, event_id, header, body)``
    (payload already unpickled) or ``("ack"|"defer"|"release", name,
    event_id)``."""

    def __init__(self):
        self._buf = bytearray()

    def pending(self) -> int:
        return len(self._buf)

    def feed(self, data) -> List[Tuple]:
        self._buf += data
        out: List[Tuple] = []
        pos = 0
        buf = self._buf
        while True:
            if len(buf) - pos < _LEN.size:
                break
            (body_len,) = _LEN.unpack_from(buf, pos)
            if len(buf) - pos - _LEN.size < body_len:
                break
            view = memoryview(buf)
            try:
                self._decode_body(view, pos + _LEN.size, body_len, out)
            finally:
                view.release()        # else the compaction below raises
            pos += _LEN.size + body_len
        if pos:
            del self._buf[:pos]
        return out

    @staticmethod
    def _decode_body(view, pos: int, body_len: int, out: List[Tuple]):
        end = pos + body_len
        while pos < end:
            kind = view[pos]
            if kind == EV:
                _, name_len, event_id, payload_len = _EV_HDR.unpack_from(
                    view, pos)
                pos += _EV_HDR.size
                name = bytes(view[pos:pos + name_len]).decode("utf-8")
                pos += name_len
                header, body = pickle.loads(view[pos:pos + payload_len])
                pos += payload_len
                out.append(("ev", name, event_id, header, body))
            else:
                _, name_len, event_id = _CTRL_HDR.unpack_from(view, pos)
                pos += _CTRL_HDR.size
                name = bytes(view[pos:pos + name_len]).decode("utf-8")
                pos += name_len
                out.append((_CTRL_NAMES[kind], name, event_id))
