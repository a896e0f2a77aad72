"""Event model: batches of records exchanged between operators (Sec. 2.1).

Each event is identified by a System-generated Sequential Number (SSN),
unique per (sender operator, output port). Write/read actions are modelled as
events with a null sender/receiver port respectively (Sec. 3.3 / 3.5.3).
"""
from __future__ import annotations

import dataclasses
import pickle
from typing import Any, Dict, Optional

UNDONE = "undone"
DONE = "done"
REPLAY = "replay"

COMPLETE = "complete"
INCOMPLETE = "incomplete"


@dataclasses.dataclass
class Event:
    event_id: int
    send_op: str
    send_port: Optional[str]          # None => write action (Sec. 3.5.3)
    rec_op: Optional[str]
    rec_port: Optional[str]           # None => read action event (Sec. 3.3)
    body: Any = None
    header: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def is_replay(self) -> bool:
        return bool(self.header.get("replay"))

    def key(self):
        return (self.send_op, self.send_port, self.event_id)

    def clone_for(self, rec_op: str, rec_port: str) -> "Event":
        return dataclasses.replace(self, rec_op=rec_op, rec_port=rec_port,
                                   header=dict(self.header))

    # -- shared payload encode (zero-copy transports + log) ----------------
    def cache_blob(self) -> bytes:
        """``pickle((header, body))`` computed at most once per event: the
        byte-transport wire payload *and* the log's ``put_event_blob``
        payload, so the hot path serializes each event exactly once.  The
        cache must only be taken after the header is final (the replay
        flag is set before logging/sending)."""
        blob = self.__dict__.get("_blob")
        if blob is None:
            blob = pickle.dumps((self.header, self.body))
            self.__dict__["_blob"] = blob
        return blob

    def cached_blob(self):
        return self.__dict__.get("_blob")

    # the cache is derived, process-local state: never pickle it (routed
    # frames and store RPC would double-ship every payload)
    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_blob", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)


@dataclasses.dataclass
class ReadAction:
    action_id: int
    op_id: str
    conn_id: str
    desc: str
    replayable: bool = True


@dataclasses.dataclass
class WriteAction:
    """A pending write action = an output event whose send_port is None and
    whose rec_port is the connection id of the external system."""
    event_id: int
    op_id: str
    conn_id: str
    body: Any
