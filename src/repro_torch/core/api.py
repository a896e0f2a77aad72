"""The LOG.io Protocol API exactly as published (Sec. 6.2, Tables 7-9).

The framework-internal runtime (`OperatorRuntime`) drives the protocol for
the built-in generic operators; this facade exposes the paper's named
methods for authors porting custom SAP-DI-style operators verbatim
(Listings 1-3). Each method delegates to the runtime/store primitives.
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

from repro_torch.core.events import (COMPLETE, DONE, INCOMPLETE, UNDONE, Event)
from repro_torch.core.operator import OperatorRuntime


class LogioTransaction:
    """Table 8 — the LOG.io transaction interface."""

    def __init__(self, api: "LogioAPI"):
        self.api = api
        self._txn = api.rt.store.begin()

    def LogSourceEvent(self, eventInfo: Event, eventData: Any = None):
        if eventData is not None:
            eventInfo.body = eventData
        self._txn.log_event(eventInfo, UNDONE)
        self._txn.put_event_data(eventInfo)

    def LogOutputEvents(self, eventInfo: Sequence[Event],
                        eventData: Optional[Sequence[Any]] = None,
                        inSetID: Optional[str] = None):
        for i, ev in enumerate(eventInfo):
            if eventData is not None:
                ev.body = eventData[i]
            self._txn.log_event(ev, UNDONE)
            self._txn.put_event_data(ev)
        if inSetID is not None:
            self._txn.set_inset_status(self.api.rt.op.id, inSetID, DONE,
                                       require_rows=True)

    def DoneEvent(self, eventInfo: Event):
        self._txn.set_status((eventInfo.send_op, eventInfo.send_port,
                              eventInfo.event_id), DONE)

    def StoreState(self, stateInfo: int, state: bytes):
        self._txn.put_state(self.api.rt.op.id, stateInfo, state,
                            keep_history=self.api.rt.keep_state_history)

    def Commit(self):
        self._txn.commit()


class LogioAPI:
    """Tables 7 and 9 — interface + recovery methods."""

    def __init__(self, runtime: OperatorRuntime):
        self.rt = runtime

    # ---- Table 7: interface methods ---------------------------------
    def GetActionID(self, actionInit=None) -> int:
        self.rt.ctx.inset_counter += 1          # shared id namespace
        return self.rt.ctx.inset_counter

    def GetStateID(self, procInfo=None) -> int:
        return self.rt.new_state_id()

    def GetInSetID(self) -> str:
        return self.rt.new_inset_id()

    def GetEventID(self, port: str) -> int:
        return self.rt.next_ssn(port)

    def BeginTransaction(self) -> LogioTransaction:
        return LogioTransaction(self)

    def InitializeReadAction(self, actionInfo, stateID=None, state=None):
        action_id, conn_id, desc = actionInfo
        txn = self.rt.store.begin()
        txn.put_read_action(self.rt.op.id, conn_id, action_id, INCOMPLETE,
                            desc)
        if state is not None:
            txn.put_state(self.rt.op.id, stateID or self.GetStateID(), state)
        txn.commit()

    def CompleteReadAction(self, actionInfo, actionData=None):
        action_id, conn_id, desc = actionInfo
        txn = self.rt.store.begin()
        txn.put_read_action(self.rt.op.id, conn_id, action_id, COMPLETE, desc)
        ev = Event(action_id, self.rt.op.id, conn_id, self.rt.op.id, None,
                   body=actionData)
        txn.log_event(ev, UNDONE)
        txn.put_event_data(ev)
        txn.commit()

    def DropReadAction(self, actionInfo):
        action_id, conn_id, _desc = actionInfo
        txn = self.rt.store.begin()
        txn.delete_event_data((self.rt.op.id, conn_id, action_id))
        txn.commit()

    def LogStateEvent(self, stateInfo: int, inSetID: str):
        txn = self.rt.store.begin()
        ev = Event(stateInfo, self.rt.op.id, None, None, None)
        txn.log_event(ev, UNDONE, inset_id=inSetID)
        txn.commit()

    def UpdateContext(self, eventInfo: Event):
        port = eventInfo.rec_port
        self.rt.ctx.global_updated[port] = max(
            self.rt.ctx.global_updated.get(port, -1), eventInfo.event_id)

    def GetWriteActions(self, procInfo=None) -> List[Event]:
        return self.rt.store.get_write_actions(self.rt.op.id)

    def CheckEvent(self, eventInfo: Event) -> bool:
        """True iff the input event is NOT obsolete (Alg 2 step 1)."""
        return not self.rt._obsolete(eventInfo.rec_port, eventInfo)

    def AssignInSets(self, inSetIDs: Sequence[str], eventInfo: Event):
        txn = self.rt.store.begin()
        txn.assign_insets((eventInfo.send_op, eventInfo.send_port,
                           eventInfo.event_id), list(inSetIDs),
                          rec_op=self.rt.op.id)
        txn.commit()

    # ---- Table 9: recovery methods -----------------------------------
    def FetchAckEvents(self, procInfo=None):
        return self.rt.store.fetch_ack_events(self.rt.op.id)

    def FetchResendEvents(self, procInfo=None):
        return [e for e, _ in self.rt.store.fetch_resend_events(self.rt.op.id)]

    def GetProcState(self, procInfo=None) -> Optional[bytes]:
        return self.rt.store.get_state(self.rt.op.id)

    def InitializeContext(self, procInfo=None):
        self.rt.restore_state()
