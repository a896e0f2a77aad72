"""Dynamic scaling (Sec. 7.2, Algorithms 12-13): Dispatcher + Merger +
Controller.

Scale-up: deploy replica (warm start), Merger state update, Dispatcher state
update — each acknowledged only after persisting the new state in STATE.

Scale-down: the Dispatcher (a) updates its state, (b) computes the set O of
"undone" events previously sent to the removed replica, (c) atomically
reassigns them (new destination + new event ids) together with storing its
state — mutually exclusive with the replica's generation transaction (which
marks InSets done with ``require_rows``), and (d) re-sends events of O that
are still undone. Then the Merger drops the input and topology is updated.

Counterpart of ``repro.core.scaling`` for thread and step mode, with one
fix: in step mode ``scale_down`` steps the removed replica and the merger
until the replica's channels are empty. ``repro.core.scaling`` waits for a
group thread that step mode does not have, times out after 5 s, and drops
the events left in those channels. Process mode is not ported:
``scale_up`` / ``scale_down`` on an engine in ``mode="process"`` raise
``NotImplementedError`` (the process-mode slice brings the paused-worker
path).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.core.engine import _later
from repro_torch.core.transport import Channel
from repro_torch.core.events import UNDONE, Event
from repro_torch.core.operator import Operator, OperatorRuntime


class DispatcherOperator(Operator):
    """Round-robin (optionally key-based) dispatch to replica output ports.

    Global state: the routing table (active replicas) + rr counter.
    Output ports are ``to_<replica_id>``.
    """
    input_ports = ("in",)

    def __init__(self, op_id: str, replicas: List[str],
                 key_fn: Optional[Callable[[Any], int]] = None,
                 *, processing_time: float = 0.0):
        self.routes = list(replicas)          # global state
        self.rr = 0                           # global state
        self.output_ports = tuple(f"to_{r}" for r in replicas)
        super().__init__(op_id, processing_time=processing_time)
        self.key_fn = key_fn
        self._queue: List[Tuple[str, Any]] = []

    def on_event(self, event: Event, *, recovery_inset=None) -> List[str]:
        inset = recovery_inset or self.runtime.new_inset_id()
        self._queue.append((inset, event.body))
        return [inset]

    def update_global(self, event: Event):
        pass    # rr advances at generation (persisted with the txn)

    def global_state(self):
        return {"routes": list(self.routes), "rr": self.rr}

    def restore_global(self, blob):
        if blob:
            self.routes = list(blob["routes"])
            self.rr = blob["rr"]
            self._sync_ports()

    def _sync_ports(self):
        self.output_ports = tuple(f"to_{r}" for r in self.routes)
        for p in self.output_ports:
            self.out_channels.setdefault(p, [])
            self.runtime.ctx.ssn.setdefault(p, 0)

    def triggers(self) -> List[str]:
        return [i for i, _ in self._queue]

    def generate(self, inset_id: str):
        body = dict(self._queue)[inset_id]
        if self.key_fn is not None:
            r = self.routes[self.key_fn(body) % len(self.routes)]
        else:
            r = self.routes[self.rr % len(self.routes)]
            self.rr += 1
        return [(f"to_{r}", body)], []

    def clear_inset(self, inset_id: str):
        self._queue = [(i, b) for i, b in self._queue if i != inset_id]


class MergerOperator(Operator):
    """Bundles replica streams into one output stream. Input ports are
    ``from_<replica_id>``; active inputs are global state."""
    output_ports = ("out",)

    def __init__(self, op_id: str, replicas: List[str],
                 *, processing_time: float = 0.0):
        self.inputs = list(replicas)          # global state
        self.input_ports = tuple(f"from_{r}" for r in replicas)
        super().__init__(op_id, processing_time=processing_time)
        self._queue: List[Tuple[str, Any]] = []

    def on_event(self, event: Event, *, recovery_inset=None) -> List[str]:
        inset = recovery_inset or self.runtime.new_inset_id()
        self._queue.append((inset, event.body))
        return [inset]

    def global_state(self):
        return {"inputs": list(self.inputs)}

    def restore_global(self, blob):
        if blob:
            self.inputs = list(blob["inputs"])
            self._sync_ports()

    def _sync_ports(self):
        self.input_ports = tuple(f"from_{r}" for r in self.inputs)
        ctx = self.runtime.ctx
        for p in self.input_ports:
            ctx.last_acked.setdefault(p, -1)
            ctx.global_updated.setdefault(p, -1)

    def triggers(self) -> List[str]:
        return [i for i, _ in self._queue]

    def generate(self, inset_id: str):
        return [("out", dict(self._queue)[inset_id])], []

    def clear_inset(self, inset_id: str):
        self._queue = [(i, b) for i, b in self._queue if i != inset_id]


class Controller:
    """Central scaling controller (the paper's Controller, Sec. 7.2).
    Load-monitoring strategies are out of scope (as in the paper) — tests and
    examples call scale_up/scale_down directly."""

    def __init__(self, engine, dispatcher_id: str, merger_id: str,
                 replica_factory: Callable[[str], Callable[[], Operator]],
                 replica_out_port: str = "out",
                 replica_in_port: str = "in", capacity: int = 256):
        self.e = engine
        self.disp_id = dispatcher_id
        self.merger_id = merger_id
        self.replica_factory = replica_factory
        self.rp_out, self.rp_in = replica_out_port, replica_in_port
        self.capacity = capacity
        self.lock = threading.Lock()

    def _reassign_undone(self, disp, rt, replica_id: str, send_fn):
        """Algorithm 13 steps 1.b-1.d against a dispatcher view (the live
        operator in thread mode, a STATE-restored copy in process mode).
        ``send_fn`` re-sends a still-undone reassigned event."""
        e = self.e
        # Step 1.b: set O = undone events sent to the replica + new ids
        keys = e.store.undone_events_from(self.disp_id, replica_id)
        assignments = []
        for key in keys:
            tgt = disp.routes[disp.rr % len(disp.routes)]
            disp.rr += 1
            new_port = f"to_{tgt}"
            new_id = rt.ctx.ssn.get(new_port, 0)
            rt.ctx.ssn[new_port] = new_id + 1
            assignments.append((key, new_port, tgt, self.rp_in, new_id))
        # Step 1.c: atomic reassignment + dispatcher state store. Mutual
        # exclusion with the replica's generation txn: events that turned
        # "done" in the meantime are skipped at apply time.
        txn = e.store.begin()
        for old_key, new_port, tgt, tport, new_id in assignments:
            txn.reassign_event(old_key, replica_id,
                               (self.disp_id, new_port, new_id), tgt, tport)
        txn.put_state(self.disp_id, rt.new_state_id(), rt._state_blob(),
                      keep_history=rt.keep_state_history)
        txn.commit()
        # Step 1.d: re-send events of O that are still undone (one indexed
        # scan, not a rescan per assignment)
        resend = {(ev.send_port, ev.event_id): ev
                  for ev, _st in e.store.fetch_resend_events(self.disp_id)}
        for old_key, new_port, tgt, tport, new_id in assignments:
            still_undone = any(
                status == UNDONE and ins is None
                for ins, status in e.store.event_status(
                    (self.disp_id, new_port, new_id)))
            ev = resend.get((new_port, new_id))
            if still_undone and ev is not None:
                send_fn(ev)

    def _drain_replica_channels(self, replica_id: str, timeout: float = 5.0):
        """Block until the dying replica's in/out channels are empty and it
        is not mid-transaction (its op_lock is free), so deleting its
        channels cannot lose a logged-and-sent output. Best effort: on
        timeout the topology update proceeds (the replica may be wedged)."""
        import time as _time
        e = self.e
        rt = e.runtimes.get(replica_id)
        deadline = _time.time() + timeout
        while _time.time() < deadline:
            chans = [ch for ch in e.channels
                     if ch.rec_op == replica_id or ch.send_op == replica_id]
            if rt is None:
                if all(len(c) == 0 for c in chans):
                    return
            else:
                with rt.op_lock:     # no handle_input/generate in flight
                    if all(len(c) == 0 for c in chans) \
                            and not rt._deferred:
                        return
            if e.mode == "step":
                # no group thread runs between steps: step the replica and
                # the merger here, or their channels never drain and the
                # topology update drops the events still in them
                for op_id in (replica_id, self.merger_id):
                    e._step_op(e.ops[op_id])
                    e.runtimes[op_id].drain_durable(force=True)
                continue
            _time.sleep(0.002)

    # -- Algorithm 12 -------------------------------------------------------
    def scale_up(self, replica_id: str):
        # compact first when due: the topology parties re-restore from the
        # log around the update, so the reads should hit the checkpoint
        # image plus a bounded tail, not the full pipeline history
        self.e.store.maybe_checkpoint()
        if self.e.mode == "process":
            raise _later("scale_up on a process-mode engine", "process-mode")
        with self.lock:
            e = self.e
            # Step 1: deploy replica + create the two connections (warm start)
            factory = self.replica_factory(replica_id)
            e.pipeline.factories[replica_id] = factory
            e.pipeline.groups[replica_id] = replica_id
            cap = 1_000_000 if e.mode == "step" else self.capacity
            e.pipeline.connections.append(
                (self.disp_id, f"to_{replica_id}", replica_id, self.rp_in, cap))
            e.pipeline.connections.append(
                (replica_id, self.rp_out, self.merger_id,
                 f"from_{replica_id}", cap))
            ch1 = Channel(self.disp_id, f"to_{replica_id}", replica_id,
                          self.rp_in, cap)
            ch2 = Channel(replica_id, self.rp_out, self.merger_id,
                          f"from_{replica_id}", cap)
            e.channels += [ch1, ch2]
            op = factory()
            e.ops[replica_id] = op
            e._wire(op)
            e.runtimes[replica_id] = OperatorRuntime(
                op, e.store, external=e.external, crash_point=e.injector,
                stop_flag=e._stop.is_set)
            e.group_state[replica_id] = "running"
            # Step 2: Merger state update (ack = state persisted) — under
            # its op_lock so the update serializes with its processing
            merger = e.ops[self.merger_id]
            with e.runtimes[self.merger_id].op_lock:
                merger.inputs.append(replica_id)
                merger._sync_ports()
                e._wire(merger)
                self._persist(merger)
            # Step 3: Dispatcher state update
            disp = e.ops[self.disp_id]
            with e.runtimes[self.disp_id].op_lock:
                disp.routes.append(replica_id)
                disp._sync_ports()
                e._wire(disp)
                self._persist(disp)
        if self.e.mode == "thread":
            self.e._start_group(replica_id, recover=False)

    # -- Algorithm 13 -------------------------------------------------------
    def scale_down(self, replica_id: str):
        self.e.store.maybe_checkpoint()
        if self.e.mode == "process":
            raise _later("scale_down on a process-mode engine",
                         "process-mode")
        with self.lock:
            e = self.e
            disp = e.ops[self.disp_id]
            rt = e.runtimes[self.disp_id]
            # Steps 1.a-1.d run under the dispatcher's op_lock: its state
            # update must be serialized with its own generation — without
            # this, a generate() that picked the dying replica before 1.a
            # can log its event AFTER the 1.b snapshot, stranding it in the
            # channel that step 3 deletes (a lost event).
            with rt.op_lock:
                # Step 1.a: dispatcher state update (remove route)
                if replica_id in disp.routes:
                    disp.routes.remove(replica_id)
                    disp._sync_ports()
                # Steps 1.b-1.d (shared with process mode)
                self._reassign_undone(disp, rt, replica_id, rt._send)
            # drain: the replica's channels must empty before the topology
            # update — step 3 deletes them, and an output the replica
            # already logged+sent but the merger has not yet consumed would
            # be lost with the buffer (nobody resends it: the replica is
            # being removed). The replica keeps running here: stale inputs
            # abort at assign-insets (their rows were reassigned) and ack.
            self._drain_replica_channels(replica_id)
            # Step 2: merger update
            merger = e.ops[self.merger_id]
            if replica_id in merger.inputs:
                merger.inputs.remove(replica_id)
                merger._sync_ports()
            self._persist(merger)
            # Step 3: update topology — delete connections + replica
            e.pipeline.connections = [
                c for c in e.pipeline.connections
                if c[0] != replica_id and c[2] != replica_id]
            e.channels = [c for c in e.channels
                          if c.send_op != replica_id and c.rec_op != replica_id]
            e.group_state[replica_id] = "removed"
            e.ops.pop(replica_id, None)
            e.pipeline.factories.pop(replica_id, None)
            e.pipeline.groups.pop(replica_id, None)
            e._wire(disp)
            e._wire(merger)

    def _persist(self, op: Operator):
        rt = self.e.runtimes[op.id]
        txn = self.e.store.begin()
        txn.put_state(op.id, rt.new_state_id(), rt._state_blob(),
                      keep_history=rt.keep_state_history)
        txn.commit()
