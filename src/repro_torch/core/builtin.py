"""Built-in operator library: sources, maps, windowed aggregators, writers,
sinks — the concrete operators used by the paper's three use cases (Sec. 9.2)
and the training data pipeline.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch.core.events import COMPLETE, DONE, INCOMPLETE, UNDONE, Event
from repro_torch.core.operator import Operator, OperatorRuntime, ReadSource


class ScratchStore:
    """Durable scratch storage for effects of non-replayable read actions
    (Alg 1 step 2.a). Survives operator restarts. ``backend`` makes the
    medium pluggable: a process-mode worker points it at the supervisor
    (ScratchClient) so scratch effects survive worker death too."""
    _global: Dict[Tuple, Any] = {}
    _lock = threading.Lock()
    backend: Any = None

    @classmethod
    def put(cls, key, value):
        if cls.backend is not None:
            return cls.backend.put(key, value)
        with cls._lock:
            cls._global[key] = value

    @classmethod
    def get(cls, key):
        if cls.backend is not None:
            return cls.backend.get(key)
        with cls._lock:
            return cls._global.get(key)

    @classmethod
    def drop(cls, key):
        if cls.backend is not None:
            return cls.backend.drop(key)
        with cls._lock:
            cls._global.pop(key, None)


# ---------------------------------------------------------------------------
# Source (Algorithm 1 + recovery Algorithm 6)
# ---------------------------------------------------------------------------

class GeneratorSource(Operator):
    """Source performing one read action against a ReadSource.

    * replayable source (paper's benchmark generator): Alg 1 step 3 —
      pipelined consumption, offset kept in the global state.
    * non-replayable: Alg 1 step 2 — effect stored first, then iterated.
    """
    input_ports: Tuple[str, ...] = ()
    output_ports = ("out",)

    def __init__(self, op_id: str, source: ReadSource, *, conn_id: str = "Cx",
                 rate: float = 0.0, desc: str = "read A",
                 processing_time: float = 0.0, rate_fn=None):
        super().__init__(op_id, processing_time=processing_time)
        self.source = source
        self.conn_id = conn_id
        self.rate = rate
        # optional shaped arrival process: a picklable callable
        # ``offset -> delay_seconds`` evaluated per emission (diurnal,
        # burst, ... synthetic traces for the adaptive controller) —
        # overrides the constant ``rate`` when set
        self.rate_fn = rate_fn
        self.desc = desc
        self.exhausted = False
        self._effect: Optional[List[Any]] = None

    # -- driver ------------------------------------------------------------
    def start_read(self):
        rt = self.runtime
        if self.source.replayable:
            # Alg 1 step 1 + 3: register action, consume pipelined
            txn = rt.store.begin()
            txn.put_read_action(self.id, self.conn_id, 0, INCOMPLETE,
                                self.desc)
            txn.commit()
            self._effect = self.source.effect(self.desc, 0)
        else:
            # Alg 1 steps 1-2: execute fully + store effect, mark complete
            txn = rt.store.begin()
            txn.put_read_action(self.id, self.conn_id, 0, INCOMPLETE,
                                self.desc)
            txn.commit()
            effect = self.source.effect(self.desc, 0)
            ScratchStore.put((self.id, 0), effect)
            rt.crash_point(self.id, "source_post_store")
            txn = rt.store.begin()
            txn.put_read_action(self.id, self.conn_id, 0, COMPLETE, self.desc)
            rev = Event(0, self.id, self.conn_id, self.id, None,
                        body=("ref", (self.id, 0)))
            txn.log_event(rev, UNDONE)
            txn.put_event_data(rev)
            txn.commit()
            self._effect = effect

    def step(self) -> bool:
        """Emit one output event. Returns False when exhausted."""
        rt = self.runtime
        if self._effect is None:
            self.start_read()
        off = rt.ctx.read_offset
        if off >= len(self._effect):
            if not self.exhausted:
                self._finish()
            return False
        delay = self.rate_fn(off) if self.rate_fn is not None else self.rate
        if delay > 0:
            time.sleep(delay)
        body = self._effect[off]
        rt.ctx.read_offset = off + 1
        rt.crash_point(self.id, "source_pre_log")
        self._emit("out", body, last=(off + 1 >= len(self._effect)))
        return True

    def pending_emits(self) -> int:
        """How much unemitted input the governor may batch over.  Rate-
        limited sources report 1 (each emission waits out its interval, so
        batching would distort the arrival process).  A shaped source
        (``rate_fn``) reports the length of the zero-delay *pack* behind
        the next arrival: those events land together, so batching them
        does not distort the arrival process."""
        if self._effect is None or self.rate > 0:
            return 1
        off = self.runtime.ctx.read_offset
        end = len(self._effect)
        if self.rate_fn is not None:
            if off >= end:
                return 0
            k = 1
            while off + k < end and k < 1024 \
                    and self.rate_fn(off + k) <= 0:
                k += 1
            return k
        return max(0, end - off)

    def step_run(self, max_n: int) -> int:
        """Emit up to ``max_n`` output events through ONE log transaction
        (one vectored ``log_events`` + one trailing state snapshot).
        Returns the number of bodies emitted (0 when exhausted).  A crash
        before the commit loses at most this run — the offset travels in
        the same transaction, so recovery regenerates exactly the
        uncommitted suffix."""
        rt = self.runtime
        if self._effect is None:
            self.start_read()
        off = rt.ctx.read_offset
        n = min(max_n, len(self._effect) - off)
        if self.rate_fn is not None and n >= 1:
            # shaped arrivals: wait out the pack boundary once, then emit
            # the zero-delay arrivals behind it as one run — never run
            # past the next nonzero delay (that is the next pack)
            k = 1
            while k < n and self.rate_fn(off + k) <= 0:
                k += 1
            n = k
            delay = self.rate_fn(off)
            if delay > 0:
                time.sleep(delay)
        elif n <= 1 or self.rate > 0:
            return 1 if self.step() else 0
        bodies = self._effect[off:off + n]
        rt.ctx.read_offset = off + n
        for _ in bodies:
            rt.crash_point(self.id, "source_pre_log")
        self._emit_run("out", bodies, last=(off + n >= len(self._effect)))
        return n

    def _emit(self, port: str, body, last: bool):
        rt = self.runtime
        ssn = rt.next_ssn(port)
        evs = [Event(ssn, self.id, port, ch.rec_op, ch.rec_port, body=body)
               for ch in self.out_channels.get(port, [])]
        txn = rt.store.begin()
        for e in evs:
            txn.log_event(e, UNDONE)
            txn.put_event_data(e)
        txn.put_state(self.id, rt.new_state_id(), rt._state_blob(),
                      keep_history=rt.keep_state_history)
        if last and not self.source.replayable:
            txn.set_status((self.id, self.conn_id, 0), DONE)
        txn.commit()
        rt.crash_point(self.id, "source_post_log")
        for e in evs:
            rt._send(e)
        rt.stats["events_out"] += len(evs)

    def _emit_run(self, port: str, bodies: List[Any], last: bool):
        rt = self.runtime
        chans = self.out_channels.get(port, [])
        evs: List[Event] = []
        for body in bodies:
            ssn = rt.next_ssn(port)
            evs.extend(Event(ssn, self.id, port, ch.rec_op, ch.rec_port,
                             body=body) for ch in chans)
        txn = rt.store.begin()
        if len(evs) == 1:
            txn.log_event(evs[0], UNDONE)
        elif evs:
            txn.log_events([(e, UNDONE, None) for e in evs])
        for e in evs:
            txn.put_event_data(e)
        txn.put_state(self.id, rt.new_state_id(), rt._state_blob(),
                      keep_history=rt.keep_state_history)
        if last and not self.source.replayable:
            txn.set_status((self.id, self.conn_id, 0), DONE)
        txn.commit()
        for _ in bodies:
            rt.crash_point(self.id, "source_post_log")
        for e in evs:
            rt._send(e)
        rt.stats["events_out"] += len(evs)

    def _finish(self):
        rt = self.runtime
        self.exhausted = True
        txn = rt.store.begin()
        if self.source.replayable:
            txn.set_read_action_status(self.id, self.conn_id, 0, COMPLETE)
        else:
            # Alg 1 step 2.d: GC the stored effect
            txn.delete_event_data((self.id, self.conn_id, 0))
            ScratchStore.drop((self.id, 0))
        txn.commit()

    # -- recovery (Algorithm 6 steps 2-4) ------------------------------------
    class _Driver:
        def resume(self, rt: OperatorRuntime):
            op: GeneratorSource = rt.op
            aid, ra = rt.store.get_read_action(op.id, op.conn_id)
            if ra is None:
                return      # never started — normal start will run
            if ra["status"] == COMPLETE and not op.source.replayable:
                statuses = rt.store.event_status((op.id, op.conn_id, 0))
                if any(s == DONE for _, s in statuses):
                    ScratchStore.drop((op.id, 0))    # Alg 6 step 3.a
                    op.exhausted = True
                    op._effect = []
                    return
                op._effect = ScratchStore.get((op.id, 0)) or []
            elif ra["status"] == INCOMPLETE and not op.source.replayable:
                ScratchStore.drop((op.id, 0))        # Alg 6 step 4.a: replay
                effect = op.source.effect(op.desc, 0)
                ScratchStore.put((op.id, 0), effect)
                txn = rt.store.begin()
                txn.put_read_action(op.id, op.conn_id, 0, COMPLETE, op.desc)
                rev = Event(0, op.id, op.conn_id, op.id, None,
                            body=("ref", (op.id, 0)))
                txn.log_event(rev, UNDONE)
                txn.put_event_data(rev)
                txn.commit()
                op._effect = effect
            else:
                # replayable (Alg 6 steps 3.b/4.b): replay from last offset
                op._effect = op.source.effect(op.desc, 0)
                if ra["status"] == COMPLETE:
                    op.exhausted = rt.ctx.read_offset >= len(op._effect)

    driver = _Driver()


# ---------------------------------------------------------------------------
# Middle operators
# ---------------------------------------------------------------------------

class MapOperator(Operator):
    """Stateless: one output event (or none) per input event (Sec. 2.3)."""
    def __init__(self, op_id: str, fn: Callable[[Any], Any] = lambda b: b,
                 *, processing_time: float = 0.0, out_port: str = "out",
                 deterministic: bool = True):
        super().__init__(op_id, processing_time=processing_time)
        self.fn = fn
        self.out_port = out_port
        self.deterministic = deterministic
        self._queue: List[Tuple[str, Any]] = []   # (inset_id, body)

    def on_event(self, event: Event, *, recovery_inset=None) -> List[str]:
        inset = recovery_inset or self.runtime.new_inset_id()
        self._queue.append((inset, event.body))
        return [inset]

    def triggers(self) -> List[str]:
        out = [i for i, _ in self._queue]
        return out

    def generate(self, inset_id: str):
        body = dict(self._queue)[inset_id]
        res = self.fn(body)
        return ([(self.out_port, res)] if res is not None else []), []

    def clear_inset(self, inset_id: str):
        self._queue = [(i, b) for i, b in self._queue if i != inset_id]


class CountWindowOperator(Operator):
    """Stateful: accumulate ``window`` input events, then generate one output
    event via ``agg`` (the paper's OP2/Example 3 pattern). The event count is
    the *global state*; the accumulated bodies are the *event state*."""

    def __init__(self, op_id: str, window: int,
                 agg: Callable[[List[Any]], Any] = lambda bs: bs,
                 *, processing_time: float = 0.0,
                 writes_per_output: int = 0, conn_id: str = "ext",
                 emit_output: bool = True):
        super().__init__(op_id, processing_time=processing_time)
        self.window = window
        self.agg = agg
        self.writes_per_output = writes_per_output
        self.conn_id = conn_id
        self.emit_output = emit_output
        self.count = 0                       # global state
        self.insets: Dict[str, List[Any]] = {}   # event state

    # global state = total events received (drives InSet assignment)
    def update_global(self, event: Event):
        self.count += 1

    def global_state(self):
        return {"count": self.count}

    def restore_global(self, blob):
        if blob:
            self.count = blob["count"]

    def _inset_for(self, n: int) -> str:
        return f"{self.id}:w{(n - 1) // self.window}"

    def on_event(self, event: Event, *, recovery_inset=None) -> List[str]:
        inset = recovery_inset or self._inset_for(self.count)
        self.insets.setdefault(inset, []).append(event.body)
        return [inset]

    def triggers(self) -> List[str]:
        return [i for i, bodies in self.insets.items()
                if len(bodies) >= self.window]

    def generate(self, inset_id: str):
        bodies = self.insets.get(inset_id, [])
        out_body = self.agg(bodies)
        outputs = [("out", out_body)] if self.emit_output else []
        writes = [(self.conn_id, {"inset": inset_id, "result": out_body})
                  for _ in range(self.writes_per_output)]
        return outputs, writes

    def clear_inset(self, inset_id: str):
        self.insets.pop(inset_id, None)


class SyncJoinOperator(Operator):
    """Two synchronized input ports: trigger when n1 events from in1 AND n2
    from in2 have arrived (UC2's OP4; exercises ABS alignment)."""
    input_ports = ("in1", "in2")
    output_ports = ("out",)

    def __init__(self, op_id: str, n1: int, n2: int,
                 agg: Callable[[List, List], Any] = lambda a, b: (len(a), len(b)),
                 *, processing_time: float = 0.0, writes_per_output: int = 0,
                 conn_id: str = "ext"):
        super().__init__(op_id, processing_time=processing_time)
        self.n1, self.n2 = n1, n2
        self.agg = agg
        self.writes_per_output = writes_per_output
        self.conn_id = conn_id
        self.counts = {"in1": 0, "in2": 0}   # global state
        self.windows: Dict[str, Dict[str, List]] = {}

    def update_global(self, event: Event):
        self.counts[event.rec_port] += 1

    def global_state(self):
        return dict(self.counts)

    def restore_global(self, blob):
        if blob:
            self.counts.update(blob)

    def _inset_for(self, port: str) -> str:
        n = {"in1": self.n1, "in2": self.n2}[port]
        return f"{self.id}:j{(self.counts[port] - 1) // n}"

    def on_event(self, event: Event, *, recovery_inset=None) -> List[str]:
        inset = recovery_inset or self._inset_for(event.rec_port)
        w = self.windows.setdefault(inset, {"in1": [], "in2": []})
        w[event.rec_port].append(event.body)
        return [inset]

    def triggers(self) -> List[str]:
        return [i for i, w in self.windows.items()
                if len(w["in1"]) >= self.n1 and len(w["in2"]) >= self.n2]

    def generate(self, inset_id: str):
        w = self.windows[inset_id]
        body = self.agg(w["in1"], w["in2"])
        writes = [(self.conn_id, {"inset": inset_id, "result": body})
                  for _ in range(self.writes_per_output)]
        return [("out", body)], writes

    def clear_inset(self, inset_id: str):
        self.windows.pop(inset_id, None)


class TerminalSink(Operator):
    """Sink that signals completion after ``target`` events. Each received
    body is durably recorded as a *write action* on the external system
    (checkable ⇒ exactly-once), so ``external.committed()`` is the ground
    truth for correctness assertions (the paper's 'destination' notion)."""
    output_ports: Tuple[str, ...] = ()

    def __init__(self, op_id: str, target: int,
                 on_done: Optional[Callable[[], None]] = None,
                 *, processing_time: float = 0.0, record: bool = True,
                 conn_id: str = "sink"):
        super().__init__(op_id, processing_time=processing_time)
        self.target = target
        self.on_done = on_done
        self.record = record
        self.conn_id = conn_id
        self.received: List[Any] = []       # volatile convenience view
        self._pending: Dict[str, Any] = {}
        self.seen = 0                       # global state

    def update_global(self, event: Event):
        self.seen += 1

    def global_state(self):
        return {"seen": self.seen}

    def restore_global(self, blob):
        if blob:
            self.seen = blob["seen"]

    def on_event(self, event: Event, *, recovery_inset=None) -> List[str]:
        inset = recovery_inset or self.runtime.new_inset_id()
        self._pending[inset] = event.body
        self.received.append(event.body)
        return [inset]

    def triggers(self) -> List[str]:
        return list(self._pending)

    def generate(self, inset_id: str):
        body = self._pending[inset_id]
        writes = [(self.conn_id, body)] if self.record else []
        if self.seen >= self.target and self.on_done is not None:
            self.on_done()
        return [], writes

    def clear_inset(self, inset_id: str):
        self._pending.pop(inset_id, None)
