"""Process-per-group execution mode (``Engine(mode="process")``).

Each operator group runs in its own OS process — a real pod, not a
thread — so crash = ``kill -9`` is a first-class scenario: a SIGKILL'd
worker takes its volatile operator state with it and the supervisor
warm-restarts only that group while every other worker keeps processing
(the paper's non-blocking recovery property, across actual process
boundaries).

Topology (transport-dependent; see :mod:`repro_torch.core.transport`)::

    parent (supervisor)                      worker (one per group)
    ───────────────────                      ──────────────────────
    SupervisorTransport     ◄─ tr conn ──►   WorkerTransport
      routed: authoritative Channels           routed: replicas + credits
      socket/tcp: address broker + probes      socket/tcp: sender-held
                                                buffers, direct
                                                worker↔worker sockets
    LogBackend (the one     ◄─── RPC ─────►  StoreClient / ExternalClient /
    sqlite-family store),                    InjectorClient / ScratchClient
    ExternalSystem,
    FailureInjector,
    supervisor + router threads              protocol loop (+ socket threads)
    _ControlHub (cluster    ◄─ dial-back ──  node-agent workers connect
    mode: TCP rendezvous)                    their rpc/tr conns here

* **Worker bootstrap** — a worker never inherits the live engine object.
  It starts from a picklable
  :class:`~repro_torch.core.transport.base.WorkerBootstrap` payload (pipeline
  spec, group assignment, transport config, incarnation) and rebuilds its
  operators purely from the payload + the log, so
  ``Engine(mode="process", ctx="spawn")`` works — and so a worker can in
  principle be launched by an ``ssh``/container entrypoint on another
  machine.  Under ``ctx="fork"`` the payload crosses by inheritance (no
  pickling), so factories may stay closures; under ``ctx="spawn"`` (and
  on node agents, which always spawn) they must be picklable.
* **Placement** — :class:`~repro_torch.core.transport.base.Placement` maps each
  group to a node.  ``None`` spawns a direct child; a node name routes
  the bootstrap to that node's agent (see :mod:`repro_torch.core.cluster`),
  and the worker dials its RPC + transport connections back to the
  supervisor's :class:`_ControlHub` (authkey-authenticated TCP).
* **Transport** — behind the formal interface in
  :mod:`repro_torch.core.transport.base`.  ``routed`` keeps every authoritative
  buffer in the supervisor and pumps deliveries over the tr conn;
  ``socket``/``tcp`` move the reliable buffer to the sender-side worker
  and events bypass the supervisor entirely.  All enforce credit-based
  back-pressure at the channel capacity and preserve per-port FIFO + ack
  + durability-watermark semantics exactly as in thread mode.
* **Log store** — all workers share the parent's single store through a
  synchronous RPC proxy (:class:`StoreClient`).  Transaction ops are plain
  tuples, so they cross the conn verbatim; ``TxnAborted`` stays
  synchronous.  Group-commit batching, the durability watermark and the
  global flush-epoch 2PC all run in the parent, shared by every worker.
* **Failure injection** — crash points RPC to the parent's injector (its
  plan must outlive worker restarts); a firing plan entry answers
  ``("crash",)`` and the worker SIGKILLs itself: every injected failure in
  process mode is a genuine ``kill -9``, not an exception.
* **Done detection** — delegated to the transport: the routed supervisor
  cross-checks worker idle reports against its own delivery counters; the
  socket supervisor runs a two-wave activity probe (no central counters
  exist by design).

Counterpart of ``repro.core.procmode`` with one fix: the warm restart after
a worker's death yields to a deliberate stop or restart of its group that
ran meanwhile (a recovery-mode switch, scaling). ``repro.core.procmode``
spawns a second worker of the group there and orphans the first, which
can lose events and outlives ``Engine.stop()``.
"""
from __future__ import annotations

import multiprocessing
import os
import signal
import threading
import time
from multiprocessing import AuthenticationError
from multiprocessing import connection as mpc
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.batching import make_governor
from repro_torch.core.builtin import GeneratorSource, ScratchStore
from repro_torch.core.logstore.base import LogBackend, TxnAborted
from repro_torch.core.operator import OperatorRuntime, SimulatedCrash
from repro_torch.core.recovery import recover_operator
from repro_torch.core.transport.base import (WorkerBootstrap,
                                       make_supervisor_transport,
                                       make_worker_transport)

# a group is declared failed (and the run aborted) after this many total
# restarts — a CI hygiene bound against unbounded crash loops, far above
# any finite failure-injection plan; not a protocol constant
MAX_RESTARTS_PER_GROUP = 50

# a node-agent spawn (request -> spawned ack -> rpc/tr dial-back) must
# complete within this budget or the run is declared failed
SPAWN_TIMEOUT = 30.0


# ---------------------------------------------------------------------------
# Worker-side proxies (everything here runs in the worker process)
# ---------------------------------------------------------------------------

class _Rpc:
    """Synchronous request/response over the worker's RPC conn. The worker
    runs one protocol thread, so one outstanding request at a time by
    design (socket reader threads never touch the store)."""

    def __init__(self, conn):
        self.conn = conn

    def call(self, *msg):
        self.conn.send(msg)
        reply = self.conn.recv()
        kind = reply[0]
        if kind == "ok":
            return reply[1]
        if kind == "abort":
            raise TxnAborted(reply[1])
        if kind == "crash":
            # an injector plan entry fired: die like a real pod — SIGKILL,
            # no cleanup, no exception propagation
            os.kill(os.getpid(), signal.SIGKILL)
        raise RuntimeError(f"store RPC failed: {reply[1]}")


class StoreClient(LogBackend):
    """LogBackend proxy: forwards commits and recovery/lineage/scaling
    queries to the parent's shared store."""

    def __init__(self, rpc: _Rpc):
        self.rpc = rpc

    def _commit(self, ops):
        return self.rpc.call("txn", ops)

    def _q(self, name, *args):
        return self.rpc.call("store", name, args)

    def is_durable(self, token) -> bool:
        if token is None:
            return True
        return self._q("is_durable", token)

    def flush(self):
        self._q("flush")

    def maybe_flush(self):
        self._q("maybe_flush")

    def maybe_checkpoint(self):
        """No-op on the worker side: checkpoint cadence is driven by the
        parent's supervision loop against the real store — polling the
        watermark over RPC from every worker would be pure overhead."""

    def checkpoint(self):
        self._q("checkpoint")

    # -- recovery / scaling / lineage queries ------------------------------
    def fetch_resend_events(self, op_id):
        return self._q("fetch_resend_events", op_id)

    def fetch_ack_events(self, op_id, include_done=False):
        return self._q("fetch_ack_events", op_id, include_done)

    def fetch_replay_outputs(self, op_id):
        return self._q("fetch_replay_outputs", op_id)

    def undone_outputs_after(self, op_id, port, min_id):
        return self._q("undone_outputs_after", op_id, port, min_id)

    def get_write_actions(self, op_id):
        return self._q("get_write_actions", op_id)

    def get_state(self, op_id):
        return self._q("get_state", op_id)

    def last_sent_ssn(self, op_id):
        return self._q("last_sent_ssn", op_id)

    def last_acked(self, op_id):
        return self._q("last_acked", op_id)

    def event_status(self, key, rec_op=None):
        return self._q("event_status", key, rec_op)

    def get_read_action(self, op_id, conn_id):
        return self._q("get_read_action", op_id, conn_id)

    def undone_events_from(self, send_op, rec_op):
        return self._q("undone_events_from", send_op, rec_op)

    def lineage_insets_of(self, event_key):
        return self._q("lineage_insets_of", event_key)

    def lineage_events_of_inset(self, rec_op, inset_id):
        return self._q("lineage_events_of_inset", rec_op, inset_id)

    def lineage_outputs_of_inset(self, send_op, inset_id):
        return self._q("lineage_outputs_of_inset", send_op, inset_id)

    def insets_of_event(self, event_key, rec_op):
        return self._q("insets_of_event", event_key, rec_op)

    def consumers_of(self, event_key):
        return self._q("consumers_of", event_key)

    def gc(self, lineage_ops=()):
        return self._q("gc", tuple(lineage_ops))


class ExternalClient:
    """ExternalSystem proxy: write actions must land in the parent's
    durable external system (the ground truth for exactly-once)."""

    def __init__(self, rpc: _Rpc):
        self.rpc = rpc

    def execute(self, op_id, conn_id, event_id, body) -> bool:
        return self.rpc.call("ext", "execute", (op_id, conn_id, event_id,
                                                body))

    def status(self, op_id, conn_id, event_id) -> str:
        return self.rpc.call("ext", "status", (op_id, conn_id, event_id))


class ScratchClient:
    """ScratchStore backend proxy: effects of non-replayable read actions
    must survive worker restarts, so they live in the parent."""

    def __init__(self, rpc: _Rpc):
        self.rpc = rpc

    def put(self, key, value):
        self.rpc.call("scratch", "put", (key, value))

    def get(self, key):
        return self.rpc.call("scratch", "get", (key,))

    def drop(self, key):
        self.rpc.call("scratch", "drop", (key,))


class InjectorClient:
    """crash_point proxy. The injector's plan lives in the parent (it must
    survive worker restarts); a firing entry kills this worker with
    SIGKILL — real process death, not an exception."""

    def __init__(self, rpc: _Rpc):
        self.rpc = rpc

    def __call__(self, op_id: str, point: str):
        self.rpc.call("inj", op_id, point)


def _worker_main(bootstrap: WorkerBootstrap, rpc_conn, tr_conn):
    """The worker: rebuild the group's operators from the bootstrap
    payload against proxy store/external/channels, recover from the log
    if asked, then run the thread-mode group loop with deliveries
    arriving over the transport.  Nothing here reads parent memory."""
    group = bootstrap.group
    recover = bootstrap.recover
    rpc = _Rpc(rpc_conn)
    store = StoreClient(rpc)
    external = ExternalClient(rpc)
    injector = InjectorClient(rpc)
    ScratchStore.backend = ScratchClient(rpc)

    wt = make_worker_transport(bootstrap.transport, bootstrap, group,
                               tr_conn)
    group_ops = bootstrap.group_ops()
    channels = wt.channels
    ops, runtimes = {}, {}
    for op_id in group_ops:
        op = bootstrap.factories[op_id]()
        op.state = "restarted" if recover else "running"
        op.in_channels = {}
        op.out_channels = {p: [] for p in op.output_ports}
        for ch in channels.values():
            if ch.rec_op == op_id:
                op.in_channels[ch.rec_port] = ch
            if ch.send_op == op_id:
                op.out_channels.setdefault(ch.send_port, []).append(ch)
        lin_in, lin_out = bootstrap.lineage_ports.get(op_id, (set(), set()))
        ops[op_id] = op
        rec_info = bootstrap.recovery or {}
        group_mode = rec_info.get("modes", {}).get(group, "log")
        runtimes[op_id] = OperatorRuntime(
            op, store, lineage_in=lin_in, lineage_out=lin_out,
            external=external, crash_point=injector,
            stop_flag=lambda: wt.stopped,
            replay_mode=op_id in bootstrap.replay_ops,
            keep_state_history=bool(lin_out),
            state_interval=(rec_info.get("interval", 16)
                            if group_mode == "epoch" else 1))
        runtimes[op_id].governor = make_governor(bootstrap.batching)

    if recover:
        rec_info = bootstrap.recovery or {}
        # epoch groups (and groups freshly switched off epoch, marked
        # stale) recover from a possibly-interval-stale snapshot: include
        # DONE rows so completed inputs' global contributions replay
        include_done = (rec_info.get("modes", {}).get(group) == "epoch"
                        or group in rec_info.get("stale", ()))
        for op_id in group_ops:
            op = ops[op_id]
            is_source = isinstance(op, GeneratorSource)
            replay_pred_ports = {dp for s, sp, d, dp, _ in
                                 bootstrap.connections
                                 if d == op_id and s in bootstrap.replay_ops}
            recover_operator(runtimes[op_id], is_source=is_source,
                             source_driver=GeneratorSource.driver
                             if is_source else None,
                             replay_pred_ports=replay_pred_ports,
                             include_done=include_done)

    sources = [op for op in ops.values() if isinstance(op, GeneratorSource)]
    last_stats = 0.0

    def step_op(op) -> bool:
        rt = runtimes[op.id]
        gov = rt.governor
        if isinstance(op, GeneratorSource):
            if gov is not None:
                n = gov.limit(op.pending_emits())
                if n > 1:
                    t0 = time.monotonic()
                    k = op.step_run(n)
                    gov.observe(k, time.monotonic() - t0)
                    return k > 0
            return op.step()
        progressed = False
        for port in op.input_ports:
            ch = op.in_channels.get(port)
            if ch is None:
                continue
            if gov is not None:
                # governed run draining: apply already-delivered backlog
                # through one vectored pass (see docs/batching.md)
                n = gov.limit(ch.unprocessed())
                if n > 1:
                    evs = ch.peek_run(n)
                    if evs:
                        t0 = time.monotonic()
                        k = rt.handle_inputs(port, evs)
                        gov.observe(k, time.monotonic() - t0)
                        progressed = progressed or k > 0
                    continue
            ev = ch.peek()
            if ev is not None:
                rt.handle_input(port, ev)
                progressed = True
        return progressed

    def send_stats():
        out = {}
        for o in group_ops:
            c = dict(runtimes[o].stats)
            gov = runtimes[o].governor
            if gov is not None:
                gs = gov.stats()
                c["gov_runs"] = gs["runs"]
                c["gov_events"] = gs["events"]
                c["gov_max_run"] = gs["max_run"]
            # "g_"-prefixed keys are live gauges of THIS incarnation: the
            # supervisor keeps them out of the cumulative fold
            c["g_queue_depth"] = sum(ch.unprocessed()
                                     for ch in ops[o].in_channels.values())
            out[o] = c
        wt.send_stats(out)

    while True:
        wt.pump(0)
        if wt.stopped:
            # final snapshot — short-lived runs would otherwise stop inside
            # the 0.05s throttle window with counters never reported
            send_stats()
            return

        wt.begin_step()
        progressed = False
        for op_id in group_ops:
            progressed |= step_op(ops[op_id])
            progressed |= runtimes[op_id].drain_durable()
        if not progressed and wt.take_force():
            # end of stream (per the supervisor): push the durability
            # watermark so held acks/external writes release
            for op_id in group_ops:
                progressed |= runtimes[op_id].drain_durable(force=True)

        state = {
            "exhausted": all(s.exhausted for s in sources),
            "deferred": sum(len(runtimes[o]._deferred) for o in group_ops),
            "pending": any(ops[o].has_pending() for o in group_ops),
        }
        now = time.time()
        if progressed:
            wt.boundary(state)
            if now - last_stats >= 0.05:
                send_stats()
                last_stats = now
            continue
        if now - last_stats >= 0.05:
            send_stats()
            last_stats = now
        wt.report_idle(state)
        wt.pump(0.005)


def _dial_control(bootstrap: WorkerBootstrap, kind: str):
    """Connect one channel (``"rpc"``/``"tr"``) back to the supervisor's
    control hub — how a node-agent worker, started from nothing but the
    bootstrap payload, reaches its supervisor."""
    addr, authkey = bootstrap.control
    conn = mpc.Client(addr, authkey=authkey)
    conn.send(("worker", kind, bootstrap.group, bootstrap.incarnation))
    return conn


def _worker_entry(bootstrap: WorkerBootstrap, rpc_conn=None, tr_conn=None):
    try:
        if rpc_conn is None:
            rpc_conn = _dial_control(bootstrap, "rpc")
            tr_conn = _dial_control(bootstrap, "tr")
        _worker_main(bootstrap, rpc_conn, tr_conn)
    except (EOFError, BrokenPipeError, OSError, AuthenticationError):
        pass                       # parent stopped / conn torn down
    finally:
        # skip interpreter teardown: under fork the child inherited parent
        # resources (sqlite connections, thread locks) that must not be
        # finalized here; under spawn there is simply nothing to flush
        os._exit(0)


# ---------------------------------------------------------------------------
# Parent side
# ---------------------------------------------------------------------------

class _WorkerHandle:
    def __init__(self, group: str):
        self.group = group
        self.proc: Optional[Any] = None    # mp.Process or _RemoteProc
        self.node: Optional[str] = None    # placement of this incarnation
        self.rpc_conn = None
        self.tr_conn = None
        self.rpc_thread: Optional[threading.Thread] = None
        self.tr_thread: Optional[threading.Thread] = None
        self.send_lock = threading.Lock()
        # serializes delivery pumping toward this worker: held for a whole
        # pump loop, and by the restart path while it rewinds cursors, so a
        # stale pump can never interleave with a fresh incarnation
        self.pump_lock = threading.Lock()
        self.sent = 0                  # "ev" deliveries to this incarnation
        self.last_idle: Optional[dict] = None
        self.probe: Optional[Any] = None   # (round, snapshot) — socket
        self.alive = False
        self.stopping = False
        self.restarts = 0              # total for this group (never reset)
        self.incarnation = 0           # bumped on every (re)spawn
        self.spawn_token = 0           # bumped before each spawn attempt:
        # the bootstrap/dial-back rendezvous id (the incarnation itself is
        # only bumped once the worker's conns are attached, in the same
        # critical section as the credit-window computation)

    def send(self, msg, incarnation: Optional[int] = None) -> bool:
        """Send to the worker. ``incarnation`` pins the message to the
        incarnation it was computed against: a credit grant derived from
        a buffer pop must not land on a fresh incarnation whose initial
        window already accounts for that pop (double grant)."""
        with self.send_lock:
            if not self.alive:
                return False
            if incarnation is not None and incarnation != self.incarnation:
                return False
            try:
                self.tr_conn.send(msg)
                return True
            except (BrokenPipeError, OSError):
                return False


class _RemoteProc:
    """Process-like handle for a worker launched via a node agent: pid and
    liveness come from agent reports over the control hub, and kill is
    routed through the agent (the supervisor cannot signal a pid on
    another host).  A dead node (agent conn EOF) makes every worker on it
    report dead — genuine whole-node failure semantics."""

    def __init__(self, node: "_NodeHandle", group: str, token: int):
        self.node = node
        self.group = group
        self.token = token
        self.pid: Optional[int] = None
        self._pid_evt = threading.Event()
        self._exit_evt = threading.Event()

    def set_pid(self, pid: int):
        self.pid = pid
        self._pid_evt.set()

    def wait_pid(self, timeout: float) -> Optional[int]:
        self._pid_evt.wait(timeout)
        return self.pid

    def mark_exited(self):
        self._exit_evt.set()

    def is_alive(self) -> bool:
        return not self._exit_evt.is_set() and self.node.alive

    def join(self, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.time() + timeout
        while not self._exit_evt.is_set() and self.node.alive:
            if deadline is not None and time.time() >= deadline:
                return
            self._exit_evt.wait(0.05)

    def kill(self):
        if self.pid is not None:
            self.node.send(("kill", self.pid))


class _NodeHandle:
    """Supervisor-side view of one node agent's control connection."""

    def __init__(self, driver: "ProcessEngineDriver", name: str, pid: int,
                 conn):
        self.driver = driver
        self.name = name
        self.pid = pid
        self.conn = conn
        self.alive = True
        self.lock = threading.Lock()       # send + proc registry
        self.procs: Dict[Tuple[str, int], _RemoteProc] = {}

    def send(self, msg) -> bool:
        with self.lock:
            if not self.alive:
                return False
            try:
                self.conn.send(msg)
                return True
            except (OSError, ValueError):
                self.alive = False
                return False

    def loop(self):
        while True:
            try:
                msg = self.conn.recv()
            except (EOFError, OSError):
                self.driver.on_node_dead(self)
                return
            kind = msg[0]
            with self.lock:
                p = self.procs.get((msg[1], msg[2]))
            if p is None:
                continue
            if kind == "spawned":
                p.set_pid(msg[3])
            elif kind == "exit":
                p.mark_exited()


class _ControlHub:
    """Supervisor-side rendezvous listener (AF_INET + authkey): node
    agents announce themselves here, and bootstrap-only workers dial
    their RPC and transport connections back — the supervisor half of a
    worker start that involves no fork inheritance at all."""

    def __init__(self, driver: "ProcessEngineDriver",
                 host: str = "127.0.0.1"):
        self.driver = driver
        self.authkey = os.urandom(20)
        self.listener = mpc.Listener((host, 0), family="AF_INET",
                                     authkey=self.authkey)
        self.address = self.listener.address
        self._cv = threading.Condition()
        self._pending: Dict[Tuple[str, str, int], Any] = {}
        self._closed = False
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="ctl-hub").start()

    def _accept_loop(self):
        while not self._closed:
            try:
                conn = self.listener.accept()
                hello = conn.recv()
            except AuthenticationError:
                continue                  # wrong/missing authkey: reject
            except (OSError, EOFError):
                if self._closed:
                    return
                # dead dialer mid-handshake: keep listening; the sleep
                # bounds the spin if accept() itself fails persistently
                time.sleep(0.01)
                continue
            if not (isinstance(hello, tuple) and hello):
                conn.close()
                continue
            if hello[0] == "node":
                self.driver.on_node_connected(hello[1], hello[2], conn)
            elif hello[0] == "worker":
                with self._cv:
                    self._pending[(hello[1], hello[2], hello[3])] = conn
                    self._cv.notify_all()
            else:
                conn.close()

    def wait_worker(self, kind: str, group: str, token: int,
                    timeout: float):
        """The (kind, group, spawn-token) dial-back conn, or None."""
        deadline = time.time() + timeout
        key = (kind, group, token)
        with self._cv:
            while key not in self._pending:
                left = deadline - time.time()
                if left <= 0:
                    return None
                self._cv.wait(left)
            return self._pending.pop(key)

    def close(self):
        self._closed = True
        try:
            self.listener.close()
        except OSError:
            pass


class ProcessEngineDriver:
    """Supervisor: starts one worker process per operator group (direct
    child under the configured mp context, or via a node agent per the
    placement), owns the shared store/external/injector and the
    transport's supervisor half, detects worker death (SIGKILL included)
    and warm-restarts only the failed group while the rest keep
    processing."""

    def __init__(self, engine):
        self.e = engine
        self.ctx = multiprocessing.get_context(engine.proc_ctx)
        self.lock = threading.RLock()
        self.workers: Dict[str, _WorkerHandle] = {}
        self.ch_by_name: Dict[str, Any] = {}
        self._stop = threading.Event()
        self._failed = threading.Event()
        self._supervisor: Optional[threading.Thread] = None
        self._hub: Optional[_ControlHub] = None
        self._nodes: Dict[str, _NodeHandle] = {}
        self._nodes_cv = threading.Condition()
        # cumulative per-op event counters across worker incarnations
        # (live worker stats land in _op_stats_live, folded into
        # _op_stats_base when the incarnation dies)
        self._op_stats_base: Dict[str, Dict[str, int]] = {}
        self._op_stats_live: Dict[str, Dict[str, int]] = {}
        # full per-operator counter dicts (txns, batched_runs,
        # recovery_scan_batches, ...), same base/live split — op_stats()
        # keeps its collapsed events_in+events_out shape for the benches
        self._op_detail_base: Dict[str, Dict[str, Dict[str, int]]] = {}
        self._op_detail_live: Dict[str, Dict[str, Dict[str, int]]] = {}
        # wire-level transport counters (superframes/bytes/coalescing),
        # same base/live split per group
        self._wire_base: Dict[str, Dict[str, int]] = {}
        self._wire_live: Dict[str, Dict[str, int]] = {}
        # instantaneous gauges ("g_"-prefixed keys in worker stats, e.g.
        # queue depth) — live-only: a dead incarnation's gauge is
        # meaningless, so these are never folded into a base
        self._op_gauge_live: Dict[str, Dict[str, Dict[str, int]]] = {}
        with self.lock:
            self.ch_by_name = {ch.name: ch for ch in self.e.channels}
        self.transport = make_supervisor_transport(engine.transport, self)

    # ---- channel bookkeeping --------------------------------------------
    def refresh_channels(self):
        """(Re)index the engine's authoritative channels — called at start
        and after dynamic-scaling topology changes."""
        with self.lock:
            self.ch_by_name = {ch.name: ch for ch in self.e.channels}
        self.transport.sync_channels()

    def record_stats(self, group: str, stats: Dict[str, dict]):
        """Live per-operator counters from a worker (under self.lock)."""
        stats = dict(stats)
        wire = stats.pop("__wire__", None)
        if wire is not None:
            self._wire_live[group] = dict(wire)
        counters: Dict[str, Dict[str, int]] = {}
        gauges: Dict[str, Dict[str, int]] = {}
        for op, s in stats.items():
            c = counters[op] = {}
            g = gauges[op] = {}
            for k, n in s.items():
                (g if k.startswith("g_") else c)[k] = n
        self._op_stats_live[group] = {
            op: s.get("events_in", 0) + s.get("events_out", 0)
            for op, s in counters.items()}
        self._op_detail_live[group] = counters
        self._op_gauge_live[group] = gauges

    def pump_all(self):
        """Re-deliver/rebroadcast after a topology change (scaling)."""
        self.transport.after_rewire()

    # ---- node agents -----------------------------------------------------
    def on_node_connected(self, name: str, pid: int, conn):
        """A node agent dialed the control hub (cluster start or warm node
        restart): adopt the fresh connection; a previous incarnation of
        the node is dead by definition."""
        nh = _NodeHandle(self, name, pid, conn)
        with self._nodes_cv:
            old = self._nodes.get(name)
            if old is not None:
                old.alive = False
            self._nodes[name] = nh
            self._nodes_cv.notify_all()
        threading.Thread(target=nh.loop, daemon=True,
                         name=f"node-{name}").start()

    def on_node_dead(self, nh: _NodeHandle):
        """Agent conn EOF = the node died.  Every worker on it reports
        dead (their handles' `_RemoteProc.is_alive` goes False), so the
        supervision loop warm-restarts exactly those groups — after
        `_ensure_node` brings a fresh agent up — while workers on other
        nodes keep processing."""
        nh.alive = False
        with self._nodes_cv:
            self._nodes_cv.notify_all()

    def _ensure_node(self, name: str, timeout: float = 20.0) -> _NodeHandle:
        with self._nodes_cv:
            nh = self._nodes.get(name)
            if nh is not None and nh.alive:
                return nh
        cluster = self.e.cluster
        if cluster is None:
            raise RuntimeError(
                f"group placed on node {name!r} but no cluster= given")
        cluster.ensure_node(name)
        deadline = time.time() + timeout
        with self._nodes_cv:
            while True:
                nh = self._nodes.get(name)
                if nh is not None and nh.alive:
                    return nh
                left = deadline - time.time()
                if left <= 0:
                    raise RuntimeError(f"node {name!r} did not come up")
                self._nodes_cv.wait(left)

    # ---- lifecycle -------------------------------------------------------
    def start(self):
        if self.e.cluster is not None:
            self._hub = _ControlHub(self)
            self.e.cluster.start(self._hub.address, self._hub.authkey)
        for g in sorted(set(self.e.pipeline.groups.values())):
            self._spawn(g, recover=self.e._resume)
        self._supervisor = threading.Thread(target=self._supervise,
                                            daemon=True, name="proc-super")
        self._supervisor.start()

    def _remote_spawn(self, node: str, group: str, token: int,
                      bootstrap: WorkerBootstrap):
        """Launch a worker through a node agent: ship the bootstrap, wait
        for the spawned ack and the worker's rpc/tr dial-backs.  One
        retry after re-ensuring the node covers an agent that died
        between placement lookup and spawn."""
        last_err = "node unavailable"
        for _attempt in range(2):
            try:
                nh = self._ensure_node(node)
            except RuntimeError as exc:
                last_err = str(exc)
                continue
            proc = _RemoteProc(nh, group, token)
            with nh.lock:
                for key in [k for k in nh.procs if k[0] == group]:
                    del nh.procs[key]       # dead incarnations' entries
                nh.procs[(group, token)] = proc
            if not nh.send(("spawn", bootstrap)):
                last_err = f"node {node!r} connection lost"
                continue
            if proc.wait_pid(SPAWN_TIMEOUT / 2) is None:
                last_err = f"node {node!r} never acknowledged the spawn"
                continue
            rpc_conn = self._hub.wait_worker("rpc", group, token,
                                             SPAWN_TIMEOUT / 2)
            tr_conn = self._hub.wait_worker("tr", group, token,
                                            SPAWN_TIMEOUT / 2)
            if rpc_conn is None or tr_conn is None:
                last_err = f"worker {group!r} never dialed back"
                continue
            return proc, rpc_conn, tr_conn
        raise RuntimeError(
            f"spawn of {group!r} on node {node!r} failed: {last_err}")

    def _spawn(self, group: str, recover: bool,
               after_death_of: Optional[int] = None) -> bool:
        """Start the group's worker; False when it did not. A warm restart
        after a death passes the incarnation that died (``after_death_of``)
        and yields if the group was stopped, removed or restarted meanwhile:
        a second worker of one group would orphan the first."""
        node = self.e.placement.node_of(group)
        with self.lock:
            h = self.workers.get(group)
            if after_death_of is not None and (
                    h is None or h.stopping or h.alive
                    or h.spawn_token != after_death_of):
                return False
            if h is None:
                h = _WorkerHandle(group)
                self.workers[group] = h
            h.spawn_token += 1
            token = h.spawn_token
            h.stopping = False
            bootstrap = self.e.make_bootstrap(group, recover=recover,
                                              incarnation=token)
        if node is None:
            # direct child of the supervisor under the configured context:
            # fork inherits the (unpicklable-safe) payload, spawn pickles
            # it — either way the worker reads only the bootstrap
            rpc_parent, rpc_child = self.ctx.Pipe()
            tr_parent, tr_child = self.ctx.Pipe()
            proc = self.ctx.Process(target=_worker_entry,
                                    args=(bootstrap, rpc_child, tr_child),
                                    daemon=True, name=f"logio-{group}")
            proc.start()
            rpc_child.close()
            tr_child.close()
            rpc_conn, tr_conn = rpc_parent, tr_parent
        else:
            bootstrap.control = (self._hub.address, self._hub.authkey)
            try:
                proc, rpc_conn, tr_conn = self._remote_spawn(
                    node, group, token, bootstrap)
            except RuntimeError:
                if self._stop.is_set():
                    return False
                with self.lock:
                    self.e.group_state[group] = "failed"
                self._failed.set()
                return False
        with self.lock:
            with h.send_lock:      # serialize with incarnation-pinned sends
                h.rpc_conn, h.tr_conn = rpc_conn, tr_conn
                h.incarnation += 1
            h.sent = 0
            h.last_idle = None
            h.probe = None
            h.proc = proc
            h.node = node
            h.alive = True
            self.e.group_state[group] = "running"
            h.rpc_thread = threading.Thread(
                target=self._rpc_loop, args=(h,), daemon=True,
                name=f"rpc-{group}")
            h.tr_thread = threading.Thread(
                target=self.transport.tr_loop, args=(h,), daemon=True,
                name=f"tr-{group}")
            h.rpc_thread.start()
            h.tr_thread.start()
            # computed under the driver lock, in the same critical section
            # as the incarnation bump: no concurrent ack-grant can observe
            # a buffer state this initial window has not accounted for
            initial_msgs = self.transport.on_spawn_locked(h)
            inc = h.incarnation
        for m in initial_msgs:         # conn sends outside the driver lock
            h.send(m, incarnation=inc)
        self.transport.on_spawned(h)
        if self._stop.is_set() or h.stopping:
            h.send(("stop",))          # stop raced the (remote) spawn
        return True

    # ---- parent RPC thread ----------------------------------------------
    def _rpc_loop(self, h: _WorkerHandle):
        store, ext = self.e.store, self.e.external
        conn = h.rpc_conn
        while True:
            try:
                msg = conn.recv()
            except (EOFError, OSError):
                return
            kind = msg[0]
            try:
                if kind == "txn":
                    try:
                        reply = ("ok", store._commit(msg[1]))
                    except TxnAborted as exc:
                        reply = ("abort", str(exc))
                elif kind == "store":
                    reply = ("ok", getattr(store, msg[1])(*msg[2]))
                elif kind == "ext":
                    reply = ("ok", getattr(ext, msg[1])(*msg[2]))
                elif kind == "scratch":
                    reply = ("ok", getattr(ScratchStore, msg[1])(*msg[2]))
                elif kind == "inj":
                    try:
                        self.e.injector(msg[1], msg[2])
                        reply = ("ok", None)
                    except SimulatedCrash:
                        reply = ("crash",)
                else:
                    reply = ("err", f"unknown RPC {kind!r}")
            except Exception as exc:   # surface store errors in the worker
                reply = ("err", f"{type(exc).__name__}: {exc}")
            try:
                conn.send(reply)
            except (BrokenPipeError, OSError):
                return

    # ---- supervision -----------------------------------------------------
    def _supervise(self):
        while not self._stop.is_set():
            self._check_deaths()
            # checkpoint cadence lives here (not in the workers): the store
            # is shared across groups, so one supervisor-side compaction
            # truncates the log for everyone
            self.e.store.maybe_checkpoint()
            if not self._failed.is_set() and self.transport.check_done():
                self.e._done.set()
                return
            time.sleep(0.005)

    def _check_deaths(self):
        dead: List[_WorkerHandle] = []
        with self.lock:
            for h in self.workers.values():
                if h.alive and h.proc is not None and not h.proc.is_alive() \
                        and not h.stopping:
                    h.alive = False
                    dead.append(h)
        for h in dead:
            self._on_worker_death(h)

    def _on_worker_death(self, h: _WorkerHandle):
        """A worker died (SIGKILL, injected crash, node death, or error).
        Volatile state is gone; the store and the external system live in
        this process and buffered events are either held by the transport
        or re-derivable from the log — roll back by warm-restarting only
        this group (non-blocking for the others)."""
        group = h.group
        self.e.failures += 1
        self.e.group_state[group] = "dead"
        with self.lock:
            token = h.spawn_token
        h.proc.join()
        # drain every message the worker managed to send before dying
        for t in (h.rpc_thread, h.tr_thread):
            if t is not None:
                t.join(timeout=5.0)
        with self.lock:
            self._fold_stats_locked(group)
            h.restarts += 1
            if h.restarts > MAX_RESTARTS_PER_GROUP:
                self.e.group_state[group] = "failed"
                self._failed.set()
                return
        # transport-side rewind (routed: delivery cursors + inflight;
        # socket: stale address/probe state) — takes its own locks so a
        # stale pump of the dead incarnation finishes first
        self.transport.before_respawn(h)
        if self.e.restart_delay > 0:
            time.sleep(self.e.restart_delay)       # warm pod restart
        if self._stop.is_set():
            return
        if self._spawn(group, recover=True, after_death_of=token):
            self.e.restarts += 1

    # ---- external controls ----------------------------------------------
    def kill_group(self, group: str):
        """SIGKILL the group's worker — genuine node failure.  Remote
        workers are killed through their node agent (the supervisor
        cannot signal a pid on another host)."""
        with self.lock:
            h = self.workers.get(group)
            proc = h.proc if h is not None and h.alive else None
        if proc is None:
            return
        if isinstance(proc, _RemoteProc):
            proc.kill()
            return
        if proc.pid is not None:
            try:
                os.kill(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass

    def stop_group(self, group: str, *, remove: bool = False):
        """Stop a worker deliberately (dynamic scaling): not a failure."""
        with self.lock:
            h = self.workers.get(group)
            if h is None:
                return
            h.stopping = True
        h.send(("stop",))
        if h.proc is not None:
            h.proc.join(timeout=2.0)
            if h.proc.is_alive():
                h.proc.kill()
                h.proc.join(timeout=5.0)
        # drain the router threads BEFORE folding the stats — a buffered
        # final "stats" message would otherwise re-populate the live map
        # after the fold and double-count the incarnation
        for t in (h.rpc_thread, h.tr_thread):
            if t is not None:
                t.join(timeout=5.0)
        with self.lock:
            h.alive = False
            self._fold_stats_locked(group)
            if remove:
                self.workers.pop(group, None)

    def start_group(self, group: str, *, recover: bool):
        """(Re)start a group's worker (dynamic scaling) — lands on
        whatever node the placement currently assigns, so scaling can
        move or add replicas across nodes."""
        self.refresh_channels()
        if recover:
            h = self.workers.get(group)
            if h is not None:
                self.transport.before_respawn(h)
        self._spawn(group, recover=recover)

    def wait_group_drained(self, group: str, timeout: float = 5.0) -> bool:
        """Block until the group's worker has consumed every delivery and
        no event involving its operators is buffered or in flight —
        dynamic scaling must not delete a channel that still buffers a
        logged-and-sent event (nobody would resend it once the endpoint
        is gone)."""
        return self.transport.wait_group_drained(group, timeout)

    def _fold_stats_locked(self, group: str) -> None:
        """An incarnation died/stopped: fold its live counters into the
        cumulative base (driver lock held)."""
        base = self._op_stats_base.setdefault(group, {})
        for op, n in self._op_stats_live.pop(group, {}).items():
            base[op] = base.get(op, 0) + n
        dbase = self._op_detail_base.setdefault(group, {})
        for op, s in self._op_detail_live.pop(group, {}).items():
            acc = dbase.setdefault(op, {})
            for k, n in s.items():
                if k == "gov_max_run":  # high-water mark, not a sum
                    acc[k] = max(acc.get(k, 0), n)
                else:
                    acc[k] = acc.get(k, 0) + n
        self._op_gauge_live.pop(group, None)
        wbase = self._wire_base.setdefault(group, {})
        for k, n in self._wire_live.pop(group, {}).items():
            wbase[k] = wbase.get(k, 0) + n

    def op_stats(self) -> Dict[str, int]:
        """Cumulative processed-event counters per operator across worker
        incarnations (benchmark instrumentation)."""
        with self.lock:
            out: Dict[str, int] = {}
            for g, ops in self._op_stats_base.items():
                for op, n in ops.items():
                    out[op] = out.get(op, 0) + n
            for g, ops in self._op_stats_live.items():
                for op, n in ops.items():
                    out[op] = out.get(op, 0) + n
            return out

    def op_stats_detail(self) -> Dict[str, Dict[str, int]]:
        """Full per-operator counter dicts (txns, batched_runs/_events,
        recovery_scan_batches, ...) summed across incarnations."""
        with self.lock:
            out: Dict[str, Dict[str, int]] = {}
            for src in (self._op_detail_base, self._op_detail_live):
                for g, ops in src.items():
                    for op, s in ops.items():
                        acc = out.setdefault(op, {})
                        for k, n in s.items():
                            acc[k] = acc.get(k, 0) + n
            return out

    def wire_stats(self) -> Dict[str, float]:
        """Cumulative wire-protocol counters across all workers and
        incarnations (byte transports only; empty under ``routed``):
        superframes, bytes, events and control entries carried, plus the
        derived coalescing ratios the benchmarks report."""
        with self.lock:
            out: Dict[str, float] = {}
            for src in (self._wire_base, self._wire_live):
                for g, w in src.items():
                    for k, n in w.items():
                        out[k] = out.get(k, 0) + n
            if out.get("frames"):
                out["events_per_frame"] = out.get("events", 0) / out["frames"]
            if out.get("ctrl_frames"):
                out["ctrl_per_ctrl_frame"] = (out.get("ctrl", 0)
                                              / out["ctrl_frames"])
            return out

    def metrics_raw(self):
        """Raw material for ``Engine.metrics()``: per-op counter dicts
        summed across incarnations (``gov_max_run`` is a high-water mark
        and MAX-folds), per-op instantaneous queue depths from the live
        gauges, and the summed wire counters without derived ratios."""
        with self.lock:
            counters: Dict[str, Dict[str, int]] = {}
            for src in (self._op_detail_base, self._op_detail_live):
                for g, ops in src.items():
                    for op, s in ops.items():
                        acc = counters.setdefault(op, {})
                        for k, n in s.items():
                            if k == "gov_max_run":
                                acc[k] = max(acc.get(k, 0), n)
                            else:
                                acc[k] = acc.get(k, 0) + n
            qdepth: Dict[str, int] = {}
            for g, ops in self._op_gauge_live.items():
                for op, gauges in ops.items():
                    qdepth[op] = (qdepth.get(op, 0)
                                  + int(gauges.get("g_queue_depth", 0)))
            wire: Dict[str, float] = {}
            for src in (self._wire_base, self._wire_live):
                for g, w in src.items():
                    for k, n in w.items():
                        wire[k] = wire.get(k, 0) + n
            return counters, qdepth, wire

    def wait(self, timeout: float) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.e._done.is_set():
                return True
            if self._failed.is_set():
                return False
            time.sleep(0.005)
        return False

    def stop(self):
        self._stop.set()
        with self.lock:
            handles = list(self.workers.values())
        for h in handles:
            h.stopping = True
            h.send(("stop",))
        for h in handles:
            if h.proc is not None:
                h.proc.join(timeout=2.0)
                if h.proc.is_alive():
                    h.proc.kill()
                    h.proc.join(timeout=5.0)
            h.alive = False
        if self._supervisor is not None:
            self._supervisor.join(timeout=5.0)
        self.transport.request_stop()
        with self._nodes_cv:
            nodes = list(self._nodes.values())
        for nh in nodes:
            nh.send(("stop",))
        if self.e.cluster is not None:
            self.e.cluster.stop()
        if self._hub is not None:
            self._hub.close()
        for h in handles:
            for conn in (h.rpc_conn, h.tr_conn):
                try:
                    conn.close()
                except OSError:
                    pass
            for t in (h.rpc_thread, h.tr_thread):
                if t is not None:
                    t.join(timeout=5.0)
