"""Pipeline engine: graph wiring, group execution (threads ≈ pods),
failure injection, warm restart + recovery, lineage configuration.

Two protocols share the substrate:
  * ``protocol="logio"`` — this paper (pessimistic logging, non-blocking
    recovery; only failed groups restart).
  * ``protocol="abs"``   — the baseline (Sec. 8.1): aligned barrier
    snapshotting, global restart from the last complete epoch
    (see ``repro_torch.core.abs``).

Three execution modes:
  * ``mode="thread"``  — one thread per group, real back-pressure and timing
    (used by the benchmarks that reproduce Sec. 9).
  * ``mode="step"``    — deterministic single-threaded round-robin (used by
    the hypothesis property tests; failures injected at exact points).
  * ``mode="process"`` — one forked OS process per group, all workers
    sharing this process's log store; crash = real ``kill -9`` and only
    the failed group warm-restarts (``repro_torch.core.procmode``).  The event
    transport is selectable (``transport="routed"`` keeps every
    authoritative buffer in the supervisor; ``transport="socket"`` runs
    direct worker-to-worker socket channels) — see
    :mod:`repro_torch.core.transport`.  All transports enforce credit-based
    back-pressure at the channel capacity.
"""
from __future__ import annotations

import collections
import dataclasses
import multiprocessing
import os
import pickle
import threading
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.batching import make_governor, resolve_batching
from repro_torch.core.builtin import GeneratorSource
from repro_torch.core.transport import Channel
from repro_torch.core.transport.base import (Placement, WorkerBootstrap,
                                       process_transport_names)
from repro_torch.core.lineage import LineageScope, enabled_ports
from repro_torch.core.logstore import (LogBackend, MemoryLogStore, StoreConfig,
                                 build_store)
from repro_torch.core.metrics import MetricsSnapshot, build_snapshot
from repro_torch.core.operator import (ExternalSystem, Operator, OperatorRuntime,
                                 SimulatedCrash)
from repro_torch.core.recovery import recover_operator


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Typed description of the event transport, replacing the stringly
    ``transport=`` + ``transport_options={...}`` pair. ``name`` is
    ``"local"`` (thread/step mode) or a process transport
    (``"routed"``/``"socket"``/``"tcp"``/``"shm"``); the remaining fields
    configure the byte transports and are ignored by the others."""

    name: str = "local"
    family: Optional[str] = None        # "unix" | "inet" (socket only)
    host: Optional[str] = None          # bind host (inet only)
    authkey: Optional[bytes] = None     # peer-auth secret (per-run default)
    ack_flush: Optional[float] = None   # ack-coalescing linger (seconds)
    ring_bytes: Optional[int] = None    # shm ring capacity per direction

    def __post_init__(self):
        valid = ("local",) + tuple(process_transport_names())
        if self.name not in valid:
            raise ValueError(f"unknown transport {self.name!r} "
                             f"(expected one of {list(valid)})")
        if self.family not in (None, "unix", "inet"):
            raise ValueError(f"unknown socket family {self.family!r} "
                             "(expected 'unix' or 'inet')")
        if self.ack_flush is not None and self.ack_flush < 0:
            raise ValueError("ack_flush must be >= 0")
        if self.ring_bytes is not None and self.ring_bytes < 4096:
            raise ValueError("ring_bytes must be >= 4096")

    def options(self) -> dict:
        """The legacy ``transport_options`` dict this config describes."""
        out: dict = {}
        if self.family is not None:
            out["family"] = self.family
        if self.host is not None:
            out["host"] = self.host
        if self.authkey is not None:
            out["authkey"] = self.authkey
        if self.ack_flush is not None:
            out["ack_flush"] = self.ack_flush
        if self.ring_bytes is not None:
            out["ring_bytes"] = self.ring_bytes
        return out


class FailureInjector:
    """Crash — or stall — the pipeline at precise points.

    plan entries: (op_id, point, nth) — raise SimulatedCrash the nth time
    ``crash_point(op_id, point)`` fires (1-based). point="*" matches any.

    stall entries: (op_id, point, nth_lo, nth_hi, seconds) — sleep
    ``seconds`` at every firing whose per-point count falls in
    [nth_lo, nth_hi] (inclusive).  This is the straggler generator for the
    adaptive-controller traces: the operator stays alive but its service
    time balloons for a window of events.
    """

    def __init__(self, plan: Sequence[Tuple[str, str, int]] = (),
                 stalls: Sequence[Tuple[str, str, int, int, float]] = ()):
        self.plan = list(plan)
        self.stalls = list(stalls)
        self.counts: Dict[Tuple[str, str], int] = collections.defaultdict(int)
        self.fired: List[Tuple[str, str, int]] = []
        self.stalled: int = 0
        self.lock = threading.Lock()

    def stall_active(self, op_id: str, point: str) -> bool:
        """True while a stall window for (op_id, point) has firings left —
        the controller tests use this to know when the straggler clears."""
        with self.lock:
            n = self.counts[(op_id, point)]
            return any(o == op_id and p == point and n < hi
                       for o, p, _lo, hi, _s in self.stalls)

    def __call__(self, op_id: str, point: str):
        delay = 0.0
        with self.lock:
            # two plain counters per operator: hits of this exact point, and
            # hits of any point (what "*" plan entries count against)
            self.counts[(op_id, point)] += 1
            self.counts[(op_id, "*")] += 1
            n_point = self.counts[(op_id, point)]
            n_any = self.counts[(op_id, "*")]
            for (o, p, lo, hi, sec) in self.stalls:
                if o != op_id:
                    continue
                n = n_point if p == point else \
                    (n_any if p == "*" else None)
                if n is not None and lo <= n <= hi:
                    delay = max(delay, sec)
                    self.stalled += 1
            for i, (o, p, nth) in enumerate(self.plan):
                if o != op_id:
                    continue
                if (p == point and n_point == nth) or (p == "*" and n_any == nth):
                    self.fired.append((o, p, nth))
                    del self.plan[i]
                    raise SimulatedCrash(f"{op_id}@{point}#{nth}")
        if delay > 0:
            time.sleep(delay)


class Pipeline:
    """Declarative pipeline graph; operators given as factories so restarts
    build fresh instances (volatile state loss)."""

    def __init__(self):
        self.factories: Dict[str, Callable[[], Operator]] = {}
        self.connections: List[Tuple[str, str, str, str, int]] = []
        self.groups: Dict[str, str] = {}

    def add(self, factory: Callable[[], Operator], group: Optional[str] = None
            ) -> str:
        op = factory()
        self.factories[op.id] = factory
        self.groups[op.id] = group or op.id
        return op.id

    def connect(self, src: str, src_port: str, dst: str, dst_port: str,
                capacity: int = 256):
        self.connections.append((src, src_port, dst, dst_port, capacity))

    def successors(self, op_id: str) -> List[str]:
        return [c[2] for c in self.connections if c[0] == op_id]

    def predecessors(self, op_id: str) -> List[str]:
        return [c[0] for c in self.connections if c[2] == op_id]

    def edges(self) -> List[Tuple[Tuple[str, str], Tuple[str, str]]]:
        return [((s, sp), (d, dp)) for s, sp, d, dp, _ in self.connections]


class Engine:
    def __init__(self, pipeline: Pipeline, *,
                 store: Optional[Any] = None,
                 external: Optional[ExternalSystem] = None,
                 protocol: str = "logio",
                 lineage_scopes: Sequence[LineageScope] = (),
                 injector: Optional[FailureInjector] = None,
                 mode: str = "thread",
                 transport: Optional[Any] = None,
                 transport_options: Optional[dict] = None,
                 ctx: Optional[str] = None,
                 placement: Optional[Any] = None,
                 cluster: Optional[Any] = None,
                 restart_delay: float = 0.05,
                 replay_ops: Sequence[str] = (),
                 abs_options: Optional[dict] = None,
                 batching: Optional[Any] = None,
                 resume: bool = False,
                 recovery_modes: Optional[Dict[str, str]] = None,
                 epoch_interval: int = 16):
        """``store`` is any :class:`LogBackend`, a typed
        :class:`~repro_torch.core.logstore.StoreConfig`, or a ``build_store``
        spec string like ``"memory+sharded+group"``. ``resume=True`` starts
        every operator in state "restarted" — warm restart of a whole
        pipeline against a recovered store (full-process crash).
        ``transport`` is a :class:`TransportConfig` or a transport name:
        it selects the process-mode channel implementation
        (``"routed"``/``"socket"``/``"tcp"``); thread and step mode always
        use the in-memory ``"local"`` transport.  The legacy
        ``transport_options`` dict configures the socket family
        (``{"family": "unix"|"inet"}``), bind host and authkey — with a
        TransportConfig those knobs live in the config instead.  ``ctx``
        selects the worker start method
        (``"fork"``/``"spawn"``): spawn workers are rebuilt purely from a
        picklable :class:`WorkerBootstrap` payload + the log, never from
        inherited parent memory — group factories must then be picklable.
        ``placement`` (a :class:`Placement` or a ``{group: node}`` dict)
        assigns groups to cluster nodes; ``cluster`` is the node-agent
        harness (e.g. :class:`repro_torch.core.cluster.LocalCluster`) that
        launches workers on those nodes."""
        self.pipeline = pipeline
        self._resume = resume
        if isinstance(transport, TransportConfig):
            if transport_options:
                raise ValueError("pass socket options inside the "
                                 "TransportConfig, not via "
                                 "transport_options=")
            transport_options = transport.options()
            transport = transport.name
        if mode == "process":
            self.transport = transport or "routed"
            if self.transport not in process_transport_names():
                raise ValueError(
                    f"unknown process transport {self.transport!r} "
                    f"(have {process_transport_names()})")
            if ctx is None:
                ctx = ("fork" if "fork" in
                       multiprocessing.get_all_start_methods() else "spawn")
            if ctx not in multiprocessing.get_all_start_methods():
                raise ValueError(
                    f"unknown start method ctx={ctx!r} "
                    f"(have {multiprocessing.get_all_start_methods()})")
        else:
            if transport not in (None, "local"):
                raise ValueError(
                    f"transport={transport!r} requires mode='process'")
            if ctx is not None or placement is not None \
                    or cluster is not None:
                raise ValueError(
                    "ctx=/placement=/cluster= require mode='process'")
            self.transport = "local"
        self.proc_ctx = ctx
        self.transport_options = dict(transport_options or {})
        if self.transport in ("socket", "tcp", "shm"):
            if self.transport == "tcp":
                if self.transport_options.get("family", "inet") != "inet":
                    raise ValueError(
                        "transport='tcp' is pinned to family='inet'; use "
                        "transport='socket' for other families")
                self.transport_options["family"] = "inet"
            # per-run authkey: worker listeners authenticate every peer
            # connection (an AF_INET listener is reachable by anything on
            # the network, unlike a mode-0600 unix socket)
            self.transport_options.setdefault("authkey", os.urandom(20))
            fam = self.transport_options.get("family")
            if fam not in (None, "unix", "inet"):
                raise ValueError(f"unknown socket family {fam!r} "
                                 "(expected 'unix' or 'inet')")
            if fam == "unix" and not hasattr(__import__("socket"),
                                             "AF_UNIX"):
                raise ValueError("family='unix' unavailable on this host")
        if isinstance(placement, dict):
            placement = Placement(placement)
        self.placement = placement or Placement()
        self.cluster = cluster
        if cluster is None and self.placement.nodes():
            raise ValueError("placement names nodes but no cluster= given")
        if isinstance(store, (str, StoreConfig)):
            store = build_store(store)
        self.store: LogBackend = store or MemoryLogStore()
        self.external = external or ExternalSystem()
        self.protocol = protocol
        self.lineage_scopes = list(lineage_scopes)
        self.injector = injector or FailureInjector()
        self.mode = mode
        self.restart_delay = restart_delay
        self.replay_ops = set(replay_ops)
        self.abs_options = abs_options or {}
        # micro-batch governor spec: "off" (default), "adaptive", or a
        # fixed int run length; None consults LOGIO_BATCH. Resolved once
        # here so process-mode workers inherit the supervisor's decision
        # through the bootstrap payload. See docs/batching.md.
        self.batching = resolve_batching(batching)

        # per-group recovery mode: "log" (per-event LOG.io logging, the
        # default) or "epoch" (interval state snapshotting on the same
        # log — the ABS-style amortization) — the adaptive controller's
        # actuator (repro_torch.core.controller).  The mode recorded in the log
        # is authoritative across restarts: a resumed engine overrides the
        # constructor argument with what the log says.
        self.epoch_interval = int(epoch_interval)
        if self.epoch_interval < 2:
            raise ValueError(f"epoch_interval must be >= 2, "
                             f"got {epoch_interval!r}")
        all_groups = set(pipeline.groups.values())
        self.recovery_modes: Dict[str, str] = {}   # epoch groups only
        self._mode_stale: set = set()   # groups whose snapshot may trail
        for g, m in (recovery_modes or {}).items():
            if g not in all_groups:
                raise ValueError(f"recovery_modes names unknown group {g!r} "
                                 f"(have {sorted(all_groups)})")
            if m not in ("log", "epoch"):
                raise ValueError(f"unknown recovery mode {m!r} for group "
                                 f"{g!r} (expected 'log' or 'epoch')")
            if m == "log" and protocol == "abs":
                raise ValueError(
                    "recovery_mode 'log' cannot be mixed with "
                    "protocol='abs' (the ABS barrier aligns every group)")
            if m == "epoch":
                self.recovery_modes[g] = m
        persisted = {g: self._load_mode(g) for g in all_groups}
        for g, rec in persisted.items():
            if rec is None:
                continue
            if rec["mode"] == "epoch":
                self.recovery_modes[g] = "epoch"
            else:
                self.recovery_modes.pop(g, None)
            if rec.get("stale"):
                self._mode_stale.add(g)
        if protocol != "abs":
            # record constructor-requested epoch modes up front: a crash
            # before the first switch must already recover under them
            for g in sorted(self.recovery_modes):
                if persisted.get(g) is None:
                    self._persist_mode(g, "epoch", stale=False)

        self._stop = threading.Event()
        self._done = threading.Event()
        self.ops: Dict[str, Operator] = {}
        self.runtimes: Dict[str, OperatorRuntime] = {}
        self.channels: List[Channel] = []
        self.threads: Dict[str, threading.Thread] = {}
        self.group_state: Dict[str, str] = {}
        self.failures = 0
        self.restarts = 0
        self._kill_requests: set = set()
        self._proc = None               # ProcessEngineDriver (mode="process")
        self._restart_lock = threading.Lock()
        self._lineage_ports = enabled_ports(pipeline, self.lineage_scopes)
        if self.replay_ops:
            # replay flips (Sec. 5) can turn done inputs of a replay
            # operator back into needed ones, so checkpoint compaction must
            # never GC the payloads feeding replay ops
            self.store.set_gc_protect(
                self.replay_ops |
                {s for s, _sp, d, _dp, _ in pipeline.connections
                 if d in self.replay_ops})
        self._build(first=True, restarted=resume)

    # ------------------------------------------------------------------
    # per-group recovery mode (the adaptive controller's actuator)
    # ------------------------------------------------------------------
    _MODE_KEY = "__mode__:{}"

    def _load_mode(self, group: str) -> Optional[dict]:
        blob = self.store.get_state(self._MODE_KEY.format(group))
        return None if blob is None else pickle.loads(blob)

    def _persist_mode(self, group: str, mode: str, *, stale: bool):
        txn = self.store.begin()
        txn.put_state(self._MODE_KEY.format(group), 0,
                      pickle.dumps({"mode": mode, "stale": bool(stale)}))
        txn.commit()

    def recovery_mode_of(self, group: str) -> str:
        if self.protocol == "abs":
            return "epoch"   # the ABS barrier epoch-snapshots every group
        return self.recovery_modes.get(group, "log")

    def set_recovery_mode(self, group: str, mode: str):
        """Switch ``group`` between ``"log"`` (per-event logging) and
        ``"epoch"`` (interval snapshotting) at runtime.

        The new mode is recorded in the log *before* it takes effect, so a
        crash anywhere mid-switch recovers under the mode the log holds.
        Leaving "epoch" persists fresh state snapshots (thread/step mode)
        or marks the group's snapshots stale (process mode — the restarted
        worker then recovers with the DONE-inclusive scan and re-bounds
        itself).  Process-mode groups warm-restart to apply the switch;
        thread-mode groups switch live under the operator locks."""
        if mode not in ("log", "epoch"):
            raise ValueError(f"unknown recovery mode {mode!r} "
                             "(expected 'log' or 'epoch')")
        if group not in set(self.pipeline.groups.values()):
            raise ValueError(f"unknown group {group!r}")
        if self.protocol == "abs":
            raise ValueError("recovery modes are fixed under protocol='abs' "
                             "(the ABS barrier aligns every group)")
        with self._restart_lock:
            cur = self.recovery_mode_of(group)
            if cur == mode:
                return
            if self._proc is not None:
                # persist first (authoritative across SIGKILL), then
                # warm-restart the group so the worker rebuilds under it
                self._persist_mode(group, mode, stale=(cur == "epoch"))
                if mode == "epoch":
                    self.recovery_modes[group] = "epoch"
                else:
                    self.recovery_modes.pop(group, None)
                    self._mode_stale.add(group)
                self._proc.stop_group(group)
                self._proc.start_group(group, recover=True)
                return
            if mode == "log":
                # leaving epoch: persist a fresh snapshot per op under its
                # lock, so interval-1 recovery is re-bounded before the
                # mode record flips
                for op_id in self.group_ops(group):
                    rt = self.runtimes.get(op_id)
                    if rt is None:
                        continue
                    with rt.op_lock:
                        txn = self.store.begin()
                        txn.put_state(op_id, rt.new_state_id(),
                                      rt._state_blob(),
                                      keep_history=rt.keep_state_history)
                        txn.commit()
                        rt.state_interval = 1
                        rt._since_state = 0
                self._persist_mode(group, "log", stale=False)
                self.recovery_modes.pop(group, None)
                self._mode_stale.discard(group)
            else:
                self._persist_mode(group, "epoch", stale=False)
                self.recovery_modes[group] = "epoch"
                for op_id in self.group_ops(group):
                    rt = self.runtimes.get(op_id)
                    if rt is not None and not rt.keep_state_history:
                        with rt.op_lock:
                            rt.state_interval = self.epoch_interval

    # ------------------------------------------------------------------
    def _build(self, first: bool, only_group: Optional[str] = None,
               restarted: bool = False):
        # step mode is single-threaded: a blocking put would deadlock the
        # deterministic round-robin, so its channels are effectively
        # unbounded. Thread and process mode run the configured capacity —
        # the credit window of the transport layer.
        cap_override = 1_000_000 if self.mode == "step" else None
        if first:
            for (s, sp, d, dp, cap) in self.pipeline.connections:
                self.channels.append(Channel(s, sp, d, dp,
                                             cap_override or cap))
        for op_id, factory in self.pipeline.factories.items():
            if only_group and self.pipeline.groups[op_id] != only_group:
                continue
            op = factory()
            assert op.id == op_id
            op.state = "restarted" if restarted else "running"
            self.ops[op_id] = op
            self._wire(op)
            if restarted:
                # deferred acks of the dead runtime rewind: the events are
                # still buffered and will be re-delivered (obsolete-filtered
                # once recovery restores the context)
                for ch in op.in_channels.values():
                    ch.reset_pending()
            lin_in, lin_out = self._lineage_ports.get(op_id, (set(), set()))
            g = self.pipeline.groups[op_id]
            self.runtimes[op_id] = OperatorRuntime(
                op, self.store,
                lineage_in=lin_in, lineage_out=lin_out,
                external=self.external,
                crash_point=self.injector,
                stop_flag=self._stop.is_set,
                replay_mode=op_id in self.replay_ops,
                keep_state_history=bool(lin_out),
                state_interval=(self.epoch_interval
                                if self.recovery_modes.get(g) == "epoch"
                                else 1),
            )
            self.runtimes[op_id].governor = make_governor(self.batching)
        for g in set(self.pipeline.groups.values()):
            if only_group and g != only_group:
                continue
            self.group_state[g] = "running"

    def _wire(self, op: Operator):
        op.in_channels = {}
        op.out_channels = {p: [] for p in op.output_ports}
        for ch in self.channels:
            if ch.rec_op == op.id:
                op.in_channels[ch.rec_port] = ch
            if ch.send_op == op.id:
                op.out_channels.setdefault(ch.send_port, []).append(ch)

    def group_ops(self, group: str) -> List[str]:
        return [o for o, g in self.pipeline.groups.items() if g == group]

    def make_bootstrap(self, group: str, *, recover: bool,
                       incarnation: int) -> WorkerBootstrap:
        """The picklable payload a worker (re)starts from — a snapshot of
        the live topology (scaling mutates ``pipeline.connections`` and
        ``engine.channels`` in lock-step, so connection tuples are the
        authoritative channel specs) plus this group's factories.  No
        recovery state crosses: the worker rebuilds it from the log."""
        p = self.pipeline
        opts = dict(self.transport_options)
        if self.transport == "shm":
            # rings are a same-host medium: ship the placement node map so
            # each worker picks ring vs. socket per peer (None == None for
            # unplaced pairs — the single-host default is co-located)
            opts["placement"] = {g: self.placement.node_of(g)
                                 for g in set(p.groups.values())}
        return WorkerBootstrap(
            group=group,
            incarnation=incarnation,
            recover=recover,
            transport=self.transport,
            transport_options=opts,
            factories={o: f for o, f in p.factories.items()
                       if p.groups[o] == group},
            connections=list(p.connections),
            groups=dict(p.groups),
            lineage_ports={o: self._lineage_ports[o]
                           for o in self.group_ops(group)
                           if o in self._lineage_ports},
            replay_ops=frozenset(self.replay_ops),
            batching=self.batching,
            recovery={"modes": dict(self.recovery_modes),
                      "stale": sorted(self._mode_stale),
                      "interval": self.epoch_interval},
        )

    # ------------------------------------------------------------------
    def signal_done(self):
        self._done.set()

    def kill_group(self, group: str):
        """External kill switch: SIGKILL the worker in process mode, a
        simulated node failure in thread mode."""
        if self._proc is not None:
            self._proc.kill_group(group)
            return
        self._kill_requests.add(group)

    def start(self):
        if self.protocol == "abs":
            from repro_torch.core.abs import AbsEngineDriver
            self._abs = AbsEngineDriver(self, **self.abs_options)
            self._abs.start()
            return
        if self.mode == "process":
            from repro_torch.core.procmode import ProcessEngineDriver
            self._proc = ProcessEngineDriver(self)
            self._proc.start()
            return
        for g in set(self.pipeline.groups.values()):
            self._start_group(g, recover=self._resume)

    def _start_group(self, group: str, recover: bool):
        t = threading.Thread(target=self._run_group, args=(group, recover),
                             daemon=True, name=f"grp-{group}")
        self.threads[group] = t
        t.start()

    def _run_group(self, group: str, recover: bool):
        try:
            if recover:
                for op_id in self.group_ops(group):
                    self._recover_op(self.ops[op_id])
            while not self._stop.is_set() and not self._done.is_set():
                if self.group_state.get(group) == "removed":
                    return
                if group in self._kill_requests:
                    self._kill_requests.discard(group)
                    raise SimulatedCrash(f"external kill of {group}")
                progressed = False
                for op_id in self.group_ops(group):
                    op = self.ops.get(op_id)
                    if op is not None:
                        progressed |= self._step_op(op)
                    rt = self.runtimes.get(op_id)
                    if rt is not None:
                        progressed |= rt.drain_durable()
                # checkpoint cadence: compact the log once the configured
                # record count accumulated (no-op for non-checkpointing
                # stores), keeping warm-restart replay O(interval)
                self.store.maybe_checkpoint()
                if not progressed and self._sources_exhausted():
                    # end of stream: force the durability watermark forward
                    # so held acks/writes release before we conclude we're
                    # done. Mid-stream idle gaps rely on the interval
                    # watermark instead — forcing there would collapse
                    # group-commit batches to single transactions.
                    for op_id in self.group_ops(group):
                        rt = self.runtimes.get(op_id)
                        if rt is not None:
                            progressed |= rt.drain_durable(force=True)
                if not progressed:
                    if self._sources_exhausted() and self._all_idle():
                        time.sleep(0.01)
                        if self._sources_exhausted() and self._all_idle():
                            self._done.set()
                            return
                    time.sleep(0.001)
        except SimulatedCrash as e:
            self._on_crash(group, e)

    # ------------------------------------------------------------------
    def _step_op(self, op: Operator) -> bool:
        rt = self.runtimes[op.id]
        if isinstance(op, GeneratorSource):
            gov = rt.governor
            if gov is not None:
                n = gov.limit(op.pending_emits())
                if n > 1:
                    t0 = time.monotonic()
                    k = op.step_run(n)
                    gov.observe(k, time.monotonic() - t0)
                    return k > 0
            return op.step()
        progressed = False
        gov = rt.governor
        for port in op.input_ports:
            ch = op.in_channels.get(port)
            if ch is None:
                continue
            if gov is not None:
                # drain a governed run of already-queued events through one
                # vectored pass; an idle channel degenerates to runs of one
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
        if not progressed:
            # an InSet can be left triggered with its channel already
            # drained (the input's ack txn committed but the engine
            # interleaved away before generation) — fire it here, since
            # the idle detection counts queued triggers as live work
            for inset in op.triggers():
                rt.generate(inset)
                progressed = True
        return progressed

    def _recover_op(self, op: Operator):
        rt = self.runtimes[op.id]
        is_source = isinstance(op, GeneratorSource)
        replay_pred_ports = {dp for s, sp, d, dp, _ in
                             self.pipeline.connections
                             if d == op.id and s in self.replay_ops}
        g = self.pipeline.groups[op.id]
        recover_operator(rt, is_source=is_source,
                         source_driver=GeneratorSource.driver
                         if is_source else None,
                         replay_pred_ports=replay_pred_ports,
                         include_done=(self.recovery_modes.get(g) == "epoch"
                                       or g in self._mode_stale))

    def _replay_cascade(self, failed_group: str) -> List[str]:
        """Replay predecessors (transitively through replay ops) of the
        failed group's operators — they must restart in state 'replay'
        (Sec. 5.2)."""
        frontier = set(self.group_ops(failed_group))
        cascade: set = set()
        while True:
            preds = {s for s, sp, d, dp, _ in self.pipeline.connections
                     if d in frontier and s in self.replay_ops} - cascade                 - set(self.group_ops(failed_group))
            if not preds:
                break
            cascade |= preds
            frontier = preds
        return sorted({self.pipeline.groups[o] for o in cascade})

    def _on_crash(self, group: str, exc: SimulatedCrash):
        self.failures += 1
        self.group_state[group] = "dead"
        # volatile state of every op in the group is lost; logs+channels live
        def restart():
            if self.restart_delay > 0:
                time.sleep(self.restart_delay)     # warm pod restart
            with self._restart_lock:
                self._build(first=False, only_group=group, restarted=True)
                self.restarts += 1
                self.group_state[group] = "running"
            if self.mode == "thread":
                self._start_group(group, recover=True)
        if self.mode == "thread":
            threading.Thread(target=restart, daemon=True).start()
        else:
            restart()

    # ------------------------------------------------------------------
    def _sources_exhausted(self) -> bool:
        return all(op.exhausted for op in self.ops.values()
                   if isinstance(op, GeneratorSource))

    def _all_idle(self) -> bool:
        if any(s == "dead" for s in self.group_state.values()):
            return False
        if any(op.has_pending() for op in self.ops.values()):
            return False
        # a triggered-but-ungenerated InSet is live work even though its
        # input already left the channel: the generation (and its sends)
        # is still to come — without this, a slow generate on the final
        # event races the idle double-check and the output lands in a
        # channel whose consumer thread has already exited
        if any(op.triggers() for op in list(self.ops.values())):
            return False
        if any(rt._deferred for rt in list(self.runtimes.values())):
            return False    # effects still gated on the durability watermark
        return all(len(ch) == 0 for ch in self.channels)

    # ------------------------------------------------------------------
    # the unified typed metrics plane (docs/metrics.md)
    # ------------------------------------------------------------------
    def metrics(self) -> MetricsSnapshot:
        """One typed, coherent point-in-time view of the whole engine —
        per-operator counters + queue-depth gauges, transport counters and
        store scan effort — identical in thread, step and process mode.
        The single supported stats surface; the legacy accessors below are
        DeprecationWarning shims over it."""
        groups = dict(self.pipeline.groups)
        modes = {g: self.recovery_mode_of(g)
                 for g in set(self.pipeline.groups.values())}
        if self._proc is not None:
            op_counters, qdepth, wire = self._proc.metrics_raw()
        else:
            op_counters: Dict[str, Dict[str, int]] = {}
            qdepth: Dict[str, int] = {}
            wire: Dict[str, float] = {}
            for op_id, rt in list(self.runtimes.items()):
                c = dict(rt.stats)
                gov = rt.governor
                if gov is not None:
                    gs = gov.stats()
                    c["gov_runs"] = gs["runs"]
                    c["gov_events"] = gs["events"]
                    c["gov_max_run"] = gs["max_run"]
                op_counters[op_id] = c
                op = self.ops.get(op_id)
                if op is not None:
                    qdepth[op_id] = sum(ch.unprocessed()
                                        for ch in op.in_channels.values())
        return build_snapshot(mode=self.mode, protocol=self.protocol,
                              failures=self.failures, restarts=self.restarts,
                              op_counters=op_counters, groups=groups,
                              queue_depths=qdepth, wire=wire,
                              store=self.store, recovery_modes=modes)

    # -- deprecated accessors (shims over metrics()) --------------------
    #: the legacy ``op_stats_detail`` dict keys (rt.stats shape)
    _DETAIL_KEYS = ("events_in", "events_out", "txns", "recovered_resends",
                    "recovered_inputs", "recovery_scan_batches",
                    "batched_runs", "batched_events", "commit_us",
                    "send_stall_us")

    def process_stats(self) -> Dict[str, int]:
        """Deprecated: use ``Engine.metrics()`` (``ops[op].processed``)."""
        warnings.warn(
            "Engine.process_stats() is deprecated; use Engine.metrics() — "
            "MetricsSnapshot.ops[op].processed", DeprecationWarning,
            stacklevel=2)
        return {op: m.processed for op, m in self.metrics().ops.items()}

    def op_stats_detail(self) -> Dict[str, Dict[str, int]]:
        """Deprecated: use ``Engine.metrics()`` (``ops[op]`` fields)."""
        warnings.warn(
            "Engine.op_stats_detail() is deprecated; use Engine.metrics() "
            "— MetricsSnapshot.ops[op] carries the same counters as typed "
            "fields", DeprecationWarning, stacklevel=2)
        return {op: {k: getattr(m, k) for k in self._DETAIL_KEYS}
                for op, m in self.metrics().ops.items()}

    def wire_stats(self) -> Dict[str, float]:
        """Deprecated: use ``Engine.metrics()`` (``.transport``)."""
        warnings.warn(
            "Engine.wire_stats() is deprecated; use Engine.metrics() — "
            "MetricsSnapshot.transport (TransportMetrics)",
            DeprecationWarning, stacklevel=2)
        t = self.metrics().transport
        if not (t.frames or t.bytes or t.events or t.ctrl
                or t.ctrl_frames or t.extra):
            return {}
        out: Dict[str, float] = {
            "frames": t.frames, "bytes": t.bytes, "events": t.events,
            "ctrl": t.ctrl, "ctrl_frames": t.ctrl_frames, **dict(t.extra)}
        out["events_per_frame"] = t.events_per_frame
        out["ctrl_per_ctrl_frame"] = t.ctrl_per_ctrl_frame
        return out

    def wait(self, timeout: float = 60.0) -> bool:
        if self.protocol == "abs":
            return self._abs.wait(timeout)
        if self._proc is not None:
            return self._proc.wait(timeout)
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self._done.is_set():
                self._stop.set()
                return True
            if all(not t.is_alive() for t in self.threads.values()) \
                    and all(s != "dead" for s in self.group_state.values()):
                return True
            time.sleep(0.005)
        self._stop.set()
        return False

    def stop(self):
        self._stop.set()
        if self._proc is not None:
            self._proc.stop()
        self.store.flush()
        for ch in self.channels:
            ch.close()

    def replay(self, outputs, scope=None, *, mode: Optional[str] = None,
               depth: int = 64, timeout: float = 60.0, injector=None,
               check: bool = True):
        """Partial replay-from-lineage: rederive ``outputs`` (EventKeys or
        raw ``(op, port, ssn)`` tuples) by re-executing only the operators
        in their lineage slice, feeding logged source payloads back in.
        ``scope`` (a LineageScope) bounds the walk at its start operator.
        Runs on a fresh in-memory store in ``mode`` ("thread" default, or
        "process"); ``injector`` installs a FailureInjector in the replay
        run. Returns a :class:`repro_torch.core.replay.ReplayReport`; with
        ``check=True`` raises :class:`repro_torch.core.replay.ReplayMismatch`
        when a deterministic slice fails to reproduce byte-identically."""
        from repro_torch.core.replay import replay_from_log
        return replay_from_log(self, outputs, scope=scope, mode=mode,
                               depth=depth, timeout=timeout,
                               injector=injector, check=check)

    # ------------------------------------------------------------------
    # deterministic single-threaded mode (property tests)
    # ------------------------------------------------------------------
    def run_to_completion(self, max_steps: int = 200_000) -> bool:
        assert self.mode == "step"
        groups = sorted(set(self.pipeline.groups.values()))
        self._rq: List[str] = []        # ordered recovery queue

        def on_crash(group: str):
            self.failures += 1
            replay_groups = self._replay_cascade(group)
            self._build(first=False, only_group=group, restarted=True)
            for rg in replay_groups:
                self._build(first=False, only_group=rg, restarted=True)
                for oid in self.group_ops(rg):
                    self.ops[oid].state = "replay"
            self.restarts += 1
            # ordering: failed group recovers first (it marks the inputs it
            # needs as "replay" before the replay preds look for them)
            fresh = [o for o in self.group_ops(group)]
            for rg in replay_groups:
                fresh += self.group_ops(rg)
            self._rq = fresh + [o for o in self._rq if o not in fresh]

        for _ in range(max_steps):
            if self._done.is_set():
                return True
            # drain pending recoveries first (a recovery can crash too)
            if self._rq:
                oid = self._rq[0]
                op = self.ops.get(oid)
                try:
                    if op is not None and op.state in ("restarted", "replay"):
                        self._recover_op(op)
                    self._rq.pop(0)
                except SimulatedCrash:
                    on_crash(self.pipeline.groups[oid])
                continue
            progressed = False
            for g in groups:
                if self.group_state.get(g) in ("dead", "removed"):
                    continue
                crashed = False
                for op_id in self.group_ops(g):
                    op = self.ops.get(op_id)
                    if op is None:
                        continue
                    try:
                        if op.state in ("restarted", "replay"):
                            self._recover_op(op)
                            progressed = True
                        progressed |= self._step_op(op)
                    except SimulatedCrash:
                        on_crash(g)
                        progressed = True
                        crashed = True
                        break
                if crashed:
                    break

            def drain_all(force: bool) -> bool:
                any_released = False
                for rt in list(self.runtimes.values()):
                    try:
                        any_released |= rt.drain_durable(force=force)
                    except SimulatedCrash:
                        on_crash(self.pipeline.groups[rt.op.id])
                        any_released = True
                return any_released

            progressed |= drain_all(force=False)
            self.store.maybe_checkpoint()
            if not progressed:
                # push the durability watermark before concluding idleness
                if drain_all(force=True):
                    continue
                if self._sources_exhausted() and self._all_idle():
                    return True
                return self._done.is_set()
        return False
