"""Formal transport interfaces (Sec. 2.1's reliable FIFO channel contract).

The paper's correctness argument assumes a transport that is

  * **reliable** — an event put on a channel is never lost while any party
    that logged it as sent can still need it re-delivered;
  * **FIFO per channel** — events arrive at the receiver in put order;
  * **capacity back-pressured** — a sender blocks (abortably) when the
    receiver's credit window is exhausted, so no component buffers an
    unbounded number of in-flight events.

Three implementations satisfy the contract:

``local``   (:mod:`repro_torch.core.transport.local`) — the in-thread/in-process
            :class:`Channel`: one shared buffer is both endpoints, capacity
            blocking *is* the credit window (used by thread and step mode,
            and for intra-group edges inside process-mode workers).
``routed``  (:mod:`repro.core.transport.routed`) — the supervisor-pumped
            pipe transport of process mode: the authoritative buffer lives
            in the supervisor, workers hold replicas, and senders spend
            explicit credits granted by the supervisor (returned when an
            event leaves the authoritative buffer at ack/release time).
``socket``  (:mod:`repro.core.transport.socketmode`) — direct worker-to-
            worker socket channels: the *sender-side worker* holds the
            reliable buffer (bounded at the credit window; acks returning
            over the socket are the credit grants) and event payloads
            bypass the supervisor entirely.  The supervisor retains only
            the authoritative *recovery* view: buffer contents are
            re-derivable from the log on restart, so a lost buffer is
            repaired by the protocol's resend path (Alg 6/7).

Credit protocol (all transports)
--------------------------------
Every channel has a credit window ``W`` (= its configured capacity).  The
invariant is ``buffered + credits_held_by_sender <= W`` where *buffered*
counts every event not yet released (deferred acks keep occupying their
credit until ``release_ack`` — the durability-watermark rule).  A sender
out of credits blocks FIFO and abortably: engine stop, channel close, or a
``stop_flag`` wake it with ``put() == False``.  On a warm restart the
window is recomputed from the surviving buffer (routed: the supervisor
re-grants ``W - len(buffer)`` to the fresh sender incarnation; socket: the
fresh sender's buffer is rebuilt from the log resend, implicitly resetting
the window), so a SIGKILL'd receiver never strands a sender.
"""
from __future__ import annotations

import abc
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple


class ChannelEndpoint(abc.ABC):
    """The channel verbs the operator runtime and the engine consume.

    ``peek``/``ack`` carry the Sec. 2.1 receive contract (an event leaves
    the channel only once acknowledged); ``defer_ack``/``release_ack`` are
    the durability-watermark split used by group-commit pipelining;
    ``reset_pending`` is the receiver-restart rewind.
    """

    send_op: str
    send_port: str
    rec_op: str
    rec_port: str
    capacity: int

    @property
    def name(self) -> str:
        return f"{self.send_op}.{self.send_port}->{self.rec_op}.{self.rec_port}"

    # -- sender side -------------------------------------------------------
    @abc.abstractmethod
    def put(self, ev, stop_flag: Optional[Callable[[], bool]] = None,
            timeout: float = 0.05) -> bool:
        """Blocking, credit-gated put. False = aborted (stop/close)."""

    # -- receiver side -----------------------------------------------------
    @abc.abstractmethod
    def peek(self):
        """Head of the unprocessed suffix (skips deferred-ack events)."""

    @abc.abstractmethod
    def ack(self):
        """Immediately consume the event ``peek`` returned."""

    @abc.abstractmethod
    def defer_ack(self) -> None:
        """Mark the head processed-but-unreleased (still holds its credit)."""

    @abc.abstractmethod
    def release_ack(self):
        """Release the oldest deferred ack (FIFO); returns its credit."""

    @abc.abstractmethod
    def reset_pending(self) -> None:
        """Receiver restart: unreleased events become deliverable again."""

    # -- vectored receiver verbs (micro-batching) --------------------------
    # Defaults degrade to the scalar verbs so every endpoint is correct;
    # implementations override to amortize locks / control messages when a
    # run of events is consumed in one pass.
    def peek_run(self, n: int) -> list:
        """Up to ``n`` events from the head of the unprocessed suffix (FIFO
        snapshot; nothing is consumed until acked/deferred)."""
        ev = self.peek()
        return [ev] if n > 0 and ev is not None else []

    def ack_run(self, n: int) -> int:
        """Vectored ``ack``; returns the count actually consumed."""
        k = 0
        while k < n and self.ack() is not None:
            k += 1
        return k

    def defer_run(self, n: int) -> int:
        """Vectored ``defer_ack``; returns the count actually deferred."""
        for _ in range(n):
            self.defer_ack()
        return n

    @abc.abstractmethod
    def __len__(self) -> int:
        """Events occupying credits (buffered, including deferred)."""


# ---------------------------------------------------------------------------
# spawn-safe worker bootstrap
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Picklable description of one channel — what a worker transport needs
    to rebuild its endpoints without touching the live (unpicklable)
    supervisor-side :class:`~repro_torch.core.transport.local.Channel` objects."""

    send_op: str
    send_port: str
    rec_op: str
    rec_port: str
    capacity: int

    @property
    def name(self) -> str:
        return f"{self.send_op}.{self.send_port}->{self.rec_op}.{self.rec_port}"


@dataclasses.dataclass
class WorkerBootstrap:
    """Everything a worker process needs to rebuild its operator group —
    picklable by stdlib :mod:`pickle`, so a worker can start under the
    ``spawn`` multiprocessing context (or, in principle, an ``ssh`` /
    container entrypoint) and never relies on fork-inherited parent
    memory.  Recovery state is NOT here: the worker rebuilds volatile
    operator state purely from this payload plus the shared log (over the
    store RPC).

    ``factories`` holds only this group's operator factories; under
    ``spawn`` they must be picklable (module-level callables /
    ``functools.partial`` — no closures).  ``control`` is the supervisor's
    rendezvous for workers launched by a node agent: ``((host, port),
    authkey)`` of the control hub; such workers dial back their RPC and
    transport connections instead of inheriting pipes.
    """

    group: str
    incarnation: int
    recover: bool
    transport: str
    transport_options: Dict[str, Any]
    factories: Dict[str, Callable]
    connections: List[Tuple[str, str, str, str, int]]
    groups: Dict[str, str]
    lineage_ports: Dict[str, Tuple]
    replay_ops: frozenset
    control: Optional[Tuple[Any, bytes]] = None
    #: batching-governor spec for the group's receivers ("off" | "adaptive"
    #: | int); None defers to the LOGIO_BATCH env var in the worker
    batching: Optional[Any] = None
    #: per-group recovery-mode payload: ``{"modes": {group: "epoch"},
    #: "stale": [groups], "interval": N}`` — groups in "epoch" mode run
    #: interval state snapshotting and recover with the DONE-inclusive
    #: scan; "stale" marks groups freshly switched off epoch whose next
    #: recovery must still include DONE rows.  None (old payloads) means
    #: every group is in "log" mode.
    recovery: Optional[Dict[str, Any]] = None

    @property
    def channels(self) -> List[ChannelSpec]:
        return [ChannelSpec(s, sp, d, dp, cap)
                for (s, sp, d, dp, cap) in self.connections]

    def group_ops(self) -> List[str]:
        return [o for o, g in self.groups.items() if g == self.group]


class Placement:
    """Group -> node assignment for process mode.  ``None`` means "spawn a
    direct child of the supervisor" (the single-host default); a node name
    means "launch via that node's agent" (:class:`repro.core.cluster`
    resolves names to agent processes).  Mutable so dynamic scaling can
    place new replicas (`assign`) before ``start_group`` spawns them."""

    def __init__(self, mapping: Optional[Dict[str, Optional[str]]] = None,
                 default: Optional[str] = None):
        self._map: Dict[str, Optional[str]] = dict(mapping or {})
        self._default = default

    def node_of(self, group: str) -> Optional[str]:
        return self._map.get(group, self._default)

    def assign(self, group: str, node: Optional[str]) -> None:
        self._map[group] = node

    def nodes(self):
        return sorted({n for n in list(self._map.values()) + [self._default]
                       if n is not None})


class WorkerTransport(abc.ABC):
    """Worker-process half of a process-mode transport.

    Built once per worker incarnation (in the worker process, from its
    :class:`WorkerBootstrap`); owns the worker's channel endpoints and
    whatever control plumbing the implementation needs (the routed pipe
    pump, the socket listener/reader threads).
    """

    #: channel name -> endpoint for every channel touching this group
    channels: Dict[str, ChannelEndpoint]
    #: set once the supervisor asked this worker to stop
    stopped: bool

    @abc.abstractmethod
    def pump(self, timeout: float) -> None:
        """Drain pending control/delivery messages (main-loop tick)."""

    def begin_step(self) -> None:
        """Main-loop iteration starts: effects of consumption verbs may be
        pending in-step and invisible to any buffer until ``boundary``
        publishes again (socket-mode termination needs the flag)."""

    @abc.abstractmethod
    def take_force(self) -> bool:
        """True once per supervisor force-drain request (end of stream)."""

    @abc.abstractmethod
    def boundary(self, state: dict) -> None:
        """Main-loop iteration boundary: publish a consistent snapshot of
        ``state`` (termination detection must only ever observe states
        taken between protocol steps, never mid-transaction)."""

    @abc.abstractmethod
    def report_idle(self, state: dict) -> None:
        """The loop made no progress; tell the supervisor (deduplicated)."""

    @abc.abstractmethod
    def send_stats(self, stats: dict) -> None:
        """Forward cumulative per-operator counters to the supervisor."""


class SupervisorTransport(abc.ABC):
    """Supervisor-process half of a process-mode transport.

    The :class:`~repro.core.procmode.ProcessEngineDriver` owns worker
    lifecycle (fork, death detection, restart policy) and delegates every
    transport concern here.
    """

    name: str

    def __init__(self, driver):
        self.driver = driver

    @abc.abstractmethod
    def tr_loop(self, handle) -> None:
        """Thread body draining one worker's transport pipe."""

    def on_spawn_locked(self, handle) -> list:
        """Called by the driver inside the spawn critical section (driver
        lock held, incarnation just bumped).  Return the messages that
        establish the fresh incarnation's view — e.g. its initial credit
        windows, which must be computed atomically with the incarnation
        bump so no concurrent per-event grant double-counts a buffer pop.
        The driver sends them (incarnation-pinned) after releasing the
        lock."""
        return []

    @abc.abstractmethod
    def on_spawned(self, handle) -> None:
        """A worker (re)spawned (spawn critical section released): start
        delivery — pump the undelivered suffix / broker addresses."""

    @abc.abstractmethod
    def before_respawn(self, handle) -> None:
        """A worker died: rewind delivery cursors / drop stale peer state
        so the fresh incarnation re-derives its view (called before the
        new fork, with the driver's restart locks held)."""

    @abc.abstractmethod
    def check_done(self) -> bool:
        """Sound termination detection across all workers + buffers."""

    @abc.abstractmethod
    def wait_group_drained(self, group: str, timeout: float) -> bool:
        """Block until no event involving ``group`` is buffered/in flight
        (dynamic scaling must not delete a channel that still carries a
        logged-and-sent event)."""

    @abc.abstractmethod
    def after_rewire(self) -> None:
        """Topology changed (Algs 12-13): refresh routing, re-deliver."""

    @abc.abstractmethod
    def reinject(self, ev) -> None:
        """Supervisor-side re-send of a reassigned event (Alg 13 step
        1.d).  Routed appends to the authoritative buffer; socket is a
        no-op — the restarted dispatcher's recovery resends from the log."""

    def sync_channels(self) -> None:
        """The driver re-indexed the engine's channels (start / scaling);
        refresh any per-channel transport state."""

    def request_stop(self) -> None:
        """Engine stop: release any transport-held resources."""


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

#: transport name -> (supervisor factory, worker factory); ``local`` has no
#: process halves — thread/step mode use :class:`Channel` directly. The
#: process transports of ``repro.core.transport`` (routed, socket, tcp, shm)
#: register here once the process-mode slice ports them; until then it
#: stays empty.
_REGISTRY: Dict[str, Any] = {}


def register_transport(name: str, supervisor_factory, worker_factory):
    _REGISTRY[name] = (supervisor_factory, worker_factory)


def transport_names():
    return sorted(_REGISTRY) + ["local"]


def process_transport_names():
    """Names valid for ``Engine(mode="process", transport=...)`` — every
    registered process transport (``local`` has no process halves)."""
    return sorted(_REGISTRY)


def make_supervisor_transport(name: str, driver) -> SupervisorTransport:
    if name not in _REGISTRY:
        raise ValueError(f"unknown process transport {name!r} "
                         f"(have {transport_names()})")
    return _REGISTRY[name][0](driver)


def make_worker_transport(name: str, bootstrap: "WorkerBootstrap",
                          group: str, tr_conn) -> WorkerTransport:
    if name not in _REGISTRY:
        raise ValueError(f"unknown process transport {name!r} "
                         f"(have {transport_names()})")
    return _REGISTRY[name][1](bootstrap, group, tr_conn)
