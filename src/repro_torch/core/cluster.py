"""Node agents + the :class:`LocalCluster` harness (multi-host process mode).

A *node agent* is the per-machine half of a multi-host deployment: a tiny
process that connects to the supervisor's control hub (authkey-
authenticated TCP), receives picklable
:class:`~repro_torch.core.transport.base.WorkerBootstrap` payloads, and launches
one **spawn-context** worker process per payload.  The workers it starts
share nothing with the supervisor: they rebuild their operators from the
bootstrap + the log, dial their RPC/transport connections back to the hub,
and (under the ``tcp`` transport) exchange events over brokered
``(host, port)`` channels.  The agent also reports worker exits and
executes kill requests — the supervisor cannot signal a pid on another
machine.

:class:`LocalCluster` runs N such agents as "virtual hosts" on localhost.
Everything a real cluster deployment would exercise — bootstrap-only
worker starts, AF_INET channel brokering, per-node SIGKILL, whole-node
death and warm node restart, placing new replicas on other nodes — runs
against genuinely non-shared-memory processes, just without the network
between them.  ``kill_node`` SIGKILLs the agent's entire process group
(each agent calls ``setpgrp`` at birth, so its workers share its pgid):
the closest local analogue of pulling a machine's plug.

A production deployment would replace ``LocalCluster`` with an agent per
machine started from the same ``_agent_main`` entrypoint (the control-hub
address + authkey are its only inputs); nothing in the engine or the
transports distinguishes the two.
"""
from __future__ import annotations

import atexit
import multiprocessing
import os
import signal
import threading
import time
from multiprocessing import connection as mpc
from typing import Dict, List, Optional, Sequence, Union


def _agent_main(name: str, control_addr, authkey: bytes):
    """Node-agent entrypoint (runs in its own spawn-context process).

    Protocol (over the control-hub connection):
      supervisor -> agent: ("spawn", WorkerBootstrap) | ("kill", pid)
                           | ("stop",)
      agent -> supervisor: ("node", name, pid)           on connect
                           ("spawned", group, token, pid) per launch
                           ("exit", group, token, pid)    per worker death

    Losing the control connection is treated as supervisor death: the
    agent SIGKILLs its whole process group (itself + every worker it
    started) so no orphan pipelines outlive their supervisor.
    """
    os.setpgrp()          # workers inherit the pgid: one killpg = node dies
    from repro_torch.core.procmode import _worker_entry
    try:
        conn = mpc.Client(control_addr, authkey=authkey)
        conn.send(("node", name, os.getpid()))
    except (OSError, EOFError, multiprocessing.AuthenticationError):
        os._exit(1)
    ctx = multiprocessing.get_context("spawn")
    send_lock = threading.Lock()

    def send(msg):
        with send_lock:
            try:
                conn.send(msg)
            except (OSError, ValueError):
                pass

    def watch(proc, group, token):
        proc.join()
        send(("exit", group, token, proc.pid))

    while True:
        try:
            msg = conn.recv()
        except (EOFError, OSError):
            break                              # supervisor gone
        kind = msg[0]
        if kind == "spawn":
            bootstrap = msg[1]
            proc = ctx.Process(target=_worker_entry, args=(bootstrap,),
                               daemon=True,
                               name=f"logio-{bootstrap.group}")
            proc.start()
            send(("spawned", bootstrap.group, bootstrap.incarnation,
                  proc.pid))
            threading.Thread(
                target=watch,
                args=(proc, bootstrap.group, bootstrap.incarnation),
                daemon=True).start()
        elif kind == "kill":
            try:
                os.kill(msg[1], signal.SIGKILL)
            except ProcessLookupError:
                pass
        elif kind == "stop":
            break
    # take the whole process group down (this process included): workers
    # were either stopped by the supervisor already or must not outlive
    # their node
    try:
        os.killpg(os.getpgrp(), signal.SIGKILL)
    except OSError:
        os._exit(0)


class LocalCluster:
    """N "virtual hosts" on localhost: one node agent each, every worker a
    spawn-context process rebuilt purely from its bootstrap payload + the
    log.  Pass to ``Engine(mode="process", cluster=..., placement=...)``;
    the engine's driver starts the agents against its control hub and
    stops them on ``engine.stop()``.

    ``kill_node`` is the failure injector for whole-node death (SIGKILL of
    the agent's process group); the driver detects the lost control
    connection, and the next warm restart of the node's groups brings the
    agent back up via ``ensure_node`` — other nodes keep processing
    throughout (the paper's non-blocking recovery, across node
    boundaries)."""

    def __init__(self, nodes: Union[int, Sequence[str]] = 2):
        if isinstance(nodes, int):
            self.names: List[str] = [f"node{i}" for i in range(nodes)]
        else:
            self.names = list(nodes)
        self._ctx = multiprocessing.get_context("spawn")
        self._agents: Dict[str, multiprocessing.process.BaseProcess] = {}
        self._lock = threading.Lock()
        self._control: Optional[tuple] = None

    # -- driver-facing lifecycle -------------------------------------------
    def start(self, control_addr, authkey: bytes):
        with self._lock:
            self._control = (control_addr, authkey)
        # agents are non-daemonic (they launch workers) and the
        # multiprocessing atexit hook JOINS non-daemonic children: if the
        # supervisor process ever exits without engine.stop(), kill the
        # agents first (atexit is LIFO — this runs before mp's join)
        atexit.register(self.stop)
        for name in self.names:
            self.ensure_node(name)

    def ensure_node(self, name: str):
        """Start (or warm-restart) the node's agent if it is not running.
        Idempotent and thread-safe; the caller waits for the agent's
        control-hub hello, not for this method."""
        with self._lock:
            if self._control is None:
                raise RuntimeError("cluster not started by an engine yet")
            agent = self._agents.get(name)
            if agent is not None and agent.is_alive():
                return
            # agents must NOT be daemonic: daemonic processes cannot have
            # children, and launching workers is their whole job
            agent = self._ctx.Process(
                target=_agent_main,
                args=(name, self._control[0], self._control[1]),
                daemon=False, name=f"logio-node-{name}")
            agent.start()
            self._agents[name] = agent
            if name not in self.names:
                self.names.append(name)

    def stop(self):
        with self._lock:
            agents = dict(self._agents)
        for agent in agents.values():
            self._killpg(agent)
        for agent in agents.values():
            agent.join(timeout=5.0)

    # -- failure injection -------------------------------------------------
    def kill_node(self, name: str):
        """SIGKILL the node: agent + every worker it launched, no cleanup
        — the local analogue of a machine losing power."""
        with self._lock:
            agent = self._agents.get(name)
        if agent is not None:
            self._killpg(agent)
            agent.join(timeout=5.0)

    @staticmethod
    def _killpg(agent):
        if agent.pid is None:
            return
        try:
            # the agent called setpgrp, so its pid is the group's pgid
            os.killpg(agent.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError, OSError):
            try:
                agent.kill()
            except (ValueError, OSError):
                pass

    # -- introspection -----------------------------------------------------
    def alive_nodes(self) -> List[str]:
        with self._lock:
            return sorted(n for n, a in self._agents.items()
                          if a.is_alive())

    def wait_node_dead(self, name: str, timeout: float = 10.0) -> bool:
        deadline = time.time() + timeout
        while time.time() < deadline:
            with self._lock:
                agent = self._agents.get(name)
            if agent is None or not agent.is_alive():
                return True
            time.sleep(0.01)
        return False
