#!/usr/bin/env python3
"""The torch-free half of ``chip_smoke.py``'s engine phases (13 and 13b):
UC1's pipeline, its exactly-once check, and the runs of phase 13b that
start processes by ``spawn`` or in a session of their own.

A process started by ``spawn`` re-executes its parent's main script before
it unpickles its work. So the spawn-context runs (a worker per group under
``ctx="spawn"``, the ``LocalCluster``'s node agents and their workers) and
the whole-engine ``kill -9`` child run in an interpreter whose main script
is this file, which imports the standard library and ``repro_torch.core``
only: no torch, and nothing of ``chip_smoke.py``. ``chip_smoke.py`` imports
the rest from here and runs them in its own process.

    python3 chip_engine.py spawn-runs DIR        # phase 13b's spawn runs
    python3 chip_engine.py child SPEC PATH EXT   # UC1 until killed

Both are run by ``chip_smoke.py``; each prints what it measured, and
``spawn-runs`` ends with a ``RESULT {json}`` line.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# UC1 (benchmarks/uc1.py:13-40): OP1 source -> OP2 map -> OP3 count window
# -> OP4 count window with one external write per output -> OP5 sink; 1,000
# events of 10 KB (UC1's kb=10, the "1000ev" case of
# benchmarks/lineage_overhead.py)
ENGINE_EVENTS, ENGINE_KB = 1000, 10.0
ENGINE_WINDOWS = (2, 100)                 # OP3's and OP4's windows
ENGINE_PLAN = [("OP3", "post_log", 300), ("OP4", "pre_write", 2)]

def _uc1_ident(b):
    return b


def _uc1_op3(bs):
    return {"n": len(bs), "i": sum(b["i"] for b in bs)}


def _uc1_op4(bs):
    return {"n": sum(b["n"] for b in bs), "i": sum(b["i"] for b in bs)}


def uc1_pipeline(core, n_events: int = ENGINE_EVENTS, rate: float = 0.0,
                 op3_pt: float = 0.0):
    """UC1's topology from ``core``, and its failure-free OP4 outputs: each
    holds the count and the sum of the indices of the source events of its
    window, so a lost or doubled event shows. ``rate`` paces the source
    (seconds an event) and ``op3_pt`` makes OP3 a straggler (seconds an
    output). Every factory is a partial of a module-level callable, so a
    spawned worker rebuilds it."""
    blob = bytes(int(ENGINE_KB * 1024))
    events = [{"i": i, "data": blob} for i in range(n_events)]
    w3, w4 = ENGINE_WINDOWS
    span = w3 * w4

    def build():
        p = core.Pipeline()
        p.add(functools.partial(core.GeneratorSource, "OP1",
                                core.ReadSource(events), rate=rate))
        p.add(functools.partial(core.MapOperator, "OP2", fn=_uc1_ident))
        p.add(functools.partial(core.CountWindowOperator, "OP3", w3,
                                agg=_uc1_op3, processing_time=op3_pt))
        p.add(functools.partial(core.CountWindowOperator, "OP4", w4,
                                agg=_uc1_op4, writes_per_output=1))
        p.add(functools.partial(core.TerminalSink, "OP5",
                                target=n_events // span))
        p.connect("OP1", "out", "OP2", "in")
        p.connect("OP2", "out", "OP3", "in")
        p.connect("OP3", "out", "OP4", "in")
        p.connect("OP4", "out", "OP5", "in")
        return p
    expected = [{"n": span, "i": sum(range(k * span, (k + 1) * span))}
                for k in range(n_events // span)]
    return build, expected


def exactly_once(eng, expected, what: str) -> None:
    """The committed outputs are the failure-free ones, in order, each
    once, and OP4 made one distinct external write per output."""
    committed = eng.external.committed()
    outs = [b for b in committed if not (isinstance(b, dict) and "inset" in b)]
    writes = {b["inset"] for b in committed
              if isinstance(b, dict) and "inset" in b}
    check(outs == expected, f"engine {what}: outputs {outs} != {expected}")
    check(len(writes) == len(expected),
          f"engine {what}: {len(writes)} external writes for "
          f"{len(expected)} outputs")


def uc1_run(core, build, expected, what: str, *, store=None, plan=(),
            mode: str = "thread", timeout: float = 120.0, **kw):
    """One run of ``build``; returns (wall seconds, engine) after checking
    exactly-once delivery."""
    eng = core.Engine(build(), store=store if store is not None else "memory",
                      mode=mode, injector=core.FailureInjector(list(plan)),
                      restart_delay=0.01, **kw)
    t0 = time.perf_counter()
    if mode == "step":
        ok = eng.run_to_completion()
    else:
        eng.start()
        ok = eng.wait(timeout)
        eng.stop()
    wall = time.perf_counter() - t0
    check(ok, f"engine {what}: the run did not complete")
    check(eng.failures == len(plan),
          f"engine {what}: {eng.failures} failures for a plan of {len(plan)}")
    exactly_once(eng, expected, what)
    return wall, eng


# the paced runs of phase 13b (the straggler, the controller, the cluster,
# the killed session): the source at 1 ms an event
PROC_RATE = 0.001
# the whole-engine kill lands once the external file holds this many
# records (of UC1's 10: 5 OP4 writes and 5 sink outputs)
PROC_KILL_AT = 4


class FileExternal:
    """A durable external system: an append-only file of pickled records,
    fsynced a record, that survives a ``kill -9`` of the whole engine. A
    torn last record (a kill mid-append) is ignored. In process mode it
    lives in the supervisor, which executes the workers' writes."""

    def __init__(self, path: str):
        import pickle
        import threading
        self.path, self._pickle = path, pickle
        self._lock = threading.Lock()
        self.writes, self.order = {}, []
        if os.path.exists(path):
            with open(path, "rb") as f:
                while True:
                    try:
                        k, body = pickle.load(f)
                    except (EOFError, pickle.UnpicklingError):
                        break
                    if k not in self.writes:
                        self.writes[k] = body
                        self.order.append(k)

    def execute(self, op_id, conn_id, event_id, body) -> bool:
        k = (op_id, conn_id, event_id)
        with self._lock:
            if k not in self.writes:
                with open(self.path, "ab") as f:
                    self._pickle.dump((k, body), f)
                    f.flush()
                    os.fsync(f.fileno())
                self.writes[k] = body
                self.order.append(k)
        return True

    def status(self, op_id, conn_id, event_id) -> str:
        with self._lock:
            return "success" if (op_id, conn_id, event_id) in self.writes \
                else "unknown"

    def committed(self):
        with self._lock:
            return [self.writes[k] for k in self.order]


def host_memory() -> str:
    """This process's resident host memory, and its peak where the kernel
    reports one (gVisor gives no VmHWM)."""
    info = {}
    with contextlib.suppress(OSError):
        for line in Path("/proc/self/status").read_text().splitlines():
            key, _, val = line.partition(":")
            if key in ("VmRSS", "VmHWM"):
                info[key] = f"{int(val.split()[0]) / 2**20:.2f} GiB"
    return (f"RSS {info.get('VmRSS', 'not reported')} (peak "
            f"{info.get('VmHWM', 'not reported')})")


def _proc_store(core, spec: str, path: str, **kw):
    if spec.startswith(("sqlite", "segment")):
        return core.build_store(spec, path=path, **kw)
    return core.build_store(spec, **kw)


def _uc1_replica(rid: str):
    """Picklable replica factory for the process-mode scaling run."""
    from repro_torch import core
    return functools.partial(core.MapOperator, rid, fn=_uc1_ident)


def engine_child(argv) -> int:
    """``chip_engine.py child SPEC PATH EXTERNAL``: run UC1 paced in process
    mode on the durable store at PATH, with the file external system at
    EXTERNAL, until the parent SIGKILLs the whole session."""
    from repro_torch import core
    spec, path, ext = argv
    build, _ = uc1_pipeline(core, rate=PROC_RATE)
    # no time-based flush: whatever the watermark has not flushed when the
    # kill lands is an unflushed (or uncommitted) epoch
    store = core.build_store(spec, path=path, interval=60.0)
    eng = core.Engine(build(), mode="process", store=store,
                      external=FileExternal(ext), transport="socket",
                      ctx="fork", restart_delay=0.01)
    eng.start()
    print("READY", flush=True)
    eng.wait(120)
    print("DONE", flush=True)
    time.sleep(120)      # hold the unflushed tail until the kill
    return 0


def _epochs(path: str):
    """(committed epoch ids, epoch ids of the shards' WAL rows) of a
    sqlite+sharded+group store's files."""
    import sqlite3
    committed, rows = set(), []
    if os.path.exists(f"{path}.epochs"):
        conn = sqlite3.connect(f"{path}.epochs")
        with contextlib.closing(conn):
            committed = {r[0] for r in conn.execute(
                "SELECT epoch_id FROM epochs")}
    for i in range(8):
        if os.path.exists(f"{path}.shard{i}"):
            conn = sqlite3.connect(f"{path}.shard{i}")
            with contextlib.closing(conn):
                rows += [r[0] for r in conn.execute(
                    "SELECT epoch FROM wal_ops WHERE epoch IS NOT NULL")]
    return committed, rows


def phase_engine_kill9(core, spec: str, tmp: str, build, expected) -> dict:
    """Run UC1 in a child session (``engine_child``), SIGKILL the whole
    session once the external file holds PROC_KILL_AT records, reopen the
    store (an uncommitted epoch rolls back), check that every epoch-tagged
    row left belongs to a committed epoch, and resume exactly once."""
    import signal
    path, ext = f"{tmp}/kill-{spec}", f"{tmp}/kill-{spec}.ext"
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "child", spec, path,
         ext], stdout=subprocess.PIPE, start_new_session=True)
    try:
        check(proc.stdout.readline().strip() == b"READY",
              f"engine kill -9 {spec}: the child did not start")
        deadline = time.monotonic() + 120
        while len(FileExternal(ext).committed()) < PROC_KILL_AT:
            check(time.monotonic() < deadline and proc.poll() is None,
                  f"engine kill -9 {spec}: no progress in the child")
            time.sleep(0.005)
    finally:
        with contextlib.suppress(ProcessLookupError):
            os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
        proc.wait()
        proc.stdout.close()
    before = len(FileExternal(ext).committed())
    res = {"committed_before": before}
    if "sharded" in spec:
        committed, rows = _epochs(path)
        res["uncommitted_rows_at_kill"] = sum(e not in committed
                                              for e in rows)
    store = core.build_store(spec, path=path, interval=60.0)
    if "sharded" in spec:
        committed, rows = _epochs(path)
        check(all(e in committed for e in rows),
              f"engine kill -9 {spec}: rows of an uncommitted epoch survive "
              f"the reopen")
        res["epoch_rows"], res["epochs"] = len(rows), len(committed)
    wall, eng = uc1_run(core, build, expected, f"{spec} kill -9 resumed",
                        store=store, mode="process", transport="socket",
                        ctx="fork", external=FileExternal(ext), resume=True)
    store.close()
    res["resume_ms"] = wall * 1e3
    return res


def crash_plan_run(core, spec: str, transport: str, ctx: str,
                   tmp: str) -> dict:
    """UC1 under ENGINE_PLAN in process mode on ``spec``, a thread-mode run
    on a store of the same kind just before it; both exactly once. Prints
    and returns wall ms, events/s, failures, restarts, the overhead on
    thread mode and the wire's frames."""
    n = ENGINE_EVENTS
    build, expected = uc1_pipeline(core)
    what = f"{spec} {transport} {ctx}"
    store = _proc_store(core, spec, f"{tmp}/{spec}-{transport}-{ctx}-t")
    t_wall, _ = uc1_run(core, build, expected, f"{spec} thread",
                        store=store, plan=ENGINE_PLAN)
    store.close()
    store = _proc_store(core, spec, f"{tmp}/{spec}-{transport}-{ctx}-p")
    wall, eng = uc1_run(core, build, expected, what, store=store,
                        plan=ENGINE_PLAN, mode="process",
                        transport=transport, ctx=ctx)
    store.close()
    tm = eng.metrics().transport
    log(f"engine process {what}: {wall * 1e3:.1f} ms, {n / wall:.0f} ev/s, "
        f"failures {eng.failures}, restarts {eng.restarts}; thread mode "
        f"{t_wall * 1e3:.1f} ms just before ({100 * (wall / t_wall - 1):+.1f}"
        f"%); wire frames {tm.frames} ({tm.events_per_frame:.1f} events a "
        f"frame)")
    return {"wall_ms": wall * 1e3, "events_per_s": n / wall,
            "failures": eng.failures, "restarts": eng.restarts,
            "thread_ms": t_wall * 1e3, "overhead": wall / t_wall - 1,
            "frames": tm.frames, "events_per_frame": tm.events_per_frame}


def spawn_runs(tmp: str) -> dict:
    """Phase 13b's spawn-context runs, in this script's interpreter: UC1
    under the crash plan on the routed transport with ``ctx="spawn"`` (a
    thread-mode run on the same store just before), and a two-node
    ``LocalCluster`` over tcp with node1 killed mid-run and its groups
    warm-restarted on a fresh agent."""
    from repro_torch import core
    n = ENGINE_EVENTS
    _, expected = uc1_pipeline(core)
    spec = "sqlite+sharded+group"
    out = {"run": crash_plan_run(core, spec, "routed", "spawn", tmp)}
    # a two-node LocalCluster over tcp: node1 (OP3-OP5) killed mid-run
    cbuild, _ = uc1_pipeline(core, rate=PROC_RATE)
    cluster = core.LocalCluster(2)
    eng = core.Engine(cbuild(), mode="process", ctx="spawn",
                      transport="tcp", cluster=cluster,
                      placement={"OP1": "node0", "OP2": "node0",
                                 "OP3": "node1", "OP4": "node1",
                                 "OP5": "node1"},
                      store=_proc_store(core, spec, f"{tmp}/cluster"),
                      restart_delay=0.01)
    t0 = time.perf_counter()
    eng.start()
    deadline = time.monotonic() + 120
    while eng.metrics().op("OP3").processed < n // 5:
        check(time.monotonic() < deadline,
              "engine cluster: OP3 never reached n/5")
        time.sleep(0.005)
    boot = time.perf_counter() - t0
    before = eng.metrics().op("OP1").processed
    cluster.kill_node("node1")
    check(cluster.wait_node_dead("node1"), "engine cluster: node1 lives")
    ok = eng.wait(180)
    wall = time.perf_counter() - t0
    eng.stop()
    eng.store.close()
    check(ok and eng.failures >= 3, f"engine cluster: ok {ok}, failures "
          f"{eng.failures} (node1 holds three groups)")
    exactly_once(eng, expected, "cluster")
    out["cluster"] = {"wall_ms": wall * 1e3, "boot_ms": boot * 1e3,
                      "failures": eng.failures, "source_at_kill": before}
    return out


def main(argv) -> int:
    if argv[:1] == ["child"] and len(argv) == 4:
        return engine_child(argv[1:])
    if argv[:1] == ["spawn-runs"] and len(argv) == 2:
        print("RESULT " + json.dumps(spawn_runs(argv[1])), flush=True)
        return 0
    print(__doc__, file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
