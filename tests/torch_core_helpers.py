"""Pipeline builders, stores and table dumps for the port's engine tests.

Every builder takes the core package it builds from (``repro.core`` or
``repro_torch.core``), so one scenario runs through both packages from the
same inputs. The builders mirror ``tests/helpers.py``.

The module imports neither torch nor anything of ``repro``, and every
factory is a module-level callable or a ``functools.partial`` of one: a
process-mode worker started by ``spawn`` (or by a ``LocalCluster`` node
agent) unpickles its operators from here and loads only the package the
test runs on.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import sys
import tempfile
import threading
import time
from functools import partial

#: The store stacks of the ``"all"`` set in ``tests/conftest.py``, listed
#: here so that every case runs over the durable stacks too.
ALL_STACKS = ["memory", "memory+sharded", "memory+group",
              "memory+sharded+group", "sqlite", "sqlite+group", "segment",
              "segment+group", "sqlite+sharded+group",
              "segment+sharded+group"]


def double_v(b):
    return {"v": b["v"] * 2}


def win_sum(bs):
    return {"s": sum(b["v"] for b in bs)}


def _fast_fn(b):
    return {"v": b["v"] + 1}


def _slow_fn(b):
    return {"v": b["v"] * 10}


def _join_agg(a, b):
    return {"sa": sum(x["v"] for x in a),
            "sb": sum(x["v"] for x in b)}


def mk_store(core, spec: str, root=None, **kw):
    """``build_store`` of ``core`` with a fresh path under ``root`` for the
    durable specs. Segment specs get a small segment size and checkpoint
    interval, so rotation and compaction run under the whole matrix."""
    from importlib import import_module
    ls = import_module(core.__name__ + ".logstore")
    if spec.startswith(("sqlite", "segment")) and "path" not in kw:
        assert root is not None, f"{spec} needs a directory"
        os.makedirs(root, exist_ok=True)
        kw["path"] = os.path.join(tempfile.mkdtemp(dir=root), "log")
    if spec.startswith("segment"):
        kw.setdefault("segment_bytes", 32 * 1024)
        kw.setdefault("checkpoint_interval", 25)
        return ls.build_store(ls.StoreConfig.parse(spec, **kw))
    return ls.build_store(spec, **kw)


def linear_pipeline(core, n_events: int = 20, window: int = 4,
                    sink_target: int = 5, writes: int = 0,
                    rate: float = 0.0):
    """src -> map(x2) -> win(sum of window) -> sink."""
    def build():
        p = core.Pipeline()
        p.add(partial(core.GeneratorSource, "src",
                      core.ReadSource([{"v": i} for i in range(n_events)]),
                      rate=rate))
        p.add(partial(core.MapOperator, "map", fn=double_v))
        p.add(partial(core.CountWindowOperator, "win", window, agg=win_sum,
                      writes_per_output=writes))
        p.add(partial(core.TerminalSink, "sink", target=sink_target))
        p.connect("src", "out", "map", "in")
        p.connect("map", "out", "win", "in")
        p.connect("win", "out", "sink", "in")
        return p
    expected = [{"s": sum(2 * j for j in range(i * window, (i + 1) * window))}
                for i in range(sink_target)]
    return build, expected


def diamond_pipeline(core, n_events: int = 30, n1: int = 6, n2: int = 3,
                     sink_target: int = 5):
    """src fans out to fast/slow branches joined by a synchronized operator
    (UC2 topology)."""
    def build():
        p = core.Pipeline()
        p.add(partial(core.GeneratorSource, "src",
                      core.ReadSource([{"v": i} for i in range(n_events)])))
        p.add(partial(core.MapOperator, "fast", fn=_fast_fn))
        p.add(partial(core.MapOperator, "slow", fn=_slow_fn))
        p.add(partial(core.SyncJoinOperator, "join", n1, n2, agg=_join_agg))
        p.add(partial(core.TerminalSink, "sink", target=sink_target))
        p.connect("src", "out", "fast", "in")
        p.connect("src", "out", "slow", "in")
        p.connect("fast", "out", "join", "in1")
        p.connect("slow", "out", "join", "in2")
        p.connect("join", "out", "sink", "in")
        return p
    expected = [
        {"sa": sum(j + 1 for j in range(i * n1, (i + 1) * n1)),
         "sb": sum(j * 10 for j in range(i * n2, (i + 1) * n2))}
        for i in range(sink_target)]
    return build, expected


def mk_replica(core, rid):
    """Picklable replica factory for the scaling cases."""
    return partial(core.MapOperator, rid, fn=double_v, processing_time=0.004)


def gated_delay(gate: str, hold: int, rate: float, offset: int) -> float:
    """A ``GeneratorSource`` ``rate_fn``: ``rate`` for every event, but from
    offset ``hold`` on only once the file ``gate`` exists (until then it
    waits), so a test can hold a source, in whatever process it runs,
    until the test has done what must come before the rest of the stream."""
    while offset >= hold and not os.path.exists(gate):
        time.sleep(0.002)
    return rate


def replica_pipeline(core, n, rate=0.002, rate_fn=None):
    """src -> disp -> {r0, r1} -> mrg -> sink, as a picklable builder
    (``rate_fn``: the source's, e.g. a ``partial`` of ``gated_delay``)."""
    from importlib import import_module
    sc = import_module(core.__name__ + ".scaling")

    def build():
        p = core.Pipeline()
        p.add(partial(core.GeneratorSource, "src",
                      core.ReadSource([{"v": i} for i in range(n)]),
                      rate=rate, rate_fn=rate_fn))
        p.add(partial(sc.DispatcherOperator, "disp", ["r0", "r1"]))
        p.add(mk_replica(core, "r0"))
        p.add(mk_replica(core, "r1"))
        p.add(partial(sc.MergerOperator, "mrg", ["r0", "r1"]))
        p.add(partial(core.TerminalSink, "sink", target=n))
        p.connect("src", "out", "disp", "in")
        p.connect("disp", "to_r0", "r0", "in")
        p.connect("disp", "to_r1", "r1", "in")
        p.connect("r0", "out", "mrg", "from_r0")
        p.connect("r1", "out", "mrg", "from_r1")
        p.connect("mrg", "out", "sink", "in")
        return p
    return build


def ident(b):
    return b


def modules_probe(b):
    """A map function that reports what its process has imported."""
    mods = list(sys.modules)
    return {"v": b["v"],
            "torch": any(m == "torch" or m.startswith("torch.")
                         for m in mods),
            "repro": any(m == "repro" or m.startswith("repro.")
                         for m in mods),
            "pid": os.getpid()}


def wait_for(cond, timeout=60.0, what="progress"):
    """Poll ``cond`` until it holds; fail loudly after ``timeout``."""
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"no {what} in {timeout}s"
        time.sleep(0.002)


class FileExternalSystem:
    """Durable external system backed by an append-only file (a copy of
    ``tests.helpers.FileExternalSystem`` that imports nothing of
    ``repro``): it survives a ``kill -9`` of the whole engine. A torn final
    record is ignored."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self.writes = {}
        self.order = []
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
                    pickle.dump((k, body), f)
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


def sink_outputs(engine):
    return [b for b in engine.external.committed()
            if not (isinstance(b, dict) and "inset" in b)]


def window_writes(engine):
    return [b for b in engine.external.committed()
            if isinstance(b, dict) and "inset" in b]


def tables(store):
    """The rows a store holds, as plain data: EVENT_LOG (the event rows
    and, keyed by an input set, the input-set rows), EVENT_DATA payloads,
    lineage rows and read actions, merged over shards."""
    images = ([s.image() for s in store.shards] if hasattr(store, "shards")
              else [store.image()])
    events, data, lineage, reads = {}, {}, [], {}
    for im in images:
        with im.lock:
            events.update({k: dict(r) for k, r in im.event_log.items()})
            data.update({k: im._load_blob(v)
                         for k, v in im.event_data.items()})
            lineage += list(im.lineage)
            reads.update({k: dict(r) for k, r in im.read_actions.items()})
    return {"events": {k: v for k, v in events.items() if k[4] is None},
            "insets": {k: v for k, v in events.items() if k[4] is not None},
            "data": data, "lineage": sorted(lineage), "reads": reads}


def plain(x):
    """Query results, slices and replay reports as plain data, so results
    of the two packages (whose classes differ) compare with ``==``: an
    ``EventKey`` becomes its tuple, any other dataclass its class name and
    fields."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        if type(x).__name__ == "EventKey":
            return x.astuple()
        return (type(x).__name__,
                {f.name: plain(getattr(x, f.name))
                 for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {plain(k): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, frozenset, set)):
        return type(x)(plain(v) for v in x)
    return x
