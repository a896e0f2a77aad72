"""Elastic scaling on the PyTorch port's engine (Sec. 7.2, Algorithms
12-13): scale a bottleneck operator from 2 replicas to 3 under load, then
down to 1 while a replica fails — without stopping the pipeline and without
losing or duplicating a single event.

    PYTHONPATH=src python examples/torch_elastic_scaling.py

The same pipeline, sleeps and prints as ``examples/elastic_scaling.py``, on
``repro_torch.core`` (pure Python: no device, no torch import).
"""
import time

from repro_torch.core import (Engine, FailureInjector, GeneratorSource,
                              MapOperator, Pipeline, ReadSource, TerminalSink)
from repro_torch.core.scaling import (Controller, DispatcherOperator,
                                      MergerOperator)

N = 120


def build():
    p = Pipeline()
    p.add(lambda: GeneratorSource(
        "src", ReadSource([{"v": i} for i in range(N)]), rate=0.002))
    p.add(lambda: DispatcherOperator("disp", ["r0", "r1"]))
    for rid in ("r0", "r1"):
        p.add(lambda rid=rid: MapOperator(
            rid, fn=lambda b: {"v": b["v"] * 2}, processing_time=0.006))
    p.add(lambda: MergerOperator("mrg", ["r0", "r1"]))
    p.add(lambda: TerminalSink("sink", target=N))
    p.connect("src", "out", "disp", "in")
    p.connect("disp", "to_r0", "r0", "in")
    p.connect("disp", "to_r1", "r1", "in")
    p.connect("r0", "out", "mrg", "from_r0")
    p.connect("r1", "out", "mrg", "from_r1")
    p.connect("mrg", "out", "sink", "in")
    return p


def main():
    """Runs the demo; returns the engine and the committed values, sorted."""
    inj = FailureInjector([("r0", "post_log", 25)])   # r0 dies mid-run
    eng = Engine(build(), mode="thread", injector=inj, restart_delay=0.02)
    ctrl = Controller(eng, "disp", "mrg",
                      replica_factory=lambda rid: (lambda: MapOperator(
                          rid, fn=lambda b: {"v": b["v"] * 2},
                          processing_time=0.006)))
    eng.start()
    time.sleep(0.10)
    print("scaling UP: adding replica r2 (Algorithm 12)")
    ctrl.scale_up("r2")
    time.sleep(0.15)
    print("scaling DOWN: removing replica r1 (Algorithm 13 — its pending "
          "events are atomically reassigned)")
    ctrl.scale_down("r1")
    assert eng.wait(60), "did not drain"
    eng.stop()
    got = sorted(b["v"] for b in eng.external.committed())
    expect = sorted(2 * i for i in range(N))
    print(f"replica failure mid-run: {eng.failures} failure(s), "
          f"{eng.restarts} restart(s)")
    print(f"exactly-once across scale-up + scale-down + failure: "
          f"{got == expect} ({len(got)} events)")
    assert got == expect
    return {"engine": eng, "got": got}


if __name__ == "__main__":
    main()
