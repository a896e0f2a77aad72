"""Quickstart on the PyTorch port's engine: LOG.io in 60 lines — build a
pipeline, crash it twice, recover exactly-once, and ask lineage questions.

    PYTHONPATH=src python examples/torch_quickstart.py

The same pipeline, crash plan and prints as ``examples/quickstart.py``, on
``repro_torch.core`` (pure Python: no device, no torch import).
"""
from repro_torch.core import (CountWindowOperator, Engine, FailureInjector,
                              GeneratorSource, LineageQuery, LineageScope,
                              MapOperator, Pipeline, ReadSource, TerminalSink)


def build():
    p = Pipeline()
    # source: replayable read action over 40 sales batches
    p.add(lambda: GeneratorSource(
        "sales", ReadSource([{"amount": 10 * i} for i in range(40)])))
    # stateless enrichment
    p.add(lambda: MapOperator("fx", fn=lambda b: {"eur": b["amount"] * 0.9}))
    # stateful window aggregate (the paper's OP2 pattern)
    p.add(lambda: CountWindowOperator(
        "agg", 8, agg=lambda bs: {"total": round(sum(b["eur"] for b in bs))}))
    # sink writes durable, checkable write actions
    p.add(lambda: TerminalSink("report", target=5))
    p.connect("sales", "out", "fx", "in")
    p.connect("fx", "out", "agg", "in")
    p.connect("agg", "out", "report", "in")
    return p


def main():
    """Runs the demo; returns the engine, the sales batches behind report #2
    and the windows sales batch #11 flowed into."""
    # crash the aggregate mid-generation AND the enricher mid-stream
    injector = FailureInjector([("agg", "post_log", 2), ("fx", "pre_log", 17)])
    scopes = [LineageScope(("sales", "out"), ("agg", "out"))]
    eng = Engine(build(), mode="thread", injector=injector,
                 lineage_scopes=scopes, restart_delay=0.05)
    eng.start()
    assert eng.wait(30), "pipeline did not finish"
    eng.stop()

    print(f"failures injected: {eng.failures}, groups restarted: {eng.restarts}")
    print("reports committed exactly once:")
    for r in eng.external.committed():
        print("   ", r)

    query = LineageQuery(eng.store)
    # backward lineage: which sales batches made report window #2?
    contributors = query.backward(("agg", "out", 2)).keys()
    src = sorted(k[2] for k in contributors if k[0] == "sales")
    print(f"report #2 was computed from sales batches {src}")

    # forward lineage: where did sales batch #11 end up?
    outputs = query.forward(("sales", "out", 11), "fx").keys()
    flowed = [k for k in outputs if k[0] == "agg"]
    print(f"sales batch #11 flowed into {flowed}")
    return {"engine": eng, "contributors": src, "flowed": flowed}


if __name__ == "__main__":
    main()
