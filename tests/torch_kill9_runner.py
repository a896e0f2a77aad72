"""Subprocess target for the port's true ``kill -9`` crash tests: run the
linear pipeline on ``repro_torch.core`` in process mode on a durable store
until the parent test SIGKILLs this whole process tree mid-run (a copy of
``tests/kill9_runner.py``).

Usage: python tests/torch_kill9_runner.py <store_spec> <db_path>
                                          <external_path> [transport] [ctx]
(The parent sets PYTHONPATH so ``repro_torch`` and ``tests`` import.)
"""
import sys
import time

import repro_torch.core as TC
from tests.torch_core_helpers import (FileExternalSystem, linear_pipeline,
                                      mk_store)


def main():
    spec, db_path, ext_path = sys.argv[1], sys.argv[2], sys.argv[3]
    transport = sys.argv[4] if len(sys.argv) > 4 else "routed"
    ctx = sys.argv[5] if len(sys.argv) > 5 else None
    build, _expected = linear_pipeline(TC, writes=1, rate=0.01)
    # no time-based flushing: whatever the watermark has not flushed when
    # the SIGKILL lands is a genuinely unflushed (or uncommitted) epoch;
    # segment specs compact live, so the kill can land mid-compaction
    store = mk_store(TC, spec, path=db_path, shards=3, batch_size=4,
                     interval=60.0)
    eng = TC.Engine(build(), mode="process", store=store,
                    external=FileExternalSystem(ext_path),
                    transport=transport, ctx=ctx, restart_delay=0.01)
    eng.start()
    print("READY", flush=True)
    eng.wait(60)
    print("DONE", flush=True)
    # stay alive (holding the unflushed tail) until the parent kills us
    time.sleep(60)


if __name__ == "__main__":
    main()
