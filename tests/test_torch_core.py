"""The port's copy of the LOG.io engine and the training feed against the
JAX package's, on the CPU.

* ``repro_torch.data.build_data_pipeline`` hands the train loop the same
  token batches (``==``) as ``repro.data``'s for the same seed;
* the port's ``Engine`` in step mode, under the same ``FailureInjector``
  plans as ``repro.core``'s (a crash at every protocol point of every
  operator, and multi-failure plans), commits the same outputs, each exactly
  once: the failure-free expectation, with no duplicate and no loss.
"""
import os
import queue
from functools import partial

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro.data as JD  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.data as TD  # noqa: E402

pytestmark = pytest.mark.timeout(120)

N_EVENTS, WINDOW, TARGET = 20, 4, 5
POINTS = ["source_pre_log", "source_post_log", "pre_filter",
          "pre_state_update", "post_ack_log", "pre_log", "post_log",
          "post_send", "pre_write", "post_write_pre_done"]
PLANS = [
    [("map", "post_log", 2), ("win", "pre_log", 1)],
    [("src", "source_post_log", 5), ("win", "post_send", 2)],
    [("map", "pre_state_update", 1), ("map", "post_ack_log", 4),
     ("sink", "pre_write", 2)],
    [("win", "recovery_post_resend", 1), ("win", "pre_log", 1)],
]
EXPECTED = [{"s": sum(2 * j for j in range(i * WINDOW, (i + 1) * WINDOW))}
            for i in range(TARGET)]


def _double(b):
    return {"v": b["v"] * 2}


def _win_sum(bs):
    return {"s": sum(b["v"] for b in bs)}


def _linear(core):
    """src -> map(x2) -> win(sum of 4, one external write each) -> sink,
    built from ``core`` (``repro.core`` or ``repro_torch.core``)."""
    p = core.Pipeline()
    p.add(partial(core.GeneratorSource, "src",
                  core.ReadSource([{"v": i} for i in range(N_EVENTS)])))
    p.add(partial(core.MapOperator, "map", fn=_double))
    p.add(partial(core.CountWindowOperator, "win", WINDOW, agg=_win_sum,
                  writes_per_output=1))
    p.add(partial(core.TerminalSink, "sink", target=TARGET))
    p.connect("src", "out", "map", "in")
    p.connect("map", "out", "win", "in")
    p.connect("win", "out", "sink", "in")
    return p


def _run(core, plan):
    eng = core.Engine(_linear(core), mode="step",
                      injector=core.FailureInjector(plan))
    assert eng.run_to_completion()
    committed = eng.external.committed()
    outputs = [b for b in committed if not (isinstance(b, dict) and "inset" in b)]
    writes = [b for b in committed if isinstance(b, dict) and "inset" in b]
    return outputs, writes, eng.failures, eng.restarts


def _same_as_jax(plan):
    want = _run(JC, plan)
    got = _run(TC, plan)
    assert got == want
    outputs, writes, failures, _ = got
    assert outputs == EXPECTED            # exactly once: no loss, no dupe
    assert len(writes) == TARGET
    assert failures == len([1 for _, _, n in plan if n])


@pytest.mark.parametrize("op_id", ["src", "map", "win", "sink"])
@pytest.mark.parametrize("point", POINTS)
def test_engine_single_failure_matches_jax(op_id, point):
    for nth in (1, 3):
        want, got = _run(JC, [(op_id, point, nth)]), _run(TC, [(op_id, point, nth)])
        assert got == want, (op_id, point, nth)
        assert got[0] == EXPECTED and len(got[1]) == TARGET, (op_id, point, nth)


@pytest.mark.parametrize("plan", PLANS)
def test_engine_multiple_failures_match_jax(plan):
    want, got = _run(JC, plan), _run(TC, plan)
    assert got == want
    assert got[0] == EXPECTED


def test_engine_failure_free_matches_jax():
    _same_as_jax([])


def _batches(core, data, n, seed):
    pipeline, feed_id = data.build_data_pipeline(
        seq_len=32, batch_size=4, vocab=1000, n_shards=2 * n + 4,
        shard_tokens=2 * 33, per_batch=2, seed=seed)
    eng = core.Engine(pipeline, mode="thread", restart_delay=0.01)
    eng.start()
    out = []
    try:
        while len(out) < n:
            feed = eng.ops[feed_id]
            feed.requeue()
            try:
                _, body = feed.buffer.get(timeout=5.0)
            except queue.Empty:
                pytest.fail("no batch from the data pipeline")
            out.append((np.asarray(body["tokens"]), body["shards"]))
    finally:
        eng.stop()
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_data_pipeline_batches_match_jax(seed):
    want = _batches(JC, JD, 6, seed)
    got = _batches(TC, TD, 6, seed)
    assert len(got) == len(want) == 6
    for (a, sa), (b, sb) in zip(got, want):
        assert sa == sb
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_corpus_and_packing_match_jax():
    jc, tc = (m.SyntheticCorpus(5, 99, 321, seed=7) for m in (JD, TD))
    for a, b in zip(tc.effect("x", 1), jc.effect("x", 1)):
        assert a["shard"] == b["shard"] and np.array_equal(a["tokens"], b["tokens"])
        pa, pb = TD.pack_fn(32)(a), JD.pack_fn(32)(b)
        assert np.array_equal(pa["seqs"], pb["seqs"])


# ---------------------------------------------------------------------------
# the training substrate's data and checkpoint units (copies of three cases
# of tests/test_training_units.py on repro_torch.data and
# repro_torch.checkpoint)
# ---------------------------------------------------------------------------

def test_synthetic_corpus_replayable():
    c = TD.SyntheticCorpus(n_shards=8, shard_tokens=64, vocab=100, seed=5)
    a = c.effect("read", 0)
    b = c.effect("read", 3)
    assert len(a) == 8 and len(b) == 5
    np.testing.assert_array_equal(a[3]["tokens"], b[0]["tokens"])
    want = JD.SyntheticCorpus(n_shards=8, shard_tokens=64, vocab=100,
                              seed=5).effect("read", 0)
    assert all(np.array_equal(x["tokens"], y["tokens"])
               for x, y in zip(a, want))


def test_pack_fn_shapes():
    from repro.data.pipeline import pack_fn as jax_pack_fn
    from repro_torch.data.pipeline import pack_fn
    fn = pack_fn(seq_len=16)
    body = {"shard": 0, "tokens": np.arange(100, dtype=np.int32)}
    out = fn(body)
    assert out["seqs"].shape == (100 // 17, 17)
    assert np.array_equal(out["seqs"], jax_pack_fn(seq_len=16)(body)["seqs"])


def test_checkpoint_store_checkable(tmp_path):
    from repro.checkpoint import CheckpointStore as JaxCheckpointStore
    from repro_torch.checkpoint import CheckpointStore
    store = CheckpointStore(str(tmp_path / "port"))
    state = {"w": np.arange(10.0), "step": np.int32(7)}
    assert store.status(7) == "unknown"
    store.save(state, 7)
    assert store.status(7) == "success"          # checkable write action
    step, back = store.latest()
    assert step == 7
    np.testing.assert_array_equal(back["w"], state["w"])
    store.save(state, 14)
    store.gc(keep=1)
    assert store.status(7) == "unknown" and store.status(14) == "success"
    # the same file names and contents as repro.checkpoint's store
    jstore = JaxCheckpointStore(str(tmp_path / "jax"))
    jstore.save(state, 14)
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    jstep, jback = jstore.latest()
    _, back = store.latest()
    assert jstep == 14 and back.keys() == jback.keys()
    assert all(np.array_equal(back[k], jback[k]) for k in back)
