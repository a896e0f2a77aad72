"""Engine-internal units of the port, on the CPU: a copy of
``tests/test_engine_units.py`` on ``repro_torch.core``.

* ``FailureInjector``'s nth-crash rule; each injector case replays the same
  calls on ``repro.core``'s injector and holds what fired and the counts
  ``==``;
* the channel's deferred-ack cursor used by group-commit pipelining, and
  its refusal of puts after close;
* the ABS baseline's snapshots through the ``LogBackend`` interface.
"""
import threading

import pytest

pytest.importorskip("torch")

import repro.core as JC  # noqa: E402
import repro_torch.core as TC  # noqa: E402
from repro_torch.core import (Channel, ChannelClosed, Event,  # noqa: E402
                              FailureInjector)
from tests.torch_core_helpers import linear_pipeline, sink_outputs  # noqa: E402


def _fire(inj, op, point):
    try:
        inj(op, point)
        return False
    except (TC.SimulatedCrash, JC.SimulatedCrash):
        return True


def _same_as_jax(plan, calls, inj):
    """Replay ``calls`` on ``repro.core``'s injector: what fired, its
    counts and its plan's ``fired`` list equal the port's."""
    jinj = JC.FailureInjector(plan)
    got = [_fire(jinj, op, pt) for op, pt in calls]
    assert jinj.fired == inj.fired
    assert dict(jinj.counts) == dict(inj.counts)
    return got


def test_injector_fires_on_nth_hit_of_exact_point():
    plan = [("A", "p", 3)]
    inj = FailureInjector(plan)
    calls = [("A", "p"), ("A", "q"), ("A", "p"), ("B", "p"), ("A", "p"),
             ("A", "p")]
    assert not _fire(inj, "A", "p")
    assert not _fire(inj, "A", "q")      # other points don't advance "p"
    assert not _fire(inj, "A", "p")
    assert not _fire(inj, "B", "p")      # other operators don't either
    assert _fire(inj, "A", "p")          # third hit of (A, p)
    assert inj.fired == [("A", "p", 3)]
    # a fired plan entry is consumed: the 4th hit is quiet
    assert not _fire(inj, "A", "p")
    assert _same_as_jax(plan, calls, inj) == [False, False, False, False,
                                              True, False]


def test_injector_star_counts_any_point():
    plan = [("A", "*", 3)]
    inj = FailureInjector(plan)
    assert not _fire(inj, "A", "x")
    assert not _fire(inj, "A", "y")
    assert not _fire(inj, "B", "z")      # other ops don't count
    assert _fire(inj, "A", "z")          # 3rd crash-point hit of A overall
    assert inj.fired == [("A", "*", 3)]
    assert _same_as_jax(plan, [("A", "x"), ("A", "y"), ("B", "z"),
                               ("A", "z")], inj) == [False, False, False,
                                                     True]


def test_injector_exact_and_star_counters_are_independent():
    plan = [("A", "p", 2), ("A", "*", 5)]
    inj = FailureInjector(plan)
    hits = ["q", "p", "q", "p"]          # (A,p) #2 on the 4th call
    fired = [_fire(inj, "A", pt) for pt in hits]
    assert fired == [False, False, False, True]
    # the star entry keeps counting every call, including the one that fired
    assert _fire(inj, "A", "q")          # n_any reaches 5 here
    assert inj.counts[("A", "*")] == 5
    assert inj.fired == [("A", "p", 2), ("A", "*", 5)]
    assert _same_as_jax(plan, [("A", pt) for pt in hits + ["q"]],
                        inj) == fired + [True]


def _ch():
    return Channel("A", "out", "B", "in", capacity=8)


def _put(ch, i):
    ch.put(Event(i, "A", "out", "B", "in", body=i))


def test_channel_deferred_ack_fifo():
    ch = _ch()
    for i in range(3):
        _put(ch, i)
    assert ch.peek().event_id == 0
    ch.defer_ack()                        # 0 processed, unreleased
    assert ch.peek().event_id == 1        # processing continues past it
    ch.defer_ack()
    assert len(ch) == 3                   # deferred events still buffered
    assert ch.release_ack().event_id == 0
    assert ch.release_ack().event_id == 1
    assert ch.release_ack() is None
    assert len(ch) == 1
    assert ch.peek().event_id == 2


def test_channel_immediate_ack_skips_deferred_head():
    ch = _ch()
    for i in range(2):
        _put(ch, i)
    ch.defer_ack()                        # 0 pending release
    assert ch.peek().event_id == 1
    assert ch.ack().event_id == 1         # drops 1, not the deferred 0
    assert ch.release_ack().event_id == 0


def test_channel_reset_pending_redelivers():
    ch = _ch()
    for i in range(2):
        _put(ch, i)
    ch.defer_ack()
    assert ch.peek().event_id == 1
    ch.reset_pending()                    # receiver restart
    assert ch.peek().event_id == 0        # unreleased events re-delivered


def test_channel_rejects_puts_after_close():
    """A put absorbed after close() would strand the event forever (nobody
    drains a closed buffer): every put flavour must refuse."""
    ch = _ch()
    _put(ch, 0)
    ch.close()
    ev = Event(1, "A", "out", "B", "in", body=1)
    assert ch.put(ev) is False
    assert ch.try_put(ev) is False
    with pytest.raises(ChannelClosed):
        ch.force_put(ev)
    assert len(ch) == 1                   # only the pre-close event remains


def test_channel_blocked_put_aborts_on_close():
    """A sender blocked on a full window wakes and aborts when the channel
    closes (engine stop), instead of hanging forever."""
    ch = Channel("A", "out", "B", "in", capacity=1)
    _put(ch, 0)
    result = []
    t = threading.Thread(
        target=lambda: result.append(
            ch.put(Event(1, "A", "out", "B", "in", body=1), timeout=0.01)))
    t.start()
    t.join(timeout=0.2)
    assert t.is_alive()                   # genuinely blocked on capacity
    ch.close()
    t.join(timeout=5.0)
    assert not t.is_alive()
    assert result == [False]


def test_abs_snapshots_through_log_backend():
    """The ABS baseline persists its epoch snapshots through the formal
    LogBackend interface when one is attached (same storage stack as
    LOG.io)."""
    build, expected = linear_pipeline(TC)
    backend = TC.GroupCommitStore(batch_size=4, interval=0.001)
    eng = TC.Engine(build(), mode="thread", protocol="abs",
                    abs_options={"epoch_events": 5,
                                 "durable_store": backend})
    eng.start()
    assert eng.wait(30)
    eng.stop()
    assert sink_outputs(eng) == expected
    # every operator's snapshots landed as STATE rows via the backend
    for op in ("src", "map", "win", "sink"):
        assert backend.get_state(f"abs:{op}") is not None
