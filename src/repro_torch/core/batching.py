"""Adaptive micro-batch governor for the operator hot path (Nagle-style).

The paper's evaluation concedes that ABS beats LOG.io at high event rates
because LOG.io pays per-event logging/ack overhead, and names amortization
as the lever (Sec. 9).  The governor turns that into a *regime*, not a
structural loss: receivers drain a **run** of already-queued events from a
channel and apply it through one vectored log transaction and one coalesced
ack emission.

Design constraints:

* **Never wait for a batch to fill.**  The governor only sizes the run by
  what is *already buffered* — an idle channel yields runs of one, so at
  the paper's moderate regime (1 event / 100 ms) behavior is bit-identical
  to the per-event path: same latency, same straggler profile.  The hard
  latency bound is structural, not a timer.
* **Bounded run length.**  ``max_batch`` caps the run outright, and an
  EWMA of the observed per-event apply cost derives a second cap so one
  run never occupies an operator longer than ``latency_bound`` seconds —
  keeping warm-restart replay (≤ one run past the durability watermark)
  and credit-window turnaround bounded even under saturation.
* **Off by default.**  ``mode="off"`` (or batch size 1) short-circuits to
  the scalar path.  ``LOGIO_BATCH`` / ``Engine(batching=...)`` select
  ``"adaptive"`` or a fixed integer size.

See ``docs/batching.md`` for the knob reference.
"""
from __future__ import annotations

import os
import time
from typing import Optional, Union

#: run-length ceiling for the adaptive mode
DEFAULT_MAX_BATCH = 128
#: one run must not occupy the operator longer than this (seconds)
DEFAULT_LATENCY_BOUND = 0.010


def resolve_batching(spec: Union[None, str, int]) -> Union[str, int]:
    """Normalize a batching spec: ``None`` consults ``LOGIO_BATCH``; the
    result is ``"off"``, ``"adaptive"``, or a fixed positive int."""
    if spec is None:
        spec = os.environ.get("LOGIO_BATCH", "off")
    if isinstance(spec, bool):   # bool is an int subclass; reject early
        raise ValueError(f"invalid batching spec {spec!r}")
    if isinstance(spec, int):
        if spec < 1:
            raise ValueError(f"invalid batching spec {spec!r}")
        return 1 if spec == 1 else spec
    s = str(spec).strip().lower()
    if s in ("off", "", "0", "none", "false"):
        return "off"
    if s == "adaptive":
        return "adaptive"
    try:
        n = int(s)
    except ValueError:
        raise ValueError(f"invalid batching spec {spec!r}") from None
    if n < 1:
        raise ValueError(f"invalid batching spec {spec!r}")
    return n


class BatchGovernor:
    """Per-operator run-length governor.

    ``limit(queue_depth)`` returns how many events the receiver may drain
    this pass; ``observe(n, elapsed)`` feeds back the measured apply cost
    so the latency bound tracks the actual workload.
    """

    def __init__(self, mode: Union[None, str, int] = None,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 latency_bound: float = DEFAULT_LATENCY_BOUND):
        self.mode = resolve_batching(mode)
        self.max_batch = max_batch
        self.latency_bound = latency_bound
        # EWMA of per-event apply cost; seeded pessimistically high so the
        # first runs stay short until real measurements arrive
        self._ev_cost = latency_bound / 8.0
        self.runs = 0
        self.events = 0
        self.max_run = 0

    @property
    def enabled(self) -> bool:
        return self.mode != "off" and self.mode != 1

    def limit(self, queue_depth: int) -> int:
        """Run length for this pass given the channel's buffered depth.
        Never exceeds the depth — the governor does not wait for events."""
        if not self.enabled:
            return 1
        if queue_depth <= 1:
            return 1    # moderate regime: degenerate to the scalar path
        if self.mode != "adaptive":
            return min(queue_depth, int(self.mode))
        cap = self.max_batch
        if self._ev_cost > 0:
            cap = min(cap, max(1, int(self.latency_bound / self._ev_cost)))
        return min(queue_depth, cap)

    def observe(self, n: int, elapsed: float) -> None:
        """Feed back one completed run of ``n`` events taking ``elapsed``
        seconds through the apply+commit pass."""
        self.runs += 1
        self.events += n
        if n > self.max_run:
            self.max_run = n
        if n > 0 and elapsed > 0:
            per_ev = elapsed / n
            self._ev_cost += 0.2 * (per_ev - self._ev_cost)

    def timed(self):
        """Context-free timer helper: returns ``time.monotonic``'s now."""
        return time.monotonic()

    def stats(self) -> dict:
        """Point-in-time counters as a FRESH dict each call — callers own
        the result and may mutate it freely without corrupting governor
        state (``Engine.metrics()`` folds these into ``OpMetrics``)."""
        return {"mode": str(self.mode), "runs": self.runs,
                "events": self.events, "max_run": self.max_run,
                "ev_cost": self._ev_cost}


def make_governor(spec: Union[None, str, int],
                  max_batch: int = DEFAULT_MAX_BATCH,
                  latency_bound: float = DEFAULT_LATENCY_BOUND
                  ) -> Optional[BatchGovernor]:
    """Governor for one operator, or ``None`` when batching is off (the
    scalar hot path stays byte-identical to pre-batching builds)."""
    mode = resolve_batching(spec)
    if mode == "off" or mode == 1:
        return None
    return BatchGovernor(mode, max_batch=max_batch,
                         latency_bound=latency_bound)
