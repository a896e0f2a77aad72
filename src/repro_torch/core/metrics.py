"""Unified typed metrics plane — the single sensing surface for the
adaptive recovery controller (and benchmarks, and humans).

Historically the engine exposed five incompatible ad-hoc stats dicts:
``op_stats`` / ``op_stats_detail`` / ``wire_stats`` / ``process_stats``
on the engine, ``query_stats`` on the store backends and ``stats()`` on
the batch governor.  This module folds all of them into one frozen,
documented schema:

  * :class:`OpMetrics`        — per-operator runtime counters + gauges
  * :class:`TransportMetrics` — wire-protocol counters (byte transports)
  * :class:`StoreMetrics`     — log-backend scan/commit effort
  * :class:`MetricsSnapshot`  — one coherent point-in-time view

``Engine.metrics()`` is the only entry point; it returns the same typed
snapshot in thread, step and process mode.  The legacy accessors remain
as DeprecationWarning shims (see docs/metrics.md for the field-by-field
mapping).

All counters are cumulative (monotone) across worker incarnations;
gauges (``queue_depth``) are instantaneous and never folded across
incarnations.  Consumers that want rates diff two snapshots — see
``repro.core.controller`` for the canonical delta loop.
"""
from __future__ import annotations

import dataclasses
import time
from types import MappingProxyType
from typing import Any, Dict, Mapping, Optional, Tuple


def _frozen(d: Optional[Mapping]) -> Mapping:
    return MappingProxyType(dict(d or {}))


@dataclasses.dataclass(frozen=True)
class OpMetrics:
    """Cumulative counters + instantaneous gauges for one operator.

    Counters come from the operator runtime (``rt.stats``) and its batch
    governor; in process mode they are summed across worker incarnations
    by the supervisor (``gov_max_run`` folds by max, ``queue_depth`` is a
    live gauge of the current incarnation only).
    """

    op_id: str
    group: str = ""
    # -- event flow ------------------------------------------------------
    events_in: int = 0
    events_out: int = 0
    txns: int = 0
    # -- latency/stall accounting (microseconds, cumulative) -------------
    commit_us: int = 0          # time spent inside store txn commits
    send_stall_us: int = 0      # time blocked in credit-gated channel puts
    # -- backlog gauge ---------------------------------------------------
    queue_depth: int = 0        # unprocessed events buffered at the inputs
    # -- micro-batching --------------------------------------------------
    batched_runs: int = 0
    batched_events: int = 0
    gov_runs: int = 0
    gov_events: int = 0
    gov_max_run: int = 0
    # -- recovery replay accounting --------------------------------------
    recovered_resends: int = 0
    recovered_inputs: int = 0
    recovery_scan_batches: int = 0

    @property
    def processed(self) -> int:
        """The legacy ``process_stats`` collapse: events in + out."""
        return self.events_in + self.events_out

    @property
    def avg_commit_us(self) -> float:
        return self.commit_us / self.txns if self.txns else 0.0

    @property
    def avg_run_length(self) -> float:
        runs = self.gov_runs or self.batched_runs
        events = self.gov_events or self.batched_events
        return events / runs if runs else 0.0


@dataclasses.dataclass(frozen=True)
class TransportMetrics:
    """Wire-protocol counters, summed across workers and incarnations.
    Zero-valued under the ``local``/``routed`` transports (no byte wire)."""

    frames: int = 0
    bytes: int = 0
    events: int = 0
    ctrl: int = 0
    ctrl_frames: int = 0
    extra: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: _frozen(None))

    @property
    def events_per_frame(self) -> float:
        return self.events / self.frames if self.frames else 0.0

    @property
    def ctrl_per_ctrl_frame(self) -> float:
        return self.ctrl / self.ctrl_frames if self.ctrl_frames else 0.0


@dataclasses.dataclass(frozen=True)
class StoreMetrics:
    """Log-backend effort counters: lineage-query scan counters plus any
    backend-specific keys (segment skip counts, commit totals) in
    ``extra``."""

    rows_scanned: int = 0
    rows_returned: int = 0
    commits: int = 0
    bytes_written: int = 0
    extra: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: _frozen(None))


@dataclasses.dataclass(frozen=True)
class MetricsSnapshot:
    """One coherent point-in-time view of the whole engine.

    ``ops`` maps operator id -> :class:`OpMetrics`; ``transport`` and
    ``store`` aggregate the wire and log layers.  ``ts`` is
    ``time.monotonic()`` at capture, so two snapshots diff into rates.
    """

    ts: float
    mode: str
    protocol: str
    failures: int = 0
    restarts: int = 0
    ops: Mapping[str, OpMetrics] = dataclasses.field(
        default_factory=lambda: _frozen(None))
    transport: TransportMetrics = dataclasses.field(
        default_factory=TransportMetrics)
    store: StoreMetrics = dataclasses.field(default_factory=StoreMetrics)
    recovery_modes: Mapping[str, str] = dataclasses.field(
        default_factory=lambda: _frozen(None))

    def op(self, op_id: str) -> OpMetrics:
        return self.ops.get(op_id) or OpMetrics(op_id)

    def group_total(self, attr: str, group: Optional[str] = None) -> int:
        """Sum one counter over all ops (optionally one group)."""
        return sum(getattr(m, attr) for m in self.ops.values()
                   if group is None or m.group == group)


# ---------------------------------------------------------------------------
# builders (internal plumbing for Engine.metrics())
# ---------------------------------------------------------------------------

#: rt.stats / detail-dict keys folded straight into OpMetrics fields
_OP_COUNTER_KEYS: Tuple[str, ...] = (
    "events_in", "events_out", "txns", "commit_us", "send_stall_us",
    "batched_runs", "batched_events", "gov_runs", "gov_events",
    "gov_max_run", "recovered_resends", "recovered_inputs",
    "recovery_scan_batches")


def op_metrics_from_counters(op_id: str, counters: Mapping[str, Any], *,
                             group: str = "", queue_depth: int = 0
                             ) -> OpMetrics:
    """Build one :class:`OpMetrics` from a raw runtime counter dict (the
    ``rt.stats`` shape, optionally extended with ``gov_*`` keys)."""
    kw = {k: int(counters.get(k, 0)) for k in _OP_COUNTER_KEYS}
    return OpMetrics(op_id=op_id, group=group, queue_depth=int(queue_depth),
                     **kw)


def transport_metrics_from_wire(wire: Mapping[str, float]
                                ) -> TransportMetrics:
    """Fold a raw wire-counter dict (the legacy ``wire_stats`` shape) into
    a :class:`TransportMetrics`; unknown keys land in ``extra``."""
    known = ("frames", "bytes", "events", "ctrl", "ctrl_frames")
    extra = {k: v for k, v in wire.items()
             if k not in known
             and k not in ("events_per_frame", "ctrl_per_ctrl_frame")}
    return TransportMetrics(
        frames=int(wire.get("frames", 0)),
        bytes=int(wire.get("bytes", 0)),
        events=int(wire.get("events", 0)),
        ctrl=int(wire.get("ctrl", 0)),
        ctrl_frames=int(wire.get("ctrl_frames", 0)),
        extra=_frozen(extra))


def store_metrics_from_backend(store) -> StoreMetrics:
    """Read a backend's scan counters (the non-deprecated path — backends'
    public ``query_stats()`` is a DeprecationWarning shim)."""
    q: Dict[str, int] = dict(store._query_stats())
    return StoreMetrics(
        rows_scanned=int(q.pop("rows_scanned", 0)),
        rows_returned=int(q.pop("rows_returned", 0)),
        commits=int(getattr(store, "commits", 0)),
        bytes_written=int(getattr(store, "bytes_written", 0)),
        extra=_frozen(q))


def build_snapshot(*, mode: str, protocol: str, failures: int, restarts: int,
                   op_counters: Mapping[str, Mapping[str, Any]],
                   groups: Mapping[str, str],
                   queue_depths: Mapping[str, int],
                   wire: Mapping[str, float], store,
                   recovery_modes: Mapping[str, str]) -> MetricsSnapshot:
    ops = {op: op_metrics_from_counters(
               op, counters, group=groups.get(op, op),
               queue_depth=queue_depths.get(op, 0))
           for op, counters in op_counters.items()}
    return MetricsSnapshot(
        ts=time.monotonic(), mode=mode, protocol=protocol,
        failures=failures, restarts=restarts, ops=_frozen(ops),
        transport=transport_metrics_from_wire(wire),
        store=store_metrics_from_backend(store),
        recovery_modes=_frozen(recovery_modes))
