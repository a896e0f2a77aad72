"""Adaptive hybrid recovery controller (closes the ROADMAP item).

The paper's evaluation concedes that ABS-style epoch snapshotting beats
LOG.io's per-event logging at high event rates, while LOG.io wins under
stragglers and at moderate rates — and that data parallelization is
LOG.io's scaling lever.  :class:`RecoveryController` turns that static
comparison into a closed loop: it samples ``Engine.metrics()`` on a
cadence, derives per-group signals (event rate, commit-latency share,
credit-window stall share, queue depth, batch-run length, replay-cost
estimate) from consecutive snapshot deltas, and

  (a) switches operator groups between ``"log"`` (per-event logging,
      cheap straggler recovery) and ``"epoch"`` (interval snapshotting,
      cheap high-rate steady state) via ``Engine.set_recovery_mode`` —
      with hysteresis so a noisy signal cannot flap the protocol; and
  (b) drives a ``scaling.Controller`` to add/remove replicas so the
      Little's-law residence-time estimate (queue depth / service rate)
      stays under the configured latency SLO.

Config is the typed :class:`ControllerConfig`, a sibling of
``StoreConfig``/``TransportConfig`` (spec strings round-trip through
``ControllerConfig.parse`` / ``str``).

Every decision is appended to :attr:`RecoveryController.decisions` as
``(ts, kind, target, detail)`` so tests and benchmarks can assert the
control trajectory.  ``tick(snapshot)`` is callable directly with a
hand-built :class:`~repro_torch.core.metrics.MetricsSnapshot`, which is how the
unit tests script deterministic traffic patterns without a live engine.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .metrics import MetricsSnapshot

#: canonical spec-field order for the ControllerConfig round-trip
_SPEC_FIELDS = ("slo_ms", "sample_interval", "switch_hysteresis",
                "min_replicas", "max_replicas", "high_rate_eps",
                "epoch_interval", "scale_cooldown")


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Typed, validated controller configuration.

    Spec strings are ``key=value`` pairs joined by commas, e.g.
    ``"slo_ms=50,switch_hysteresis=2,min_replicas=1,max_replicas=4"``;
    ``ControllerConfig.parse(spec)`` and ``str(cfg)`` round-trip.
    """

    #: latency SLO the scaler defends (estimated residence time, ms)
    slo_ms: float = 100.0
    #: seconds between metric samples in the controller loop
    sample_interval: float = 0.05
    #: consecutive agreeing samples required before a mode switch or a
    #: scale-up (scale-down additionally waits out ``scale_cooldown``)
    switch_hysteresis: int = 3
    min_replicas: int = 1
    max_replicas: int = 4
    #: sustained events/sec above which a group is "high-rate" (the
    #: regime where the paper concedes the epoch protocol wins)
    high_rate_eps: float = 2000.0
    #: generate-txns between state snapshots for groups in "epoch" mode
    epoch_interval: int = 16
    #: seconds after any scaling action before the next one
    scale_cooldown: float = 1.0

    def __post_init__(self):
        if not self.slo_ms > 0:
            raise ValueError(f"slo_ms must be > 0, got {self.slo_ms!r}")
        if not self.sample_interval > 0:
            raise ValueError(f"sample_interval must be > 0, "
                             f"got {self.sample_interval!r}")
        if self.switch_hysteresis < 1:
            raise ValueError(f"switch_hysteresis must be >= 1, "
                             f"got {self.switch_hysteresis!r}")
        if self.min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, "
                             f"got {self.min_replicas!r}")
        if self.max_replicas < self.min_replicas:
            raise ValueError(
                f"max_replicas must be >= min_replicas "
                f"({self.min_replicas}), got {self.max_replicas!r}")
        if not self.high_rate_eps > 0:
            raise ValueError(f"high_rate_eps must be > 0, "
                             f"got {self.high_rate_eps!r}")
        if self.epoch_interval < 2:
            raise ValueError(f"epoch_interval must be >= 2, "
                             f"got {self.epoch_interval!r}")
        if self.scale_cooldown < 0:
            raise ValueError(f"scale_cooldown must be >= 0, "
                             f"got {self.scale_cooldown!r}")

    @classmethod
    def parse(cls, spec: str, **overrides) -> "ControllerConfig":
        """Parse a ``key=value,key=value`` spec string.

        Unknown keys, duplicate keys and malformed pairs raise
        ``ValueError``; keyword ``overrides`` win over the spec.
        """
        if not isinstance(spec, str) or not spec.strip():
            raise ValueError(
                f"controller spec must be a non-empty string, got {spec!r}")
        kw: Dict[str, object] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(
                    f"malformed controller spec entry {part!r} "
                    f"(expected key=value)")
            key, _, raw = part.partition("=")
            key = key.strip()
            if key not in _SPEC_FIELDS:
                raise ValueError(
                    f"unknown controller spec key {key!r} "
                    f"(expected one of {', '.join(_SPEC_FIELDS)})")
            if key in kw:
                raise ValueError(f"duplicate controller spec key {key!r}")
            caster = cls.__dataclass_fields__[key].type
            try:
                kw[key] = (int(raw) if caster == "int" else float(raw))
            except ValueError:
                raise ValueError(
                    f"bad value for controller spec key {key!r}: {raw!r}")
        kw.update(overrides)
        return cls(**kw)

    def __str__(self) -> str:
        parts = []
        for key in _SPEC_FIELDS:
            v = getattr(self, key)
            parts.append(f"{key}={v:g}" if isinstance(v, float)
                         else f"{key}={v}")
        return ",".join(parts)


@dataclasses.dataclass
class _GroupState:
    """Per-group hysteresis bookkeeping."""
    epoch_votes: int = 0
    log_votes: int = 0
    last_events_in: int = 0
    last_commit_us: int = 0
    last_stall_us: int = 0


class RecoveryController:
    """Closed-loop recovery-mode + replica-count controller.

    Parameters
    ----------
    engine:
        the :class:`~repro_torch.core.engine.Engine` to sense and actuate.
    config:
        a :class:`ControllerConfig` (or spec string for ``parse``).
    mode_groups:
        operator groups whose recovery mode the controller may switch;
        defaults to every non-source group with at least one stateful
        runtime.  Pass ``()`` to disable mode switching.
    scaler:
        an optional ``scaling.Controller``; when given, the controller
        holds the SLO by calling ``scale_up``/``scale_down`` with
        replica ids ``<replica_prefix>0..N``.
    """

    def __init__(self, engine, config: Optional[ControllerConfig] = None,
                 *, mode_groups: Optional[Sequence[str]] = None,
                 scaler=None, replica_prefix: str = "r",
                 initial_replicas: Optional[Sequence[str]] = None):
        if isinstance(config, str):
            config = ControllerConfig.parse(config)
        self.engine = engine
        self.config = config or ControllerConfig()
        self.scaler = scaler
        self.replica_prefix = replica_prefix
        self.replicas: List[str] = list(initial_replicas or [])
        self._replica_seq = len(self.replicas)
        self.mode_groups: Optional[Tuple[str, ...]] = (
            tuple(mode_groups) if mode_groups is not None else None)
        self.decisions: List[Tuple[float, str, str, str]] = []
        self._groups: Dict[str, _GroupState] = {}
        self._prev: Optional[MetricsSnapshot] = None
        self._slo_hot = 0          # consecutive over-SLO samples
        self._slo_cold = 0         # consecutive well-under-SLO samples
        self._last_scale_ts = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        if self._thread is not None:
            return
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop,
                                        name="recovery-controller",
                                        daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    def _loop(self):
        while not self._stop.wait(self.config.sample_interval):
            try:
                self.tick()
            except Exception as e:    # sensing must never kill the pipeline
                self._decide("error", "-", f"{type(e).__name__}: {e}")

    # ------------------------------------------------------------------
    # the control step
    # ------------------------------------------------------------------
    def tick(self, snapshot: Optional[MetricsSnapshot] = None):
        """One control step.  Pass a scripted ``snapshot`` for
        deterministic tests; defaults to a live ``engine.metrics()``."""
        with self._lock:
            snap = snapshot if snapshot is not None else self.engine.metrics()
            prev, self._prev = self._prev, snap
            if prev is None or snap.ts <= prev.ts:
                return
            dt = snap.ts - prev.ts
            self._mode_step(prev, snap, dt)
            self._scale_step(prev, snap, dt)

    def _decide(self, kind: str, target: str, detail: str):
        self.decisions.append((time.monotonic(), kind, target, detail))

    def _managed_groups(self, snap: MetricsSnapshot) -> Sequence[str]:
        if self.mode_groups is not None:
            return self.mode_groups
        return sorted({m.group for m in snap.ops.values() if m.group})

    # -- (a) per-group recovery-mode switching --------------------------
    def _mode_step(self, prev: MetricsSnapshot, snap: MetricsSnapshot,
                   dt: float):
        cfg = self.config
        for group in self._managed_groups(snap):
            gs = self._groups.setdefault(group, _GroupState())
            ev = snap.group_total("events_in", group)
            d_ev = ev - prev.group_total("events_in", group)
            d_commit = (snap.group_total("commit_us", group)
                        - prev.group_total("commit_us", group))
            d_stall = (snap.group_total("send_stall_us", group)
                       - prev.group_total("send_stall_us", group))
            rate = d_ev / dt
            wall_us = dt * 1e6
            commit_share = d_commit / wall_us if wall_us else 0.0
            stall_share = d_stall / wall_us if wall_us else 0.0
            qdepth = snap.group_total("queue_depth", group)
            # high-rate regime: sustained arrivals above the threshold and
            # the log commit path is a real share of the wall clock — the
            # case the paper concedes to the epoch protocol.  Stall time
            # (back-pressure from a slow *downstream*) and a deep queue
            # with a LOW rate (a straggler: service-bound, not log-bound)
            # both vote for per-event logging, whose recovery replays only
            # the failed operator instead of globally restarting.
            straggler = qdepth > 0 and rate < cfg.high_rate_eps / 4
            high = (rate >= cfg.high_rate_eps and commit_share > 0.05
                    and stall_share < 0.5 and not straggler)
            if high:
                gs.epoch_votes += 1
                gs.log_votes = 0
            else:
                gs.log_votes += 1
                gs.epoch_votes = 0
            current = self.engine.recovery_mode_of(group)
            if (current != "epoch"
                    and gs.epoch_votes >= cfg.switch_hysteresis):
                self.engine.set_recovery_mode(group, "epoch")
                gs.epoch_votes = 0
                self._decide("mode", group,
                             f"epoch (rate={rate:.0f}ev/s "
                             f"commit={commit_share:.2f})")
            elif (current != "log"
                    and gs.log_votes >= cfg.switch_hysteresis):
                self.engine.set_recovery_mode(group, "log")
                gs.log_votes = 0
                self._decide("mode", group,
                             f"log (rate={rate:.0f}ev/s "
                             f"straggler={straggler} qdepth={qdepth})")

    # -- (b) SLO-driven replica scaling ---------------------------------
    def _scale_step(self, prev: MetricsSnapshot, snap: MetricsSnapshot,
                    dt: float):
        if self.scaler is None:
            return
        cfg = self.config
        est_ms = self.residence_ms(prev, snap)
        if est_ms > cfg.slo_ms:
            self._slo_hot += 1
            self._slo_cold = 0
        elif est_ms < cfg.slo_ms * 0.3:
            self._slo_cold += 1
            self._slo_hot = 0
        else:
            self._slo_hot = self._slo_cold = 0
        now = time.monotonic()
        if now - self._last_scale_ts < cfg.scale_cooldown:
            return
        n = len(self.replicas)
        if self._slo_hot >= cfg.switch_hysteresis and n < cfg.max_replicas:
            rid = f"{self.replica_prefix}{self._replica_seq}"
            self._replica_seq += 1
            self.scaler.scale_up(rid)
            self.replicas.append(rid)
            self._last_scale_ts = now
            self._slo_hot = 0
            self._decide("scale_up", rid, f"est={est_ms:.1f}ms "
                                          f"slo={cfg.slo_ms:g}ms n={n + 1}")
        elif (self._slo_cold >= cfg.switch_hysteresis * 2
                and n > cfg.min_replicas):
            rid = self.replicas.pop()
            self.scaler.scale_down(rid)
            self._last_scale_ts = now
            self._slo_cold = 0
            self._decide("scale_down", rid, f"est={est_ms:.1f}ms n={n - 1}")

    def residence_ms(self, prev: MetricsSnapshot,
                     snap: MetricsSnapshot) -> float:
        """Little's-law residence-time estimate: total queued events over
        the service rate observed between the two snapshots."""
        dt = snap.ts - prev.ts
        if dt <= 0:
            return 0.0
        served = (snap.group_total("events_in")
                  - prev.group_total("events_in"))
        qdepth = snap.group_total("queue_depth")
        if qdepth == 0:
            return 0.0
        if served <= 0:
            return float("inf")
        return qdepth / (served / dt) * 1e3
