"""LOG.io persistent log tables (Sec. 3.2) behind atomic transactions.

The log layer is a pluggable backend stack:

  * :class:`LogBackend` / :class:`LogTransaction` — the formal interface
    every protocol module programs against (``base``);
  * :class:`MemoryLogStore`, :class:`NullLogStore` — dict-based backends
    (``memory``);
  * :class:`SqliteLogStore` — durable ACID backend (``sqlite``);
  * :class:`SegmentLogStore` — durable append-only file segments + sidecar
    index, with checkpoint compaction (``segment``);
  * :class:`ShardedLogStore` — partitions the tables by operator id across
    independent shard backends (``sharded``);
  * :class:`GroupCommitStore` — group-commit transaction pipelining with a
    durability watermark (``batched``).

``build_store`` assembles a stack from a typed :class:`StoreConfig` or from
the legacy spec string it round-trips with, e.g. ``"memory"``,
``"sqlite"``, ``"segment+group"``, ``"memory+sharded+group"``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Union

from repro_torch.core.logstore.base import (LineageFilter, LogBackend,
                                      LogTransaction, TxnAborted)
from repro_torch.core.logstore.batched import GroupCommitStore
from repro_torch.core.logstore.epoch import (EpochCoordinator,
                                       SqliteEpochCoordinator,
                                       make_coordinator)
from repro_torch.core.logstore.memory import MemoryLogStore, NullLogStore
from repro_torch.core.logstore.segment import SegmentLogStore
from repro_torch.core.logstore.sharded import ShardedLogStore
from repro_torch.core.logstore.sqlite import SqliteLogStore

__all__ = ["LineageFilter", "LogBackend", "LogTransaction", "TxnAborted",
           "MemoryLogStore", "NullLogStore", "SqliteLogStore",
           "SegmentLogStore", "ShardedLogStore", "GroupCommitStore",
           "EpochCoordinator", "SqliteEpochCoordinator", "StoreConfig",
           "build_store"]

_BASES = ("memory", "sqlite", "segment", "null")
_MODIFIERS = ("sharded", "group")


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Typed description of a log-backend stack.

    ``StoreConfig.parse(spec)`` accepts the legacy
    ``"<base>[+sharded][+group]"`` spec strings and ``str(config)`` renders
    the config back to exactly that spec — the two forms round-trip. The
    segment-backend knobs (``segment_bytes``, ``compress``,
    ``checkpoint_interval``) have no spec-string syntax: they are
    configured only through this typed path.
    """

    base: str = "memory"
    sharded: bool = False
    group: bool = False
    #: sqlite: database file; segment: store directory; required for both.
    path: Optional[str] = None
    shards: int = 4
    batch_size: int = 64
    interval: float = 0.005
    #: segment backend: active-segment rotation threshold (bytes).
    segment_bytes: int = 4 * 1024 * 1024
    #: segment backend: zlib-compress sealed segments and checkpoints.
    compress: bool = True
    #: segment backend: records between automatic checkpoint compactions
    #: (0 = checkpoint only on explicit ``store.checkpoint()`` calls).
    checkpoint_interval: int = 0

    def __post_init__(self):
        if self.base not in _BASES:
            raise ValueError(f"unknown store base {self.base!r} "
                             f"(expected one of {list(_BASES)})")
        if self.shards < 1:
            raise ValueError(f"shards must be >= 1, got {self.shards}")
        if self.batch_size < 1:
            raise ValueError(
                f"batch_size must be >= 1, got {self.batch_size}")
        if self.interval < 0:
            raise ValueError(f"interval must be >= 0, got {self.interval}")
        if self.segment_bytes < 1:
            raise ValueError(
                f"segment_bytes must be >= 1, got {self.segment_bytes}")
        if self.checkpoint_interval < 0:
            raise ValueError(f"checkpoint_interval must be >= 0, got "
                             f"{self.checkpoint_interval}")

    @classmethod
    def parse(cls, spec: str, **overrides) -> "StoreConfig":
        """Parse ``"<base>[+sharded][+group]"`` into a config; keyword
        overrides fill the non-spec fields (path, shards, ...)."""
        if not isinstance(spec, str) or not spec:
            raise ValueError(
                f"store spec must be a non-empty string, got {spec!r}")
        parts = spec.split("+")
        base, mods = parts[0], parts[1:]
        seen = set()
        for m in mods:
            if m not in _MODIFIERS:
                raise ValueError(
                    f"unknown store modifier {m!r} in spec {spec!r} "
                    f"(expected {list(_MODIFIERS)})")
            if m in seen:
                raise ValueError(
                    f"duplicate store modifier {m!r} in spec {spec!r}")
            seen.add(m)
        return cls(base=base, sharded="sharded" in seen,
                   group="group" in seen, **overrides)

    def __str__(self) -> str:
        spec = self.base
        if self.sharded:
            spec += "+sharded"
        if self.group:
            spec += "+group"
        return spec


def build_store(config: Union[StoreConfig, str] = "memory", *,
                path: Optional[str] = None, shards: Optional[int] = None,
                batch_size: Optional[int] = None,
                interval: Optional[float] = None) -> LogBackend:
    """Assemble a backend stack from a :class:`StoreConfig` or a legacy
    ``"<base>[+sharded][+group]"`` spec string.

    base: ``memory`` | ``sqlite`` | ``segment`` (both need ``path``) |
    ``null``. ``+group`` wraps each (shard) store in group commit;
    ``+sharded`` partitions by operator id. ``memory+group`` simulates
    durability via the flushed-op history so ``crash()`` loses exactly the
    unflushed batch. ``sharded+group`` stacks flush under the global-epoch
    2PC protocol — durable bases get a durable epoch coordinator at
    ``<path>.epochs``. The keyword overrides apply to spec strings only;
    with a config object every knob lives in the config.
    """
    if isinstance(config, StoreConfig):
        if any(v is not None for v in (path, shards, batch_size, interval)):
            raise ValueError("pass store options inside the StoreConfig, "
                             "not as build_store keyword overrides")
        cfg = config
    elif isinstance(config, str):
        overrides = {k: v for k, v in [("path", path), ("shards", shards),
                                       ("batch_size", batch_size),
                                       ("interval", interval)]
                     if v is not None}
        cfg = StoreConfig.parse(config, **overrides)
    else:
        raise ValueError(f"build_store expects a StoreConfig or a spec "
                         f"string, got {type(config).__name__}")

    coord = None
    if cfg.sharded and cfg.group and cfg.base != "null":
        coord = make_coordinator(
            cfg.base, None if cfg.path is None else f"{cfg.path}.epochs")

    def leaf(i: Optional[int] = None) -> LogBackend:
        if cfg.base == "memory":
            inner = None if cfg.group else MemoryLogStore()
        elif cfg.base == "null":
            return NullLogStore()
        elif cfg.base == "sqlite":
            if cfg.path is None:
                raise ValueError("sqlite store needs a path")
            p = cfg.path if i is None else f"{cfg.path}.shard{i}"
            inner = SqliteLogStore(p, epoch_coord=coord)
        else:   # segment
            if cfg.path is None:
                raise ValueError("segment store needs a path (a directory)")
            p = cfg.path if i is None else os.path.join(cfg.path,
                                                        f"shard{i}")
            inner = SegmentLogStore(
                p, segment_bytes=cfg.segment_bytes, compress=cfg.compress,
                checkpoint_interval=cfg.checkpoint_interval,
                epoch_coord=coord)
        if cfg.group:
            return GroupCommitStore(inner, batch_size=cfg.batch_size,
                                    interval=cfg.interval,
                                    epoch_coord=coord)
        return inner

    if cfg.sharded:
        return ShardedLogStore(cfg.shards, factory=lambda i: leaf(i),
                               epoch_coord=coord)
    return leaf()
