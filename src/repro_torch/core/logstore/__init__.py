"""LOG.io persistent log tables (Sec. 3.2) behind atomic transactions.

Counterpart of ``repro.core.logstore``, trimmed to what the training slice
runs on:

  * :class:`LogBackend` / :class:`LogTransaction` — the formal interface
    every protocol module programs against (``base``);
  * :class:`MemoryLogStore`, :class:`NullLogStore` — dict-based backends
    (``memory``).

``build_store`` takes the ``memory`` spec (a :class:`StoreConfig` or the
string ``"memory"``). The other bases (sqlite, segment, null) and modifiers
(sharded, group) raise ``NotImplementedError``: they arrive with the
log-store slice.
"""
from __future__ import annotations

import dataclasses
from typing import Union

from repro_torch.core.logstore.base import (LineageFilter, LogBackend,
                                            LogTransaction, TxnAborted)
from repro_torch.core.logstore.memory import MemoryLogStore, NullLogStore

__all__ = ["LineageFilter", "LogBackend", "LogTransaction", "TxnAborted",
           "MemoryLogStore", "NullLogStore", "StoreConfig", "build_store"]


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"repro_torch: the {what} log store is not ported yet; it arrives "
        "with the log-store slice (only 'memory' runs today)")


@dataclasses.dataclass(frozen=True)
class StoreConfig:
    """Typed description of a log-backend stack: the ``memory`` base alone.

    ``StoreConfig.parse("memory")`` and ``str(config)`` round-trip as in
    ``repro.core.logstore``; any other base or a modifier raises."""

    base: str = "memory"
    sharded: bool = False
    group: bool = False

    def __post_init__(self):
        if self.base != "memory":
            raise _later(repr(self.base))
        if self.sharded or self.group:
            raise _later("sharded / group-commit")

    @classmethod
    def parse(cls, spec: str) -> "StoreConfig":
        """Parse ``"<base>[+sharded][+group]"``; only ``"memory"`` builds."""
        if not isinstance(spec, str) or not spec:
            raise ValueError(
                f"store spec must be a non-empty string, got {spec!r}")
        base, *mods = spec.split("+")
        for m in mods:
            if m not in ("sharded", "group"):
                raise ValueError(f"unknown store modifier {m!r} in spec "
                                 f"{spec!r} (expected ['sharded', 'group'])")
        return cls(base=base, sharded="sharded" in mods, group="group" in mods)

    def __str__(self) -> str:
        return self.base


def build_store(config: Union[StoreConfig, str] = "memory") -> LogBackend:
    """A :class:`MemoryLogStore` from ``"memory"`` or its config; every
    other spec raises ``NotImplementedError`` (see the module docstring)."""
    if isinstance(config, str):
        config = StoreConfig.parse(config)
    elif not isinstance(config, StoreConfig):
        raise ValueError(f"build_store expects a StoreConfig or a spec "
                         f"string, got {type(config).__name__}")
    return MemoryLogStore()
