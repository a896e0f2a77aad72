"""Data lineage: scopes, path enumeration (Sec. 3.1), and queries (Sec. 7.3).

A scope (start, target) of port ids implicitly defines the data lineage
paths; for every (OP.in, OP.out) subsequence on a path, capture is enabled
for those ports of OP. Queries join EVENT_LINEAGE x EVENT_LOG:

  backward(event)  : output event -> InSet_ID -> input events (recursively)
  forward(event)   : input event -> InSet_IDs it joined -> output events
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import defaultdict
from typing import Dict, FrozenSet, List, Sequence, Set, Tuple

from repro_torch.core.logstore import LogBackend


@dataclasses.dataclass(frozen=True)
class LineageScope:
    start: Tuple[str, str]     # (op_id, output_port)
    target: Tuple[str, str]    # (op_id, output_port)

    def __post_init__(self):
        for name in ("start", "target"):
            val = getattr(self, name)
            if isinstance(val, list):
                val = tuple(val)
                object.__setattr__(self, name, val)
            if not (isinstance(val, tuple) and len(val) == 2
                    and all(isinstance(x, str) and x for x in val)):
                raise ValueError(
                    f"LineageScope.{name} must be an (op_id, port) pair of "
                    f"non-empty strings (got {val!r})")


def _paths(pipeline, start: Tuple[str, str], target: Tuple[str, str]
           ) -> List[List[Tuple[str, str]]]:
    """All port-id paths start -> target over the connection graph."""
    edges = pipeline.edges()    # ((send_op, send_port), (rec_op, rec_port))
    # adjacency: an operator's input port leads to all its output ports
    out_ports: Dict[str, Set[str]] = defaultdict(set)
    for (s, sp), _ in edges:
        out_ports[s].add(sp)
    # the target may be an output port with no outgoing connection (the
    # terminal operator of the scope) — the connection graph alone never
    # mentions it, so declare it or the walk cannot enter it
    out_ports[target[0]].add(target[1])
    results = []

    def walk(port, path, traversed: FrozenSet[Tuple]):
        """``traversed`` carries the path's consecutive (port, port) pairs
        as a set — membership is O(1) instead of rebuilding the full edge
        list per candidate (quadratic in path length on wide diamonds)."""
        if port == target:
            results.append(path)
            return
        # from an output port follow connections to input ports
        for (s, sp), (d, dp) in edges:
            if (s, sp) == port:
                # enter operator d at dp, then leave via each of its outputs
                for op_out in out_ports.get(d, ()):  # (d, op_out)
                    step = ((d, dp), (d, op_out))
                    if step not in traversed:
                        walk((d, op_out), path + [(d, dp), (d, op_out)],
                             traversed | {(port, (d, dp)), step})
                if not out_ports.get(d) and (d, dp) == target:
                    results.append(path + [(d, dp)])

    walk(start, [start], frozenset())
    return results


def enabled_ports(pipeline, scopes: Sequence[LineageScope]
                  ) -> Dict[str, Tuple[Set[str], Set[str]]]:
    """op_id -> (enabled input ports IN, enabled output ports OUT)."""
    out: Dict[str, Tuple[Set[str], Set[str]]] = defaultdict(
        lambda: (set(), set()))
    for scope in scopes:
        for path in _paths(pipeline, scope.start, scope.target):
            # subsequences (OP.in, OP.out)
            for i in range(len(path) - 1):
                (op1, p1), (op2, p2) = path[i], path[i + 1]
                if op1 == op2:      # in -> out inside one operator
                    ins, outs = out[op1]
                    ins.add(p1)
                    outs.add(p2)
        # the start port itself has capture enabled as an output
        sop, sport = scope.start
        out[sop][1].add(sport)
    return dict(out)


# ---------------------------------------------------------------------------
# queries — deprecated free-function surface
# ---------------------------------------------------------------------------
# The walks moved to repro_torch.core.lineagequery.LineageQuery (typed EventKey
# results, scan-time filtering, bounded growth). These shims keep the old
# tuple-list signatures working one release longer.

def backward(store: LogBackend, event_key: Tuple[str, str, int],
             depth: int = 64) -> List[Tuple[str, str, int]]:
    """Deprecated: use ``LineageQuery(store).backward(key)``."""
    warnings.warn(
        "repro_torch.core.lineage.backward is deprecated; use "
        "repro_torch.core.LineageQuery(store).backward(key)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.core.lineagequery import LineageQuery
    return LineageQuery(store).backward(event_key, depth=depth).keys()


def forward(store: LogBackend, event_key: Tuple[str, str, int],
            rec_op: str, depth: int = 64) -> List[Tuple[str, str, int]]:
    """Deprecated: use ``LineageQuery(store).forward(key, rec_op)``."""
    warnings.warn(
        "repro_torch.core.lineage.forward is deprecated; use "
        "repro_torch.core.LineageQuery(store).forward(key, rec_op)",
        DeprecationWarning, stacklevel=2)
    from repro_torch.core.lineagequery import LineageQuery
    return LineageQuery(store).forward(event_key, rec_op, depth=depth).keys()
