"""LOG.io unified rollback recovery and fine-grain data lineage capture for
distributed data pipelines: the port's copy of ``repro.core`` (JAX-free,
numpy-free Python, the same modules under the same names).

It runs every log store (memory, sqlite, segment, null; sharded and group
commit), both protocols (``"logio"`` and the ABS baseline), the lineage
queries, partial replay, the Protocol API, scaling and the recovery
controller, in ``mode="thread"`` and ``"step"``.

Still trimmed: process mode (``procmode``, the routed, socket/tcp, shm and
wire transports) and the cluster harness (``LocalCluster``). Every path
that reaches them raises ``NotImplementedError`` naming the process-mode
slice.

``__all__`` below is the curated public surface of ``repro.core`` less
``LocalCluster``. Everything else imported here remains reachable, but
internal modules are not the documented way in.
"""
from repro_torch.core.api import LogioAPI
from repro_torch.core.builtin import (CountWindowOperator, GeneratorSource,
                                      MapOperator, SyncJoinOperator,
                                      TerminalSink)
from repro_torch.core.controller import ControllerConfig, RecoveryController
from repro_torch.core.metrics import (MetricsSnapshot, OpMetrics,
                                      StoreMetrics, TransportMetrics)
from repro_torch.core.engine import (Engine, FailureInjector, Pipeline,
                                     TransportConfig)
from repro_torch.core.transport import Channel, ChannelClosed
from repro_torch.core.transport.base import Placement, WorkerBootstrap
from repro_torch.core.events import Event, ReadAction
from repro_torch.core.lineage import (LineageScope, backward, enabled_ports,
                                      forward)
from repro_torch.core.lineagequery import (EventKey, LineageQuery,
                                           LineageResult, LineageSlice)
from repro_torch.core.logstore import (GroupCommitStore, LineageFilter,
                                       LogBackend, MemoryLogStore,
                                       NullLogStore, SegmentLogStore,
                                       ShardedLogStore, SqliteLogStore,
                                       StoreConfig, TxnAborted, build_store)
from repro_torch.core.operator import (ExternalSystem, Operator,
                                       OperatorRuntime, ReadSource,
                                       SimulatedCrash)
from repro_torch.core.replay import ReplayMismatch, ReplayReport

__all__ = [
    "ControllerConfig",
    "Engine",
    "EventKey",
    "LineageFilter",
    "LineageQuery",
    "LineageScope",
    "LogioAPI",
    "MetricsSnapshot",
    "OpMetrics",
    "Pipeline",
    "Placement",
    "StoreConfig",
    "TransportConfig",
    "build_store",
]
