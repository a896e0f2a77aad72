"""LOG.io unified rollback recovery and data lineage capture: the port's copy
of ``repro.core`` that the training slice runs on (numpy-free, JAX-free
Python, the same modules under the same names).

Trimmed: the log store is ``memory`` only, the engine runs
``protocol="logio"`` in ``mode="thread"`` or ``"step"``, and the lineage
queries, ABS, process mode, partial replay, the recovery controller,
scaling and the cluster harness are not ported yet (later slices; each
trimmed entry raises ``NotImplementedError``).
"""
from repro_torch.core.builtin import (CountWindowOperator, GeneratorSource,
                                      MapOperator, SyncJoinOperator,
                                      TerminalSink)
from repro_torch.core.engine import (Engine, FailureInjector, Pipeline,
                                     TransportConfig)
from repro_torch.core.events import Event, ReadAction
from repro_torch.core.lineage import LineageScope, enabled_ports
from repro_torch.core.logstore import (LineageFilter, LogBackend,
                                       MemoryLogStore, NullLogStore,
                                       StoreConfig, TxnAborted, build_store)
from repro_torch.core.metrics import (MetricsSnapshot, OpMetrics,
                                      StoreMetrics, TransportMetrics)
from repro_torch.core.operator import (ExternalSystem, Operator,
                                       OperatorRuntime, ReadSource,
                                       SimulatedCrash)
from repro_torch.core.transport import Channel, ChannelClosed
from repro_torch.core.transport.base import Placement, WorkerBootstrap

__all__ = [
    "Channel", "ChannelClosed", "CountWindowOperator", "Engine", "Event",
    "ExternalSystem", "FailureInjector", "GeneratorSource", "LineageFilter",
    "LineageScope", "LogBackend", "MapOperator", "MemoryLogStore",
    "MetricsSnapshot", "NullLogStore", "OpMetrics", "Operator",
    "OperatorRuntime", "Pipeline", "Placement", "ReadAction", "ReadSource",
    "SimulatedCrash", "StoreConfig", "StoreMetrics", "SyncJoinOperator",
    "TerminalSink", "TransportConfig", "TransportMetrics", "TxnAborted",
    "WorkerBootstrap", "build_store", "enabled_ports",
]
