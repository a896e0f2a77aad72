# Transport layer: reliable FIFO channels with credit-based back-pressure
# behind the formal interfaces in `base` (Sec. 2.1's channel contract).
from repro_torch.core.transport.base import (ChannelEndpoint, SupervisorTransport,
                                       WorkerTransport,
                                       make_supervisor_transport,
                                       make_worker_transport,
                                       register_transport, transport_names)
from repro_torch.core.transport.local import Channel, ChannelClosed
