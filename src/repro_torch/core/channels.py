"""DEPRECATED compatibility shim — the channel implementation is now the
``local`` transport (:mod:`repro_torch.core.transport.local`); see
:mod:`repro_torch.core.transport.base` for the formal interface and the credit
protocol shared by all transports. Importing this module warns; import
from ``repro_torch.core.transport.local`` (or the ``repro_torch.core`` surface)
instead."""
import warnings

from repro_torch.core.transport.local import Channel, ChannelClosed

warnings.warn(
    "repro_torch.core.channels is deprecated; import Channel/ChannelClosed from "
    "repro_torch.core.transport.local instead",
    DeprecationWarning, stacklevel=2)

__all__ = ["Channel", "ChannelClosed"]
