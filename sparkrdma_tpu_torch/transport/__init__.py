"""Transport layer: channels, nodes, flow control, loopback backend.

The reference's L4 (RdmaNode/RdmaChannel/RdmaThread over DiSNI verbs,
SURVEY.md §1).  Here a ``Channel`` carries the same two traffic classes —
small control RPCs and bulk one-sided block reads — over pluggable
backends: an in-process loopback for tests and single-host runs, and TCP
between processes.  The device-to-device byte exchange is
``sparkrdma_tpu_torch.parallel.exchange``.
"""

from sparkrdma_tpu_torch.transport.channel import (
    BlockStore,
    Channel,
    ChannelState,
    ChannelType,
    CompletionListener,
    FnCompletionListener,
    TransportError,
)
from sparkrdma_tpu_torch.transport.node import Node
from sparkrdma_tpu_torch.transport.loopback import LoopbackNetwork
from sparkrdma_tpu_torch.transport.stripe import ReadGroup
from sparkrdma_tpu_torch.transport.tcp import TcpNetwork

__all__ = [
    "BlockStore",
    "TcpNetwork",
    "ReadGroup",
    "Channel",
    "ChannelState",
    "ChannelType",
    "CompletionListener",
    "FnCompletionListener",
    "TransportError",
    "Node",
    "LoopbackNetwork",
]
