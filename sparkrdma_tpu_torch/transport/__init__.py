"""Transport layer: channels and their completion model.

A copy of the JAX package's ``transport/channel.py`` (the reference's
L4 channel, SURVEY.md §1).  Only the channel's names are exported: the
node, the loopback and TCP backends come with the record-level
shuffle.
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

__all__ = [
    "BlockStore",
    "Channel",
    "ChannelState",
    "ChannelType",
    "CompletionListener",
    "FnCompletionListener",
    "TransportError",
]
