"""Control-plane RPC messages and codecs."""

from sparkrdma_tpu_torch.rpc.messages import (
    MSG_TYPES,
    AnnounceShuffleManagersMsg,
    FetchMapStatusMsg,
    FetchMapStatusResponseMsg,
    HelloMsg,
    PublishMapTaskOutputMsg,
    RpcMsg,
    WireField,
    WireFormatError,
    decode_msg,
    hex_context,
)

__all__ = [
    "RpcMsg",
    "HelloMsg",
    "AnnounceShuffleManagersMsg",
    "PublishMapTaskOutputMsg",
    "FetchMapStatusMsg",
    "FetchMapStatusResponseMsg",
    "WireField",
    "WireFormatError",
    "decode_msg",
    "hex_context",
    "MSG_TYPES",
]
