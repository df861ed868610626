"""Memory of the port: the device arena and its registry, the staging
bridge, and the host disk helpers."""

from sparkrdma_tpu_torch.memory.arena import ArenaManager, DeviceSegment
from sparkrdma_tpu_torch.memory.device_arena import (
    DeviceArena,
    DeviceStagingBridge,
)
from sparkrdma_tpu_torch.memory.direct_io import DirectAppender, direct_supported

__all__ = [
    "ArenaManager",
    "DeviceArena",
    "DeviceSegment",
    "DeviceStagingBridge",
    "DirectAppender",
    "direct_supported",
]
