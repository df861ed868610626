"""Memory of the port: the native host staging pool, the device arena
and its registry, the staging bridge, and the host disk helpers."""

from sparkrdma_tpu_torch.memory.arena import ArenaManager, DeviceSegment
from sparkrdma_tpu_torch.memory.device_arena import (
    DeviceArena,
    DeviceStagingBridge,
)
from sparkrdma_tpu_torch.memory.direct_io import DirectAppender, direct_supported
from sparkrdma_tpu_torch.memory.staging import StagingBuffer, StagingPool

__all__ = [
    "ArenaManager",
    "DeviceArena",
    "DeviceSegment",
    "DeviceStagingBridge",
    "DirectAppender",
    "StagingBuffer",
    "StagingPool",
    "direct_supported",
]
