from sparkrdma_tpu_torch.parallel.device import resolve_device, select_devices
from sparkrdma_tpu_torch.parallel.exchange import (
    ExchangePlan,
    PaddedSourceRow,
    TileExchange,
)
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup
from sparkrdma_tpu_torch.parallel.ring import (
    RingExchange,
    ring_shift,
    ring_shift_back,
)

__all__ = [
    "ExchangeGroup",
    "ExchangePlan",
    "PaddedSourceRow",
    "RingExchange",
    "resolve_device",
    "ring_shift",
    "ring_shift_back",
    "select_devices",
    "TileExchange",
]
