"""Host memory and disk helpers of the port."""

from sparkrdma_tpu_torch.memory.direct_io import DirectAppender, direct_supported

__all__ = ["DirectAppender", "direct_supported"]
