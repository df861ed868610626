"""In-task fetch retry policy: exponential backoff + jitter under a
deadline budget (conf ``fetchRetryCount`` / ``fetchRetryWaitMs`` /
``fetchRetryMaxMs``).

The reference SparkRDMA converts the FIRST transport failure into a
``FetchFailedException`` and lets Spark recompute the stage; this
policy absorbs transient fabric faults in-task first, converting to
:class:`FetchFailedError` only when the attempt count or the deadline
budget exhausts.  ``count=0`` disables retry entirely — the reader's
first-failure path is then byte-identical to the pre-policy behavior.
"""

from __future__ import annotations

import random
from typing import Optional

from sparkrdma_tpu_torch.transport.channel import is_transient  # noqa: F401


class RetryPolicy:
    """Backoff/deadline math for one fetch's retry attempts.

    ``attempts`` below is the number of failures already observed for
    the fetch (1 after the first failure).  A delay is granted while
    ``attempts <= count`` AND ``elapsed_ms < deadline_ms``; the delay
    doubles per attempt from ``wait_ms`` with equal jitter (half
    fixed, half uniform — decorrelates peers retrying in lockstep
    after a shared-fabric blip) and is clamped to the remaining
    deadline so the final sleep never overshoots the budget."""

    __slots__ = ("count", "wait_ms", "deadline_ms", "_rng")

    def __init__(self, count: int, wait_ms: float, deadline_ms: float,
                 rng: Optional[random.Random] = None):
        self.count = int(count)
        self.wait_ms = float(wait_ms)
        self.deadline_ms = float(deadline_ms)
        self._rng = rng if rng is not None else random.Random()

    @property
    def enabled(self) -> bool:
        return self.count > 0

    def next_delay_ms(self, attempts: int,
                      elapsed_ms: float) -> Optional[float]:
        """Delay before retry number ``attempts`` (1-based failure
        count), or ``None`` when the budget is exhausted."""
        if attempts < 1 or attempts > self.count:
            return None
        if elapsed_ms >= self.deadline_ms:
            return None
        base = self.wait_ms * (2.0 ** (attempts - 1))
        delay = base / 2.0 + self._rng.uniform(0.0, base / 2.0)
        return min(delay, self.deadline_ms - elapsed_ms)
