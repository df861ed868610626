"""Rank targets for tests/test_torch_dryrun.py's worlds.

``sparkrdma_tpu_torch.entry.spawn_world`` runs ``target(group)`` in
each rank of a spawned gloo world; the targets here fail on purpose, so
the test can show that one rank's failure, or one rank's stall, makes
the caller raise instead of leaving the others blocked.  Imports torch
only: neither JAX nor the tests' conftest.
"""

import time

import torch.distributed as dist

FAILING_RANK = 1


def fail_on_one_rank(group):
    """Rank ``FAILING_RANK`` raises; the others wait on a barrier that
    it never reaches."""
    if group.rank == FAILING_RANK:
        raise RuntimeError(f"rank {group.rank} fails on purpose")
    dist.barrier(group=group.group)


def stall_on_one_rank(group, seconds):
    """Rank ``FAILING_RANK`` sleeps for ``seconds``; the others' barrier
    runs into the collective timeout first."""
    if group.rank == FAILING_RANK:
        time.sleep(seconds)
    dist.barrier(group=group.group)
