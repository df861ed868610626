"""Multi-process support: the port of ``sparkrdma_tpu/parallel/multihost.py``.

The reference scales across nodes with one RdmaNode per JVM and a full
mesh of RC connections (SURVEY.md §1 deployment topology).  The JAX
package joins JAX's multi-controller runtime, one process per host.
The port runs one process per GPU: :func:`initialize` joins a
``torch.distributed`` world (NCCL on the cards, gloo on the CPU), and
the exchange group over that world (``parallel/group.py``) carries the
collectives, over NVLink within a host.

What this module provides:

- :func:`initialize` — the rendezvous (driver coordinator analog);
- :func:`global_group` — the exchange group over every rank of the job
  (the counterpart of ``global_mesh``);
- :func:`host_local_indices` — which rows of a rank-sharded exchange
  this process owns: its own rank (one device per process);
- :func:`is_multihost` and :func:`supports_multiprocess_collectives`.

Single-process jobs never need to call anything here.
"""

from __future__ import annotations

import datetime
from typing import List, Optional

import torch
import torch.distributed as dist

from sparkrdma_tpu_torch.parallel.device import DeviceLike
from sparkrdma_tpu_torch.parallel.group import ExchangeGroup, world_group

# a collective with a dead peer fails after this long instead of
# hanging (the rendezvous itself waits as long)
DEFAULT_TIMEOUT_S = 60.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: DeviceLike = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> None:
    """Join the multi-process job (idempotent).

    ``coordinator_address`` is ``host:port`` of rank 0's store (or an
    ``init_method`` URL such as ``tcp://...`` or ``file://...``),
    ``num_processes`` the world size and ``process_id`` this rank.  On a
    card machine (``device`` CUDA, the default when CUDA is present) the
    backend is NCCL, after ``torch.cuda.set_device`` of card
    ``process_id % device_count``; on the CPU it is gloo.  ``timeout_s``
    bounds every collective, so one with a dead peer fails instead of
    hanging.

    A call with no arguments on a single host is a no-op (nothing
    discovers a cluster here), as is a second call.  A failure with
    explicit arguments raises: swallowing it would silently run N
    independent single-process jobs."""
    if dist.is_available() and dist.is_initialized():
        return  # rendezvous already done
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        return  # a single host: nothing to join
    if None in (coordinator_address, num_processes, process_id):
        raise ValueError(
            "initialize needs coordinator_address, num_processes and "
            "process_id together"
        )
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to join a gloo "
                "world on the CPU"
            )
        torch.cuda.set_device(
            dev.index if dev.index is not None
            else int(process_id) % torch.cuda.device_count()
        )
        backend = "nccl"
    else:
        backend = "gloo"
    url = coordinator_address
    if "://" not in url:
        url = f"tcp://{url}"
    dist.init_process_group(
        backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=float(timeout_s)),
    )


def global_group(device: DeviceLike = None) -> ExchangeGroup:
    """The exchange group over EVERY rank of the job (a world of one
    before :func:`initialize`), on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    return world_group(device)


def host_local_indices(group: ExchangeGroup) -> List[int]:
    """The group positions this process owns — the rows of a
    rank-sharded exchange this host holds: its own rank."""
    return [group.rank]


def is_multihost() -> bool:
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def supports_multiprocess_collectives() -> bool:
    """Can worker processes run cross-process collectives here?  True
    where ``torch.distributed`` has gloo (every build the port runs on)
    or NCCL; unlike the JAX CPU backend, the port's multi-process tests
    therefore run on the CPU."""
    if not dist.is_available():
        return False
    return bool(dist.is_gloo_available() or dist.is_nccl_available())

