"""Device selection: the counterpart of ``sparkrdma_tpu/parallel/mesh.py``.

The JAX package fixes a 1-D ``Mesh`` over the chosen devices and runs
one SPMD program over all of them from one process.  This port runs one
process per GPU instead: a model over D > 1 devices is built in each
rank of a D-rank ``torch.distributed`` group (``group=``, see
``parallel/group.py``), and each rank passes its own shard.  Without a
group a model runs on ONE device.  The device is CUDA unless the caller
asks for the CPU (as the tests do); there is no silent drop to the CPU
when CUDA is absent.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Union[str, torch.device, None]


def one_process_per_gpu(what: str, n: int) -> str:
    """The refusal for ``n`` > 1 devices without a group."""
    return (
        f"{what} over {n} devices: the port runs one process per GPU, so "
        f"build it in each rank of a {n}-rank torch.distributed group and "
        f"pass group= (an ExchangeGroup or the process group); each rank "
        f"passes its own shard"
    )


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``cuda`` by default; ``cpu`` only on request.  Raises when a
    CUDA device is asked for (or defaulted to) and CUDA is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def select_devices(
    n_devices: Optional[int] = None,
    device_list: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
) -> List[torch.device]:
    """The one device of a process that runs without a group
    (``mesh_devices`` analog: ``device_list`` selects a CUDA ordinal,
    ``n_devices`` counts devices).  More than one device, by either
    argument, raises ``ValueError`` (:func:`one_process_per_gpu`), and
    so does an ordinal the host lacks."""
    picked = list(device_list or [])
    n = max(n_devices or 1, len(picked))
    if n > 1:
        raise ValueError(one_process_per_gpu("an exchange", n))
    base = resolve_device(device)
    if base.type == "cpu":
        if picked and picked != [0]:
            raise ValueError("device_list selects CUDA devices only")
        return [base]
    if picked:
        avail = torch.cuda.device_count()
        if not 0 <= picked[0] < avail:
            raise ValueError(
                f"device_list {picked}: there are {avail} CUDA devices"
            )
        return [torch.device("cuda", picked[0])]
    return [base]
