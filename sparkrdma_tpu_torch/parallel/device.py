"""Device selection: the counterpart of ``sparkrdma_tpu/parallel/mesh.py``.

The JAX package fixes a 1-D ``Mesh`` over the chosen devices; this port
runs one process per GPU, and this slice runs on ONE device.  The device
is CUDA unless the caller asks for the CPU (as the tests do); there is
no silent drop to the CPU when CUDA is absent.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import torch

DeviceLike = Union[str, torch.device, None]

MULTI_GPU_ITEM = (
    "ROADMAP.md, 'Next, in order', item 1: Multi-GPU exchange "
    "(partition.py, hash_exchange and the D > 1 TeraSort over "
    "torch.distributed)"
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
    """Pick the devices serving the exchange (``mesh_devices`` analog:
    ``device_list`` selects CUDA ordinals, ``n_devices`` takes the first
    n).  This slice supports exactly one device: more than one, by
    either argument, raises ``NotImplementedError``, and an ordinal the
    host lacks raises ``ValueError``."""
    if n_devices is not None and n_devices > 1:
        raise NotImplementedError(
            f"n_devices={n_devices}: multi-GPU exchange is not ported yet "
            f"({MULTI_GPU_ITEM})"
        )
    base = resolve_device(device)
    if base.type == "cpu":
        if device_list and list(device_list) != [0]:
            raise ValueError("device_list selects CUDA devices only")
        return [base]
    if device_list:
        picked = list(device_list)
        if len(picked) > 1:
            raise NotImplementedError(
                f"device_list {picked}: multi-GPU exchange is not ported "
                f"yet ({MULTI_GPU_ITEM})"
            )
        avail = torch.cuda.device_count()
        if not 0 <= picked[0] < avail:
            raise ValueError(
                f"device_list {picked}: there are {avail} CUDA devices"
            )
        return [torch.device("cuda", picked[0])]
    return [base]
