"""Small helpers of the PyTorch port: device resolution, logger, timers, the
R-parity LCG."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for an entry point's ``device=`` argument.

    The default is the GPU. A CUDA device that is not there raises: no entry
    point of the port carries on on the CPU unless ``device="cpu"`` is
    passed explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} was requested but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def same_device(a, b) -> bool:
    """Whether two devices are the same one (``cuda`` means ``cuda:0``)."""
    a, b = torch.device(a), torch.device(b)
    return a.type == b.type and (a.index or 0) == (b.index or 0)
