"""Device resolution for the port's entry points.

Every entry point takes ``device=None``, which means the CUDA card. Where
there is none it raises instead of running on the CPU unasked: a caller
that wants the CPU (the tests, the plain reference path) says so.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device=\"cpu\" to run the "
                "plain PyTorch versions of the kernels on the CPU")
        return torch.device("cuda")
    return torch.device(device)
