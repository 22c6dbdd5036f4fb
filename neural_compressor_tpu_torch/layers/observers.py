"""Calibration statistics kept on a module.

The slice of ``neural_compressor_tpu/layers/observers.py`` that GPTQ needs:
``ObserverStat``. JAX keeps a calibration statistic as an NNX variable
that is not a parameter; here it is a buffer, registered on the module
that records it, so it moves with the module and stays out of its
parameters.
"""

from __future__ import annotations

import torch
from torch import nn


def ObserverStat(module: nn.Module, name: str,
                 value: torch.Tensor) -> torch.Tensor:
    """Register ``value`` as the calibration statistic ``name`` of
    ``module`` (a buffer, not a parameter) and return it."""
    module.register_buffer(name, value)
    return value
