"""Block-wise calibration capture.

The counterpart of ``neural_compressor_tpu/algorithms/calib_capture.py``:
the transformer block list is found structurally (the shallowest
``nn.ModuleList`` of two or more same-typed modules that hold a Linear),
and the first block is wrapped by a module that records its inputs and
stops the forward, so that a user's calibration function feeds GPTQ one
block at a time.
"""

from __future__ import annotations

import torch
from torch import nn

from ..common import logger
from ..layers.module_utils import (get_module, module_type_name,
                                   named_modules, replace_module)


class CaptureAbort(Exception):
    """Raised by the capture wrapper to stop the forward after block 0."""


class BlockInputCapture(nn.Module):
    """Wraps the first transformer block: records (args, kwargs), aborts."""

    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner
        self._captured: list[tuple[tuple, dict]] = []

    def forward(self, *args, **kwargs):
        self._captured.append((tuple(args), dict(kwargs)))
        raise CaptureAbort

    @property
    def captured(self):
        return self._captured


def _has_linear(mod: nn.Module) -> bool:
    return any(isinstance(getattr(sub, "kernel", None), torch.Tensor)
               for _p, sub in named_modules(mod))


def find_target_blocks(model: nn.Module) -> tuple[str, list[str]] | None:
    """``(list_path, [block_paths...])`` of the decoder-block list: the
    shallowest ``nn.ModuleList`` of two or more same-typed modules holding
    a Linear (an MoE expert list lives inside a block), ties broken by
    path; a ``language_model`` submodule is searched first. None if the
    model has no block structure."""
    lm = getattr(model, "language_model", None)
    if lm is not None:
        res = find_target_blocks(lm)
        if res is not None:
            lpath, bpaths = res
            return (f"language_model.{lpath}",
                    [f"language_model.{p}" for p in bpaths])
    candidates = []
    for path, mod in named_modules(model):
        if not isinstance(mod, nn.ModuleList) or len(mod) < 2:
            continue
        if len({module_type_name(m) for m in mod}) != 1:
            continue
        if _has_linear(mod[0]):
            candidates.append(path)
    if not candidates:
        return None
    path = min(candidates, key=lambda p: (p.count("."), p))
    return (path, [f"{path}.{i}" for i in range(len(get_module(model, path)))])


class CalibCaptureState:
    """The capture wrapper and the cached block-0 inputs between
    ``prepare`` and ``convert``."""

    def __init__(self, model, block_list_path: str, block_paths: list[str]):
        self.model = model
        self.block_list_path = block_list_path
        self.block_paths = block_paths
        self.wrapper: BlockInputCapture | None = None

    def attach(self):
        first = get_module(self.model, self.block_paths[0])
        self.wrapper = BlockInputCapture(first)
        replace_module(self.model, self.block_paths[0], self.wrapper)

    def detach(self) -> list[tuple[tuple, dict]]:
        if self.wrapper is None:
            raise RuntimeError("detach() without attach()")
        replace_module(self.model, self.block_paths[0], self.wrapper.inner)
        captured = self.wrapper.captured
        self.wrapper = None
        logger.info("Captured %d calibration batches for block 0",
                    len(captured))
        return captured


def run_capture(model, state: CalibCaptureState, run_fn, run_args=None):
    """Attach the wrapper, run the user's calibration function (each model
    call stops after recording block 0's inputs), detach; the inputs."""
    state.attach()
    try:
        _safe_run(model, run_fn, run_args)
    finally:
        captured = state.detach()
    return captured


def _safe_run(model, run_fn, run_args):
    """Run the user's calibration; a ``CaptureAbort`` that escapes it ends
    it (a function that loops over batches should catch it per batch, as
    ``calibration_forward`` does)."""
    from .quantize_helpers import run_user_calibration

    try:
        with torch.no_grad():
            run_user_calibration(model, run_fn, run_args)
    except CaptureAbort:
        pass


def calibration_forward(model, batches):
    """Convenience ``run_fn``: calls ``model`` on each batch, tolerating the
    capture abort (``run_fn=lambda m: calibration_forward(m, data)``)."""
    for b in batches:
        try:
            with torch.no_grad():
                model(b)
        except CaptureAbort:
            continue
    return None
