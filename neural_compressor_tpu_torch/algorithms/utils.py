"""Shared helpers for algorithm entries."""

from __future__ import annotations

import torch

from ..common.utility import Statistics
from ..layers.module_utils import module_type_name, named_modules


def extract_linear(mod) -> tuple[torch.Tensor, torch.Tensor | None] | None:
    """Return ``(kernel [K, N], bias|None)`` from a Linear-like module."""
    kernel = getattr(mod, "kernel", None)
    if not isinstance(kernel, torch.Tensor) or kernel.ndim != 2:
        return None
    bias = getattr(mod, "bias", None)
    return kernel.detach(), None if bias is None else bias.detach()


def _mod_dtype(mod) -> str:
    if hasattr(mod, "wdtype") and hasattr(mod, "bits"):
        d = mod.wdtype
        return f"int{mod.bits}" if d == "int" else d
    return "fp"


def dump_op_stats(model) -> None:
    """Op-type/dtype summary table after quantization."""
    counts: dict[tuple[str, str], int] = {}
    for name, mod in named_modules(model):
        if not name:
            continue
        key = (module_type_name(mod), _mod_dtype(mod))
        counts[key] = counts.get(key, 0) + 1
    rows = [(t, d, n) for (t, d), n in sorted(counts.items())]
    if rows:
        Statistics(rows, header="Mixed Precision Statistics",
                   field_names=["Op Type", "DType", "Count"]).print_stat()
