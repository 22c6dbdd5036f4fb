"""Module-graph walking and in-place replacement over ``nn.Module``.

The counterpart of ``neural_compressor_tpu.layers.module_utils``: dotted
paths name the same submodules in both packages ("model.layers.0.mlp.
up_proj"), so a config's op names match in either.
"""

from __future__ import annotations

from typing import Iterator

from torch import nn


def module_type_name(module) -> str:
    return type(module).__name__


def named_modules(model: nn.Module, prefix: str = "") -> Iterator[tuple[str, nn.Module]]:
    """Yield ``(dotted_path, module)`` for every submodule, depth-first,
    including the root (path ''). Children set to None are skipped."""
    yield prefix, model
    for name, child in model.named_children():
        if child is None:
            continue
        path = f"{prefix}.{name}" if prefix else name
        yield from named_modules(child, path)


def get_model_info(model: nn.Module,
                   op_types: tuple[str, ...] | None = None) -> list[tuple[str, str]]:
    """``[(op_name, op_type), ...]`` for quantizable ops (type-name filter)."""
    info = []
    for name, mod in named_modules(model):
        if not name:
            continue
        t = module_type_name(mod)
        if op_types is None or t in op_types:
            info.append((name, t))
    return info


def get_module(model: nn.Module, path: str) -> nn.Module:
    return model.get_submodule(path) if path else model


def replace_module(model: nn.Module, path: str, new_module: nn.Module) -> None:
    """Replace the submodule at ``path`` (dotted; list indices as numbers)."""
    parent_path, _, last = path.rpartition(".")
    parent = get_module(model, parent_path)
    if isinstance(parent, nn.ModuleList):
        parent[int(last)] = new_module
    else:
        setattr(parent, last, new_module)
