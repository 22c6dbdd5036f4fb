"""RTN — round-to-nearest weight-only quantization of Linear modules.

The counterpart of ``neural_compressor_tpu.algorithms.rtn`` for Linear
ops: each [K, N] kernel is quantized group-wise, packed ("tpu_strided")
and its module swapped for a ``WOQLinear``.
"""

from __future__ import annotations

import torch

from ..common import logger
from ..layers.module_utils import get_module, replace_module
from ..layers.woq_linear import WOQLinear
from ..ops.packing import PackedWeight, pack_qtensor
from ..ops.qtensor import QTensor, quantize_tensor
from . import register_algo
from .utils import dump_op_stats, extract_linear

_FLOAT_SKIP = ("fp32", "bf16", "fp16", "float32", "bfloat16", "float16")


def rtn_quantize_kernel(kernel: torch.Tensor, cfg) -> QTensor:
    """Quantize one [K, N] kernel per an RTN-style config."""
    if getattr(cfg, "use_mse_search", False):
        raise NotImplementedError(
            "RTN's MSE clip search waits for the port of "
            "neural_compressor_tpu.ops.qtensor.search_clip")
    return quantize_tensor(kernel.to(torch.float32), bits=cfg.weight_bits,
                           group_size=cfg.group_size, scheme=cfg.scheme,
                           dtype=cfg.weight_dtype,
                           full_range=getattr(cfg, "use_full_range", False))


def _rtn_pack(kernel: torch.Tensor, cfg) -> PackedWeight:
    if getattr(cfg, "use_double_quant", False):
        raise NotImplementedError(
            "double quantization waits for the port of "
            "neural_compressor_tpu.ops.packing.apply_double_quant")
    return pack_qtensor(rtn_quantize_kernel(kernel, cfg))


@register_algo("rtn")
def rtn_entry(model, configs_mapping, mode="quantize", run_fn=None,
              run_args=None, example_inputs=None, config=None):
    if mode == "prepare":
        return model  # RTN needs no calibration
    n_done = 0
    for (name, _op_type), cfg in configs_mapping.items():
        if cfg.dtype in _FLOAT_SKIP:
            continue
        lin = extract_linear(get_module(model, name))
        if lin is None:
            continue
        kernel, bias = lin
        replace_module(model, name, WOQLinear(_rtn_pack(kernel, cfg),
                                              bias=bias))
        n_done += 1
    logger.info("RTN quantized %d ops", n_done)
    dump_op_stats(model)
    return model
