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
from ..ops.packing import PackedWeight, apply_double_quant, pack_qtensor
from ..ops.qtensor import QTensor, quantize_tensor, search_clip
from . import register_algo
from .utils import dump_op_stats, extract_linear

_FLOAT_SKIP = ("fp32", "bf16", "fp16", "float32", "bfloat16", "float16")


def rtn_quantize_kernel(kernel: torch.Tensor, cfg) -> QTensor:
    """Quantize one [K, N] kernel per an RTN-style config; with
    ``use_mse_search`` each group is first clipped to its best ratio of
    its absmax (``search_clip``)."""
    w = kernel.to(torch.float32)
    if getattr(cfg, "use_mse_search", False):
        ratios = search_clip(w, bits=cfg.weight_bits,
                             group_size=cfg.group_size, scheme=cfg.scheme,
                             dtype=cfg.weight_dtype)
        K, N = w.shape
        G = cfg.group_size if cfg.group_size > 0 else K
        wg = torch.nn.functional.pad(w, (0, 0, 0, (-K) % G)).reshape(-1, G, N)
        lim = wg.abs().amax(dim=1, keepdim=True) * ratios[:, None, :]
        w = torch.clamp(wg, -lim, lim).reshape(-1, N)[:K]
    return quantize_tensor(w, bits=cfg.weight_bits, group_size=cfg.group_size,
                           scheme=cfg.scheme, dtype=cfg.weight_dtype,
                           full_range=getattr(cfg, "use_full_range", False))


def _rtn_pack(kernel: torch.Tensor, cfg) -> PackedWeight:
    pw = pack_qtensor(rtn_quantize_kernel(kernel, cfg))
    if getattr(cfg, "use_double_quant", False):
        # int8 codes of the scales in storage, resolved at kernel entry
        pw = apply_double_quant(pw, bits=cfg.double_quant_bits,
                                group_size=cfg.double_quant_group_size,
                                sym=cfg.double_quant_use_sym)
    return pw


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
