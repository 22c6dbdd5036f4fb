"""Hybrid GPTQ: W4A8 (int4 weights from GPTQ, int8 activations).

The counterpart of ``neural_compressor_tpu/algorithms/hybrid_gptq.py``:
GPTQ quantizes the int4 weights, then every ``WOQLinear`` becomes a
``W4A8Linear`` on the same "tpu_strided" words, as JAX leaves them.
``to_w4a8_serving`` then moves them to a serving layout in place
("hopper_nk" by default, "s4_rowpack" with ``s4="s4"``), or, with
``s4=False`` or a raised ``W4A8Linear.M_INT8_THRESHOLD``, they stay and
are served by K1 on those words and K10 at M == 1.
"""

from __future__ import annotations

from ..common import logger
from ..layers.module_utils import named_modules, replace_module
from ..layers.woq_linear import W4A8Linear, WOQLinear
from . import register_algo
from .gptq import gptq_entry


@register_algo("hybrid_gptq")
def hybrid_gptq_entry(model, configs_mapping, mode="quantize", run_fn=None,
                      run_args=None, example_inputs=None, config=None):
    model = gptq_entry(model, configs_mapping, mode=mode, run_fn=run_fn,
                       run_args=run_args, example_inputs=example_inputs,
                       config=config)
    if mode == "prepare":
        return model
    n = 0
    for path, mod in list(named_modules(model)):
        if type(mod) is WOQLinear:
            w4a8 = W4A8Linear(mod.packed_weight(), bias=mod.bias,
                              impl=mod.impl, pre_scale=mod.pre_scale)
            fp8 = getattr(mod, "scale_bf16_to_fp8", None)
            if fp8 is not None:
                w4a8.register_buffer("scale_bf16_to_fp8", fp8)
            replace_module(model, path, w4a8)
            n += 1
    logger.info("Hybrid GPTQ: %d modules serving W4A8", n)
    return model
