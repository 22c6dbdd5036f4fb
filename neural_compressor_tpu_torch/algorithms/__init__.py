"""Algorithm registry: config name -> entry function.

The counterpart of ``neural_compressor_tpu.algorithms``. Entries import
lazily on first dispatch; RTN, GPTQ, hybrid GPTQ and KV-cache
quantization are ported so far, and a registered name without a port
raises ``NotImplementedError``.
"""

from __future__ import annotations

import importlib
from typing import Callable

algos_mapping: dict[str, Callable] = {}

# algo name -> module that defines/registers its entry
_LAZY_ENTRIES = {
    "rtn": ".rtn",
    "gptq": ".gptq",
    "kv_cache": ".kv_cache",
    "hybrid_gptq": ".hybrid_gptq",
}

# algorithms of the JAX package that the port has not reached yet
_NOT_PORTED = ("awq", "teq", "autoround", "hqq", "smooth_quant",
               "static_quant", "dynamic_quant", "fp8_quant", "mx_quant",
               "mixed_precision", "qat")


def register_algo(name: str) -> Callable:
    def decorator(fn: Callable) -> Callable:
        algos_mapping[name] = fn
        return fn

    return decorator


def get_algo_entry(name: str) -> Callable:
    if name not in algos_mapping and name in _LAZY_ENTRIES:
        importlib.import_module(_LAZY_ENTRIES[name], package=__name__)
    if name in algos_mapping:
        return algos_mapping[name]
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"algorithm {name!r} waits for the port of "
            f"neural_compressor_tpu.algorithms (entry {name!r})")
    raise KeyError(f"no algorithm registered under {name!r}")
