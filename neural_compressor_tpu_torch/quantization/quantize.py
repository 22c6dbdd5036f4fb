"""``quantize`` — one-shot quantization over the registered algorithms.

The counterpart of ``neural_compressor_tpu.quantization.quantize.quantize``
for calibration-free configs: each config (each member of a
``ComposableConfig``, in order, as JAX's ``_config_items``/``_dispatch``
apply them) resolves its op mapping over the model's modules and hands it
to its algorithm's entry.
"""

from __future__ import annotations

from typing import Callable

from ..algorithms import get_algo_entry
from ..common import logger
from ..common.config import BaseConfig, ComposableConfig
from ..layers.module_utils import get_model_info


def _config_items(quant_config: BaseConfig) -> list[BaseConfig]:
    if isinstance(quant_config, ComposableConfig):
        return list(quant_config.config_list)
    return [quant_config]


def quantize(model, quant_config: BaseConfig, run_fn: Callable | None = None,
             run_args=None, example_inputs=None):
    """One-shot prepare -> calibrate -> convert; returns the (mutated) model."""
    for cfg in _config_items(quant_config):
        model_info = get_model_info(model, cfg.supported_op_types())
        configs_mapping = cfg.to_config_mapping(model_info)
        if not configs_mapping:
            logger.warning("Config %s matched no ops; skipping.", cfg.name)
            continue
        entry = get_algo_entry(cfg.name)
        logger.info("[quantize] applying %s to %d ops", cfg.name,
                    len(configs_mapping))
        model = entry(model, configs_mapping, mode="quantize", run_fn=run_fn,
                      run_args=run_args, example_inputs=example_inputs,
                      config=cfg)
    return model
