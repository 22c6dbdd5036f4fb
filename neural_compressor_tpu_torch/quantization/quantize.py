"""``prepare`` / ``convert`` / ``quantize`` — the user-facing lifecycle.

The counterpart of ``neural_compressor_tpu.quantization.quantize``: each
config (each member of a ``ComposableConfig``, in order) resolves its op
mapping over the model's modules and hands it to its algorithm's entry.
``prepare`` inserts the calibration capture (GPTQ), the user runs their
calibration function, ``convert`` quantizes; ``quantize`` is the one-shot
form of the three.
"""

from __future__ import annotations

import weakref
from typing import Any, Callable

from ..algorithms import get_algo_entry
from ..common import logger
from ..common.config import BaseConfig, ComposableConfig
from ..layers.module_utils import get_model_info

# model -> state kept between prepare() and convert()
_prepared_state: "weakref.WeakKeyDictionary[Any, dict]" = \
    weakref.WeakKeyDictionary()


def _config_items(quant_config: BaseConfig) -> list[BaseConfig]:
    if isinstance(quant_config, ComposableConfig):
        return list(quant_config.config_list)
    return [quant_config]


def _dispatch(model, quant_config: BaseConfig, mode: str,
              run_fn: Callable | None = None, run_args=None,
              example_inputs=None):
    for cfg in _config_items(quant_config):
        model_info = get_model_info(model, cfg.supported_op_types())
        configs_mapping = cfg.to_config_mapping(model_info)
        if not configs_mapping:
            logger.warning("Config %s matched no ops; skipping.", cfg.name)
            continue
        entry = get_algo_entry(cfg.name)
        logger.info("[%s] applying %s to %d ops", mode, cfg.name,
                    len(configs_mapping))
        model = entry(model, configs_mapping, mode=mode, run_fn=run_fn,
                      run_args=run_args, example_inputs=example_inputs,
                      config=cfg)
    return model


def prepare(model, quant_config: BaseConfig, example_inputs=None):
    """Insert the calibration machinery; returns the (mutated) model."""
    model = _dispatch(model, quant_config, "prepare",
                      example_inputs=example_inputs)
    _prepared_state[model] = {"config": quant_config}
    return model


def convert(model, quant_config: BaseConfig | None = None,
            example_inputs=None):
    """Finalize quantization on a prepared (calibrated) model."""
    state = _prepared_state.pop(model, None)
    if quant_config is None:
        if state is None:
            raise ValueError("convert() without a config needs a model "
                             "returned by prepare()")
        quant_config = state["config"]
    return _dispatch(model, quant_config, "convert",
                     example_inputs=example_inputs)


def finalize_calibration(model):
    """Kept for the JAX package's API: statistics live in buffers and need
    no flushing."""
    return model


def quantize(model, quant_config: BaseConfig, run_fn: Callable | None = None,
             run_args=None, example_inputs=None):
    """One-shot prepare -> calibrate -> convert; returns the (mutated) model."""
    return _dispatch(model, quant_config, "quantize", run_fn=run_fn,
                     run_args=run_args, example_inputs=example_inputs)


# the run_fn / run_args dispatch shape, under the JAX package's name
from ..algorithms.quantize_helpers import \
    run_user_calibration as run_calibration  # noqa: E402,F401
