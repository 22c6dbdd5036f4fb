"""KV-cache quantization entry.

The counterpart of ``neural_compressor_tpu.algorithms.kv_cache``. The
cache is a list of tensors the caller allocates
(``models.llama.init_kv_cache`` / ``init_paged_pool``), so quantizing it
reduces to flagging the model: ``kv_cache_quantized`` and
``kv_cache_format`` tell generation and serving which cache to allocate,
and the attention modules consume ``QuantKVCache`` and quantized page
pools as they come.

``per_channel_k`` (calibrated per-(kv-head, channel) int4 K scales) needs
the calibration plumbing and raises ``NotImplementedError``.
"""

from __future__ import annotations

from ..common import logger
from ..layers.module_utils import named_modules
from . import register_algo

_KV_FORMATS = ("int8", "fp8_e4m3", "int4")


def _attention_modules(model):
    for _name, mod in named_modules(model):
        if type(mod).__name__.endswith("Attention") and hasattr(mod, "cfg"):
            yield mod


@register_algo("kv_cache")
def kv_cache_entry(model, configs_mapping, mode="quantize", run_fn=None,
                   run_args=None, example_inputs=None, config=None):
    # one cache format for the whole model: per-op variants are rejected
    # rather than silently resolved to whichever op comes first
    variants = set()
    for (_name, _t), cfg in configs_mapping.items():
        dt = getattr(cfg, "dtype", "int8")
        if dt in ("fp8", "fp8_e4m3", "float8_e4m3"):
            dt = "fp8_e4m3"
        if dt not in _KV_FORMATS:
            raise ValueError(
                f"KVCacheQuantConfig.dtype={dt!r} unsupported; "
                f"expected one of {_KV_FORMATS}")
        variants.add((dt, bool(getattr(cfg, "per_channel_k", False))))
    if len(variants) > 1:
        raise ValueError(
            "KV-cache quantization is model-global (one cache format); the "
            f"config mapping asks for {sorted(variants)} — per-op KV "
            "granularity is unsupported, use one (dtype, per_channel_k)")
    fmt, per_channel = variants.pop() if variants else ("int8", False)
    if per_channel and fmt != "int4":
        raise ValueError("per_channel_k applies to dtype='int4' only "
                         "(int8/fp8 per-token scales are already lossless)")
    if per_channel:
        raise NotImplementedError(
            "per_channel_k waits for the port of the calibrated K scales of "
            "neural_compressor_tpu.algorithms.kv_cache (the kv_observe "
            "observers, kv_k_scale and run_user_calibration)")
    if mode == "prepare":
        return model
    n = sum(1 for _ in _attention_modules(model))
    # model-level flags: init_kv_cache(..., quantized=model.kv_cache_format)
    model.kv_cache_quantized = True
    model.kv_cache_format = fmt
    logger.info("KV-cache quantization enabled (%s, per-token-per-head "
                "scales) for %d attention modules", fmt, n)
    return model
