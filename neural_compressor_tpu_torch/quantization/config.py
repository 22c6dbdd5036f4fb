"""Config classes of the port: weight-only RTN and KV-cache quantization.

The same user-facing knobs and tuning semantics as
``neural_compressor_tpu.quantization.config``; op granularity is the
module type name ("Linear"; "...Attention" for the KV cache).
"""

from __future__ import annotations

from ..common.config import BaseConfig, register_config, DEFAULT_WHITE_LIST

LM_HEAD_NAMES = ("lm_head", "embed_out", "output_layer")
# MoE router gates stay fp by default (tiny, accuracy-critical)
ROUTER_SUFFIXES = (".gate",)

# op type names treated as Linear-like by the port's modules
LINEAR_TYPES = ("Linear",)


def _lm_head_filter(mapping, quant_lm_head: bool):
    if quant_lm_head:
        return mapping
    return {
        (name, t): cfg for (name, t), cfg in mapping.items()
        if not any(h in name for h in LM_HEAD_NAMES)
    }


class _WOQBase(BaseConfig):
    """Shared fields of the weight-only configs."""

    def __init__(self, dtype="int4", bits=4, use_sym=True, group_size=32,
                 group_dim=0, use_full_range=False, use_mse_search=False,
                 use_double_quant=False, double_quant_dtype="int",
                 double_quant_bits=8, double_quant_use_sym=False,
                 double_quant_group_size=256, quant_lm_head=False,
                 white_list=DEFAULT_WHITE_LIST):
        super().__init__(white_list=white_list)
        self.dtype = dtype
        self.bits = bits
        self.use_sym = use_sym
        self.group_size = group_size
        self.group_dim = group_dim
        self.use_full_range = use_full_range
        self.use_mse_search = use_mse_search
        self.use_double_quant = use_double_quant
        self.double_quant_dtype = double_quant_dtype
        self.double_quant_bits = double_quant_bits
        self.double_quant_use_sym = double_quant_use_sym
        self.double_quant_group_size = double_quant_group_size
        self.quant_lm_head = quant_lm_head

    @classmethod
    def supported_op_types(cls):
        return LINEAR_TYPES

    def to_config_mapping(self, model_info):
        mapping = _lm_head_filter(super().to_config_mapping(model_info),
                                  self.quant_lm_head)
        return {(n, t): c for (n, t), c in mapping.items()
                if not n.endswith(ROUTER_SUFFIXES)}

    @property
    def weight_dtype(self) -> str:
        d = self.dtype
        if d.startswith("int"):
            return "int"
        return d

    @property
    def weight_bits(self) -> int:
        """Reconcile ``dtype`` and ``bits``: whichever field was moved off
        its class default (dtype "int4" / bits 4) wins; two conflicting
        non-default values raise."""
        d, b = self.dtype, self.bits
        if d in ("nf4", "fp4", "fp4_e2m1"):
            if isinstance(b, int) and b != 4:
                raise ValueError(f"dtype={d!r} is 4-bit but bits={b}")
            return 4
        if d.startswith("int") and len(d) > 3:
            w = int(d[3:])
            if isinstance(b, int) and b != w:
                if d == "int4":
                    return b  # bits set explicitly; dtype is the default
                if b == 4:
                    return w  # dtype set explicitly; bits is the default
                raise ValueError(
                    f"conflicting dtype={d!r} ({w}-bit) and bits={b}")
            return w
        return b

    @property
    def scheme(self) -> str:
        return "sym" if self.use_sym else "asym"


@register_config("rtn", priority=70)
class RTNConfig(_WOQBase):
    """Round-to-nearest weight-only quantization."""


@register_config("kv_cache", priority=8)
class KVCacheQuantConfig(BaseConfig):
    """KV-cache quantization: int8, fp8-e4m3 or int4 codes with per-(token,
    head) scales (int4: asymmetric, with offsets). Applies to the attention
    modules that hold a KV cache; the cache is one model-level allocation,
    so the format is model-global (``algorithms/kv_cache.py``)."""

    params_list = ("dtype",)

    def __init__(self, dtype="int8", per_head_scales=True,
                 per_channel_k=False, white_list=DEFAULT_WHITE_LIST):
        super().__init__(white_list=white_list)
        self.dtype = dtype
        self.per_head_scales = per_head_scales
        # int4 only: calibrated per-(kv-head, channel) K scales
        self.per_channel_k = per_channel_k

    @classmethod
    def supported_op_types(cls):
        return None  # matched by type suffix below

    def to_config_mapping(self, model_info):
        mapping = {}
        for n, t in model_info:
            if not (t.endswith("Attention") or t.endswith("KVCache")):
                continue
            cfg = self
            for pattern, local in self._local_configs.items():
                if self._match(pattern, n, t):
                    cfg = local
                    break
            mapping[(n, t)] = cfg
        return mapping
