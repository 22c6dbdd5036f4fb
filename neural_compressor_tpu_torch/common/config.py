"""Config core: algorithm configs with per-op overrides and a registry.

The slice of ``neural_compressor_tpu.common.config`` that the port's
quantize path needs, with the same behaviour, so that one config means the
same thing to both packages:

* every config has a *global* parameter set plus *local* per-op overrides
  keyed by op-name regex or op-type name;
* ``to_config_mapping(model_info)`` resolves ``{(op_name, op_type): config}``;
* ``register_config`` names each config class after its algorithm.

* ``a + b`` composes configs into a ``ComposableConfig`` that ``quantize``
  applies member by member (e.g. RTN weights + a quantized KV cache).

Tuning expansion and (de)serialization wait for the port of the tuning
loop.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Sequence

from .logger import logger

DEFAULT_WHITE_LIST = "*"


class ConfigRegistry:
    """Registry of config classes per algorithm name, each with the JAX
    package's priority (read by its tuning loop, not yet ported)."""

    def __init__(self):
        self._configs: dict[str, dict[str, Any]] = {}

    def register(self, algo_name: str, priority: float = 0) -> Callable:
        def decorator(config_cls):
            self._configs[algo_name] = {"cls": config_cls, "priority": priority}
            config_cls.name = algo_name
            return config_cls

        return decorator

    def get_config_cls_by_name(self, algo_name: str) -> type | None:
        entry = self._configs.get(algo_name)
        return entry["cls"] if entry else None


config_registry = ConfigRegistry()


def register_config(algo_name: str, priority: float = 0) -> Callable:
    """Class decorator: register a config class for ``algo_name``."""
    return config_registry.register(algo_name, priority=priority)


class BaseConfig:
    """Base class for all algorithm configs.

    Subclasses declare ``name`` (set by ``register_config``) and
    ``supported_op_types()``: the op types this algorithm applies to.
    """

    name: str = "base"

    def __init__(self, white_list: Sequence[str] | str | None = DEFAULT_WHITE_LIST):
        self._local_configs: dict[str, BaseConfig] = {}
        if isinstance(white_list, str) and white_list != DEFAULT_WHITE_LIST:
            # a bare string would be iterated character-by-character below
            white_list = [white_list]
        self.white_list = white_list

    def set_local(self, operator_pattern: str | type, config: "BaseConfig") -> "BaseConfig":
        """Attach a per-op override. ``operator_pattern`` is an op-name regex
        (fullmatch or prefix) or an op-type name."""
        key = operator_pattern if isinstance(operator_pattern, str) else operator_pattern.__name__
        if key in self._local_configs:
            logger.warning("Overwriting local config for %s", key)
        self._local_configs[key] = config
        return self

    def to_dict(self) -> dict[str, Any]:
        params = {k: v for k, v in self.__dict__.items()
                  if not k.startswith("_") and k != "white_list"}
        if not self._local_configs:
            return params
        return {"global": params,
                "local": {name: cfg.to_dict()
                          for name, cfg in self._local_configs.items()}}

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.to_dict()})"

    def __add__(self, other: "BaseConfig") -> "ComposableConfig":
        if isinstance(other, ComposableConfig):
            return ComposableConfig([self, *other.config_list])
        return ComposableConfig([self, other])

    @classmethod
    def supported_op_types(cls) -> tuple[str, ...] | None:
        return ("Linear",)

    def _match(self, pattern: str, op_name: str, op_type: str) -> bool:
        """Pattern semantics: exact op-type name, exact op name, regex
        fullmatch, or a regex match spanning whole dotted segments —
        ``"layers.1"`` matches ``model.layers.1.mlp.up_proj`` but NOT
        ``model.layers.10...`` (plain ``re.search`` would)."""
        if pattern == op_type or pattern == op_name:
            return True
        try:
            if re.fullmatch(pattern, op_name):
                return True
            for m in re.finditer(pattern, op_name):
                at_start = m.start() == 0 or op_name[m.start() - 1] == "."
                at_end = m.end() == len(op_name) or op_name[m.end()] == "."
                if at_start and at_end and m.end() > m.start():
                    return True
        except re.error:
            pass
        return False

    def to_config_mapping(
        self, model_info: Sequence[tuple[str, str]]
    ) -> dict[tuple[str, str], "BaseConfig"]:
        """Resolve per-op configs.

        ``model_info`` is ``[(op_name, op_type), ...]`` as produced by
        ``get_model_info`` on an ``nn.Module``. Local overrides win over the
        global config; a white_list other than "*" restricts coverage.
        """
        mapping: dict[tuple[str, str], BaseConfig] = {}
        for op_name, op_type in model_info:
            if op_type not in self.supported_op_types():
                continue
            wl = self.white_list
            if (wl is not None and wl != DEFAULT_WHITE_LIST
                    and DEFAULT_WHITE_LIST not in wl):  # ["*"] = no filter
                if not any(self._match(p, op_name, op_type) for p in wl):
                    continue
            cfg: BaseConfig = self
            for pattern, local in self._local_configs.items():
                if self._match(pattern, op_name, op_type):
                    cfg = local
                    break
            mapping[(op_name, op_type)] = cfg
        return mapping


class ComposableConfig(BaseConfig):
    """Several algorithm configs applied together (e.g. WOQ + KV-cache);
    ``quantize`` applies the members in order."""

    name = "composable"

    def __init__(self, config_list: list[BaseConfig]):
        super().__init__()
        self.config_list = list(config_list)

    def __add__(self, other: BaseConfig) -> "ComposableConfig":
        if isinstance(other, ComposableConfig):
            return ComposableConfig([*self.config_list, *other.config_list])
        return ComposableConfig([*self.config_list, other])

    def to_dict(self) -> dict[str, Any]:
        return {cfg.name: cfg.to_dict() for cfg in self.config_list}

    def to_config_mapping(self, model_info):
        mapping: dict[tuple[str, str], BaseConfig] = {}
        for cfg in self.config_list:
            mapping.update(cfg.to_config_mapping(model_info))
        return mapping
