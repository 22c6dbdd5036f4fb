from .config import (
    BaseConfig,
    ComposableConfig,
    ConfigRegistry,
    config_registry,
    register_config,
    DEFAULT_WHITE_LIST,
)
from .device import resolve_device
from .logger import logger, set_log_level
from .utility import options, Options, Statistics
