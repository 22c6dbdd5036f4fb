"""Logging for the PyTorch/CUDA port.

Provides a process-wide ``logger`` honoring the ``LOGLEVEL`` env var, in
the format of ``neural_compressor_tpu.common.logger``.
"""

from __future__ import annotations

import logging
import os
import sys

_LOGGER_NAME = "neural_compressor_tpu_torch"


def _build_logger() -> logging.Logger:
    log = logging.getLogger(_LOGGER_NAME)
    if log.handlers:
        return log
    level_name = os.environ.get("LOGLEVEL", "INFO").upper()
    level = getattr(logging, level_name, logging.INFO)
    log.setLevel(level)
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter(
            "%(asctime)s [%(levelname)s][%(filename)s:%(lineno)d] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
    )
    log.addHandler(handler)
    log.propagate = False
    return log


logger = _build_logger()


def set_log_level(level: int | str) -> None:
    if isinstance(level, str):
        level = getattr(logging, level.upper())
    logger.setLevel(level)

