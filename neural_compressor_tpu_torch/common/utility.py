"""Framework-agnostic utilities: the global options and statistics tables.

The slice of ``neural_compressor_tpu.common.utility`` that the port's main
path needs (``options``, its seed only, and ``Statistics``), with the same
behaviour; table rendering is dependency-free.
"""

from __future__ import annotations

import random
from typing import Any, Iterable, Sequence

import numpy as np

from .logger import logger


class Options:
    """Global options; the port's slice holds only the random seed."""

    def __init__(self, random_seed: int = 1978):
        self._random_seed = random_seed

    @property
    def random_seed(self) -> int:
        return self._random_seed

    @random_seed.setter
    def random_seed(self, seed: int) -> None:
        if not isinstance(seed, int):
            raise TypeError("random_seed must be an int")
        self._random_seed = seed
        random.seed(seed)
        np.random.seed(seed % (2**32))


options = Options()


def _render_table(header: str, field_names: Sequence[str],
                  rows: Iterable[Sequence[Any]]) -> str:
    rows = [[str(c) for c in row] for row in rows]
    widths = [len(f) for f in field_names]
    for row in rows:
        for i, cell in enumerate(row):
            widths[i] = max(widths[i], len(cell))
    sep = "+" + "+".join("-" * (w + 2) for w in widths) + "+"
    lines = [header, sep,
             "|" + "|".join(f" {f:<{w}} " for f, w in zip(field_names, widths)) + "|",
             sep]
    for row in rows:
        lines.append("|" + "|".join(f" {c:<{w}} " for c, w in zip(row, widths)) + "|")
    lines.append(sep)
    return "\n".join(lines)


class Statistics:
    """Tabular statistics printer (op-dtype summaries)."""

    def __init__(self, data: Iterable[Sequence[Any]], header: str,
                 field_names: Sequence[str]):
        self.data = list(data)
        self.header = header
        self.field_names = list(field_names)

    def print_stat(self) -> None:
        for line in _render_table(self.header, self.field_names, self.data).splitlines():
            logger.info(line)

    def __str__(self) -> str:
        return _render_table(self.header, self.field_names, self.data)
