"""Logging and wall-clock timing helpers (parity: ``alpha_zero/utils/util.py:15-96``)."""

from __future__ import annotations

import logging
import sys
import time
import timeit
from collections import deque


def get_time_stamp(file_name: bool = False) -> str:
    t = time.localtime()
    if file_name:
        return time.strftime("%Y%m%d_%H%M%S", t)
    return time.strftime("%Y-%m-%d %H:%M:%S", t)


def create_logger(level: str = "INFO") -> logging.Logger:
    logger = logging.getLogger("alpha_zero_tpu_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(stream=sys.stderr)
        handler.setFormatter(
            logging.Formatter(
                fmt="%(levelname)s %(asctime)s %(filename)s:%(lineno)d] %(message)s",
                datefmt="%Y-%m-%d %H:%M:%S",
            )
        )
        logger.addHandler(handler)
    logger.setLevel(logging.DEBUG if str(level).upper() == "DEBUG" else logging.INFO)
    return logger


class Timer:
    """Context manager tracking mean duration over the last ``max_history`` uses."""

    def __init__(self, max_history: int = 100) -> None:
        self.history: deque = deque(maxlen=max_history)

    def __enter__(self) -> "Timer":
        self._start = timeit.default_timer()
        return self

    def __exit__(self, *args) -> None:
        self.history.append(timeit.default_timer() - self._start)

    def mean_time(self) -> float:
        if not self.history:
            return 0.0
        return sum(self.history) / len(self.history)

    def last_time(self) -> float:
        if not self.history:
            return 0.0
        return self.history[-1]
