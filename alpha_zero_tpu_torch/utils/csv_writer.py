"""Buffered CSV metrics sink.

Produces the same CSV schemas as the reference (`alpha_zero/utils/csv_writer.py:13-78`)
so its plotting / aggregation scripts keep working: append-mode, header written
once, rows flushed by count or by wall-clock interval.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Mapping


class CsvWriter:
    """Appends dict rows to a CSV file, buffering writes."""

    def __init__(self, fname: str, buffer_size: int = 100, flush_interval: float = 60.0) -> None:
        dirname = os.path.dirname(fname)
        if dirname and not os.path.exists(dirname):
            os.makedirs(dirname, exist_ok=True)
        self._fname = fname
        self._fieldnames = None
        self._header_written = not self._file_is_empty()
        self._buffer: list[Mapping[str, Any]] = []
        self._buffer_size = buffer_size
        self._flush_interval = flush_interval
        self._last_flush_time = time.time()

    def _file_is_empty(self) -> bool:
        try:
            return os.path.getsize(self._fname) == 0
        except OSError:
            return True

    def write(self, values: Mapping[str, Any]) -> None:
        """Appends one row; keys of the first row fix the schema."""
        if self._fieldnames is None:
            self._fieldnames = list(values.keys())
        self._buffer.append(values)
        if len(self._buffer) >= self._buffer_size or time.time() - self._last_flush_time >= self._flush_interval:
            self._flush()

    def close(self) -> None:
        self._flush()

    def _flush(self) -> None:
        if not self._buffer:
            return
        with open(self._fname, "a", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=self._fieldnames)
            if not self._header_written:
                writer.writeheader()
                self._header_written = True
            writer.writerows(self._buffer)
        self._buffer.clear()
        self._last_flush_time = time.time()
