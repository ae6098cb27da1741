"""Structured metrics logging.

Counterpart of ``kb2e_tpu/utils/logging.py``.  The reference logs via raw
printf (per-epoch loss at common/trainer.cpp:105).  Here metrics are emitted
as JSONL records through pluggable sinks; TensorBoard is optional and
imported only when a TensorBoard sink is made.
"""

from __future__ import annotations

import json
import time
from typing import Callable, Optional, TextIO


class MetricsLogger:
    """Sends each record, stamped with ``ts``, to a sink and/or a stream."""

    def __init__(self, sink: Optional[Callable[[dict], None]] = None, stream: Optional[TextIO] = None,
                 owns_stream: bool = False):
        self._sink = sink
        self._stream = stream
        self._owns_stream = owns_stream

    def log(self, record: dict) -> None:
        record = {"ts": time.time(), **record}
        if self._sink is not None:
            self._sink(record)
        if self._stream is not None:
            self._stream.write(json.dumps(record) + "\n")
            self._stream.flush()

    def close(self) -> None:
        """Closes the stream if this logger opened it."""
        if self._owns_stream and self._stream is not None:
            self._stream.close()
            self._stream = None


def jsonl_logger(path: str) -> MetricsLogger:
    """A logger appending JSONL to ``path``."""
    return MetricsLogger(stream=open(path, "a", encoding="utf-8"), owns_stream=True)


class TensorBoardSink:
    """Optional TensorBoard scalar sink.

    Imports ``torch.utils.tensorboard`` only when made, so a machine without
    the ``tensorboard`` package trains as long as no TensorBoard directory is
    asked for.
    """

    def __init__(self, log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            raise ImportError(
                "TensorBoard logging needs the 'tensorboard' package; use the JSONL "
                "metrics sink (--metrics-jsonl) instead"
            ) from e
        self._writer = SummaryWriter(log_dir)

    def __call__(self, record: dict) -> None:
        step = int(record.get("epoch", 0))
        for key, value in record.items():
            if key in ("ts", "epoch"):
                continue
            # bools are ints in Python; logging them as 0/1 scalars would be
            # silent garbage — skip them.
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                self._writer.add_scalar(key, value, step)
        self._writer.flush()

    def close(self) -> None:
        self._writer.close()


def fan_out(*fns: Optional[Callable[[dict], None]]) -> Optional[Callable[[dict], None]]:
    """Compose metric sinks; None entries are dropped (None if all are)."""
    live = [f for f in fns if f is not None]
    if not live:
        return None
    if len(live) == 1:
        return live[0]

    def emit(record: dict) -> None:
        for f in live:
            f(record)

    return emit
