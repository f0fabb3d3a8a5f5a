"""Structured metrics: JSONL sinks for training epochs and rendered frames.

A copy of ``pathtrace_tpu.utils.metrics`` (standard library only): the
reference logs only to stdout (loss/PSNR prints ``denoise_cnn/train.py:
30,45``, per-frame ms ``src/main.cu:183``); here one line of JSON per event,
append-only, flushed line by line.
"""

from __future__ import annotations

import json
import os
import time
from typing import IO, Optional


class JsonlLogger:
    """Append-only JSONL event sink. ``None`` path -> no-op logger."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._fh: Optional[IO[str]] = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)

    def log(self, event: str, **fields) -> None:
        if self._fh is None:
            return
        rec = {"event": event, "time": time.time()}
        rec.update(fields)
        self._fh.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
