"""Structured JSON logging, zerolog-style.

The reference emits zerolog JSON to stderr with unix-ms timestamps and a
per-process ``node`` field (the reference's ``cmd/main.go:35-44``); the log
stream doubles as the metrics system (phase markers like ``"timer start"``,
per-transfer throughputs), merged offline by ``conf/collect_logs.sh``.
This module reproduces that: one JSON object per line with ``level``,
``time`` (unix ms), ``node``, ``message``, plus arbitrary fields.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from typing import IO, Optional

_lock = threading.Lock()


class JsonLogger:
    """zerolog-equivalent: ``log.info("msg", layer=3, mibps=812.5)``."""

    LEVELS = {"debug": 0, "info": 1, "warn": 2, "error": 3}

    def __init__(
        self,
        node: Optional[str] = None,
        stream: Optional[IO[str]] = None,
        level: str = "info",
    ):
        self.node = node
        self.stream = stream if stream is not None else sys.stderr
        self.level = level

    def with_node(self, node: str) -> "JsonLogger":
        return JsonLogger(node=node, stream=self.stream, level=self.level)

    def _emit(self, level: str, message: str, **fields) -> None:
        if self.LEVELS[level] < self.LEVELS[self.level]:
            return
        rec = {"level": level, "time": int(time.time() * 1000)}
        if self.node is not None:
            rec["node"] = self.node
        rec.update(fields)
        rec["message"] = message
        line = json.dumps(rec, default=str)
        with _lock:
            self.stream.write(line + "\n")
            self.stream.flush()

    def debug(self, message: str = "", **fields) -> None:
        self._emit("debug", message, **fields)

    def info(self, message: str = "", **fields) -> None:
        self._emit("info", message, **fields)

    def warn(self, message: str = "", **fields) -> None:
        self._emit("warn", message, **fields)

    def error(self, message: str = "", **fields) -> None:
        self._emit("error", message, **fields)


# Module-level default logger; configure() mutates it in place so modules
# that imported `log` by value (``from ...utils import log``) see the update.
log = JsonLogger()


def configure(node: Optional[str] = None, verbose: bool = False,
              stream: Optional[IO[str]] = None) -> JsonLogger:
    """Set up the global logger like cmd/main.go:35-44 (-v => debug)."""
    log.node = node
    log.stream = stream if stream is not None else sys.stderr
    log.level = "debug" if verbose else "info"
    return log
