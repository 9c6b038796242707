"""Async logging (reference lib/srslog): front-end channels → lock-free
work queue → backend worker thread → sinks.

Formatting happens on the backend thread (backend_worker.h:34-49) so the
real-time slot path only enqueues (timestamp, channel, level, fmt, args)
tuples. Text and JSON formatters, stdout/file sinks, per-channel levels
and hex-dump limits mirror the reference's config surface.
"""
from __future__ import annotations

import json
import queue
import sys
import threading
import time
from typing import IO, Optional

LEVELS = {"none": 0, "error": 1, "warning": 2, "info": 3, "debug": 4}


class _Backend:
    def __init__(self) -> None:
        self._q: queue.Queue = queue.Queue()
        self._sinks: list[tuple[IO, str]] = [(sys.stdout, "text")]
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    def start(self, sinks: Optional[list[tuple[IO, str]]] = None) -> None:
        with self._lock:
            if sinks is not None:
                self._sinks = sinks
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(target=self._run,
                                                name="srslog", daemon=True)
                self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                break
            ts, channel, level, msg, hexdump = item
            for sink, fmt in self._sinks:
                try:
                    if fmt == "json":
                        sink.write(json.dumps(
                            {"ts": ts, "ch": channel, "lvl": level,
                             "msg": msg,
                             **({"hex": hexdump} if hexdump else {})}) + "\n")
                    else:
                        line = f"{ts:.6f} [{channel:<8}] [{level[0].upper()}] {msg}"
                        if hexdump:
                            line += f" hex={hexdump}"
                        sink.write(line + "\n")
                    sink.flush()
                except Exception:  # noqa: BLE001 - sinks must never kill us
                    pass

    def push(self, item) -> None:
        if self._thread is None:
            self.start()
        self._q.put(item)

    def flush(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            return
        done = threading.Event()
        # sentinel formatted as a zero-sink message
        self._q.put((0.0, "__flush__", "none", "", None))
        while not self._q.empty():
            time.sleep(0.001)
        done.set()


_BACKEND = _Backend()


class LogChannel:
    """Front-end: non-blocking enqueue with per-channel level + hex limit."""

    def __init__(self, name: str, level: str = "warning",
                 hex_max_size: int = 0) -> None:
        self.name = name
        self.level = LEVELS[level]
        self.hex_max_size = hex_max_size

    def set_level(self, level: str) -> None:
        self.level = LEVELS[level]

    def _log(self, level: str, msg: str, *args,
             hexdump: bytes | None = None) -> None:
        if LEVELS[level] > self.level:
            return
        if args:
            msg = msg.format(*args)
        hd = None
        if hexdump is not None and self.hex_max_size:
            hd = bytes(hexdump[: self.hex_max_size]).hex()
        _BACKEND.push((time.time(), self.name, level, msg, hd))

    def error(self, msg: str, *args, **kw) -> None:
        self._log("error", msg, *args, **kw)

    def warning(self, msg: str, *args, **kw) -> None:
        self._log("warning", msg, *args, **kw)

    def info(self, msg: str, *args, **kw) -> None:
        self._log("info", msg, *args, **kw)

    def debug(self, msg: str, *args, **kw) -> None:
        self._log("debug", msg, *args, **kw)


_CHANNELS: dict[str, LogChannel] = {}


def get_logger(name: str, level: str = "warning") -> LogChannel:
    if name not in _CHANNELS:
        _CHANNELS[name] = LogChannel(name, level)
    return _CHANNELS[name]


def init_logging(filename: Optional[str] = None, fmt: str = "text",
                 level: str = "info") -> None:
    sinks: list[tuple[IO, str]] = []
    if filename:
        sinks.append((open(filename, "a"), fmt))
    else:
        sinks.append((sys.stdout, fmt))
    _BACKEND.start(sinks)
    for ch in _CHANNELS.values():
        ch.set_level(level)


def flush_logs() -> None:
    _BACKEND.flush()
