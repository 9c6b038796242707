"""IO broker: epoll-style fd multiplexing on a dedicated thread
(reference lib/support/io_broker/io_broker_epoll.cpp).

Gateways (UDP GTP-U, SCTP-like control links) register sockets with a
receive callback; the broker thread dispatches readable events.
"""
from __future__ import annotations

import os
import selectors
import socket
import threading
from typing import Callable


class IoBroker:
    def __init__(self, name: str = "io_broker") -> None:
        self._sel = selectors.DefaultSelector()
        self._wakeup_r, self._wakeup_w = socket.socketpair()
        self._wakeup_r.setblocking(False)
        self._sel.register(self._wakeup_r, selectors.EVENT_READ, None)
        self._handlers: dict[int, Callable[[], None]] = {}
        self._lock = threading.Lock()
        self._running = True
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def register_fd(self, sock: socket.socket,
                    on_readable: Callable[[], None]) -> bool:
        with self._lock:
            try:
                self._sel.register(sock, selectors.EVENT_READ, on_readable)
            except (KeyError, ValueError):
                return False
            self._handlers[sock.fileno()] = on_readable
        self._wakeup_w.send(b"x")
        return True

    def unregister_fd(self, sock: socket.socket) -> bool:
        with self._lock:
            try:
                self._sel.unregister(sock)
                self._handlers.pop(sock.fileno(), None)
            except (KeyError, ValueError):
                return False
        self._wakeup_w.send(b"x")
        return True

    def _run(self) -> None:
        while self._running:
            events = self._sel.select(timeout=0.2)
            for key, _ in events:
                if key.fileobj is self._wakeup_r:
                    try:
                        self._wakeup_r.recv(4096)
                    except BlockingIOError:
                        pass
                    continue
                cb = key.data
                if cb is not None:
                    try:
                        cb()
                    except Exception:  # noqa: BLE001
                        import traceback
                        traceback.print_exc()

    def stop(self) -> None:
        self._running = False
        try:
            self._wakeup_w.send(b"x")
        except OSError:
            pass
        self._thread.join(timeout=2)
