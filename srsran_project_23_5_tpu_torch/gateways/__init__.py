"""Network gateways (reference lib/gateways): message-oriented transports
for the application protocols + UDP for GTP-U.

The reference uses SCTP (one message per SCTP datagram). This framework
provides the same message-boundary-preserving API over:
- LocalConnector: in-process pair (like the reference's integration-test
  adapters, tests/integrationtests/du_cu_cp).
- TcpMessageGateway: length-prefixed framing over TCP (SCTP stand-in —
  lksctp is not assumed available).
- UdpGateway: datagram tx/rx for GTP-U, driven by the io_broker.
"""
from __future__ import annotations

import socket
import struct
import threading
from typing import Callable, Optional

from ..support.io_broker import IoBroker


class LocalConnector:
    """Bidirectional in-process message pipe: a.send → b.on_rx."""

    def __init__(self) -> None:
        self.a = _LocalEnd()
        self.b = _LocalEnd()
        self.a._peer = self.b
        self.b._peer = self.a


class _LocalEnd:
    def __init__(self) -> None:
        self.on_rx: Callable[[bytes], None] = lambda m: None
        self._peer: Optional["_LocalEnd"] = None

    def send(self, msg: bytes) -> None:
        assert self._peer is not None
        self._peer.on_rx(bytes(msg))


class TcpMessageGateway:
    """u32-length-prefixed message stream over TCP (SCTP stand-in)."""

    def __init__(self, sock: socket.socket,
                 on_rx: Callable[[bytes], None],
                 broker: Optional[IoBroker] = None) -> None:
        self._sock = sock
        self.on_rx = on_rx
        self._buf = b""
        self._lock = threading.Lock()
        self._broker = broker
        if broker is not None:
            sock.setblocking(False)
            broker.register_fd(sock, self._on_readable)

    @classmethod
    def connect(cls, host: str, port: int,
                on_rx: Callable[[bytes], None],
                broker: Optional[IoBroker] = None) -> "TcpMessageGateway":
        s = socket.create_connection((host, port), timeout=5)
        s.settimeout(None)
        return cls(s, on_rx, broker)

    def send(self, msg: bytes) -> None:
        with self._lock:
            self._sock.sendall(struct.pack("!I", len(msg)) + msg)

    def _on_readable(self) -> None:
        try:
            data = self._sock.recv(65536)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            data = b""
        if not data:
            if self._broker is not None:
                self._broker.unregister_fd(self._sock)
            return
        self._buf += data
        while len(self._buf) >= 4:
            n = struct.unpack_from("!I", self._buf)[0]
            if len(self._buf) < 4 + n:
                break
            msg, self._buf = self._buf[4:4 + n], self._buf[4 + n:]
            self.on_rx(msg)

    def recv_blocking(self) -> bytes:
        """Synchronous receive (for broker-less test use)."""
        while True:
            if len(self._buf) >= 4:
                n = struct.unpack_from("!I", self._buf)[0]
                if len(self._buf) >= 4 + n:
                    msg = self._buf[4:4 + n]
                    self._buf = self._buf[4 + n:]
                    return msg
            data = self._sock.recv(65536)
            if not data:
                raise ConnectionError("peer closed")
            self._buf += data

    def close(self) -> None:
        if self._broker is not None:
            self._broker.unregister_fd(self._sock)
        self._sock.close()


class TcpServer:
    """Accepts TcpMessageGateway clients on a broker thread."""

    def __init__(self, host: str, port: int,
                 on_client: Callable[[TcpMessageGateway], None],
                 broker: IoBroker) -> None:
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(8)
        self._listener.setblocking(False)
        self.port = self._listener.getsockname()[1]
        self._on_client = on_client
        self._broker = broker
        broker.register_fd(self._listener, self._accept)

    def _accept(self) -> None:
        try:
            sock, _addr = self._listener.accept()
        except (BlockingIOError, OSError):
            return
        gw = TcpMessageGateway(sock, lambda m: None, self._broker)
        self._on_client(gw)

    def close(self) -> None:
        self._broker.unregister_fd(self._listener)
        self._listener.close()


class UdpGateway:
    """Datagram gateway for GTP-U (lib/gateways/udp_network_gateway)."""

    def __init__(self, bind_host: str = "127.0.0.1", bind_port: int = 0,
                 broker: Optional[IoBroker] = None,
                 on_rx: Callable[[bytes, tuple], None] = lambda d, a: None
                 ) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind((bind_host, bind_port))
        self.port = self._sock.getsockname()[1]
        self.on_rx = on_rx
        self._broker = broker
        if broker is not None:
            self._sock.setblocking(False)
            broker.register_fd(self._sock, self._on_readable)

    def send_to(self, data: bytes, host: str, port: int) -> None:
        self._sock.sendto(data, (host, port))

    def _on_readable(self) -> None:
        while True:
            try:
                data, addr = self._sock.recvfrom(65536)
            except (BlockingIOError, OSError):
                return
            self.on_rx(data, addr)

    def close(self) -> None:
        if self._broker is not None:
            self._broker.unregister_fd(self._sock)
        self._sock.close()
