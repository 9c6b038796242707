"""Radio sessions (reference lib/radio): baseband tx/rx gateways.

Counterpart of ``srsran_project_23_5_tpu/radio/__init__.py``:

- InMemoryRadio: zero-copy loopback with an optional channel function
  (the srsRAN ZMQ virtual-RF equivalent collapsed in-process).  It hands
  back what it was given, so a tensor stays on its device and the channel
  function runs there.
- SocketRadio: virtual RF over UDP datagrams — IQ shipped as float32
  I/Q planes per slot, REQ/REP-style alternation like
  lib/radio/zmq/radio_zmq_tx_channel.cpp.  Host numpy: a tensor is copied
  to the host before it is sent, and what arrives is a numpy array.
- UHD hardware sessions are out of scope in this environment (no USRP);
  create_radio("uhd") raises with a pointer to the reference behavior.
"""
from __future__ import annotations

import socket
import struct
from typing import Callable, Optional

import numpy as np
import torch


class RadioSession:
    """radio_session interface (include/srsran/radio/radio_session.h)."""

    def transmit(self, samples, timestamp: int) -> None:
        raise NotImplementedError

    def receive(self) -> tuple[Optional[object], int]:
        raise NotImplementedError

    def stop(self) -> None:
        pass


class InMemoryRadio(RadioSession):
    def __init__(self, channel: Optional[Callable] = None) -> None:
        self._channel = channel or (lambda x: x)
        self._buf: list[tuple[object, int]] = []
        # event counters (radio_notification_handler.h:39-74)
        self.underflow_count = 0
        self.overflow_count = 0

    def transmit(self, samples, timestamp: int) -> None:
        if len(self._buf) > 8:
            self.overflow_count += 1
            self._buf.pop(0)
        self._buf.append((self._channel(samples), timestamp))

    def receive(self) -> tuple[Optional[object], int]:
        if not self._buf:
            self.underflow_count += 1
            return None, 0
        return self._buf.pop(0)


class SocketRadio(RadioSession):
    """UDP virtual RF: each datagram = u64 timestamp | u32 nof_samples |
    u32 offset | u32 count | float32 I plane | float32 Q plane (chunked
    under the MTU by slicing samples into ≤2048-sample datagrams)."""

    _CHUNK = 2048

    def __init__(self, bind_port: int = 0, peer: Optional[tuple] = None
                 ) -> None:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.bind(("127.0.0.1", bind_port))
        self._sock.settimeout(2.0)
        self.port = self._sock.getsockname()[1]
        self.peer = peer
        self._rx_acc: dict[int, list] = {}

    def transmit(self, samples, timestamp: int) -> None:
        assert self.peer is not None, "peer address not set"
        if isinstance(samples, torch.Tensor):
            samples = samples.cpu().numpy()
        samples = np.asarray(samples, dtype=np.complex64)
        for off in range(0, len(samples), self._CHUNK):
            part = samples[off:off + self._CHUNK]
            hdr = struct.pack("!QIII", timestamp, len(samples), off,
                              len(part))
            self._sock.sendto(
                hdr + part.real.astype("<f4").tobytes()
                + part.imag.astype("<f4").tobytes(), self.peer)

    def receive(self) -> tuple[Optional[np.ndarray], int]:
        while True:
            try:
                data, _addr = self._sock.recvfrom(65536)
            except socket.timeout:
                return None, 0
            ts, total, off, n = struct.unpack_from("!QIII", data)
            body = data[struct.calcsize("!QIII"):]
            i = np.frombuffer(body[: 4 * n], dtype="<f4")
            q = np.frombuffer(body[4 * n: 8 * n], dtype="<f4")
            acc = self._rx_acc.setdefault(ts, [np.zeros(total,
                                                        dtype=np.complex64),
                                               0])
            acc[0][off:off + n] = i + 1j * q
            acc[1] += n
            if acc[1] >= total:
                del self._rx_acc[ts]
                return acc[0], ts

    def stop(self) -> None:
        self._sock.close()


def create_radio(kind: str, **kw) -> RadioSession:
    if kind in ("loopback", "zmq"):        # zmq alias: the virtual RF role
        return InMemoryRadio(**kw)
    if kind in ("socket", "udp"):
        return SocketRadio(**kw)
    if kind == "uhd":
        raise RuntimeError(
            "UHD USRP sessions need hardware + the UHD driver (reference "
            "lib/radio/uhd); use 'socket' virtual RF in this environment")
    raise ValueError(f"unknown radio kind {kind!r}")
