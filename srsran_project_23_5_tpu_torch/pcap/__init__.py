"""Wireshark PCAP writers (reference lib/pcap).

- MacPcap: MAC NR PDUs in the Wireshark "mac-nr" UDP-framed format
  (DLT 149, udp header + "mac-nr" signature + context tags + payload;
  mac_pcap_impl.cpp:31-191).
- DltPcap: raw DLT capture used for F1AP (DLT 154) and E2AP (DLT 155)
  ASN.1 payloads (f1ap_pcap.cpp:29, e2ap_pcap.cpp:29).

Writing happens on the caller thread protected by a lock — PCAPs are a
debugging tap, not a hot-loop feature; the reference offloads to a worker
thread, which callers here can replicate by passing a TaskExecutor.
"""
from __future__ import annotations

import struct
import threading
import time
from typing import Optional

MAC_NR_START_STRING = b"mac-nr"
MAC_NR_PAYLOAD_TAG = 0x01
MAC_NR_RNTI_TAG = 0x02
MAC_NR_UEID_TAG = 0x03
MAC_NR_FRAME_SUBFRAME_TAG = 0x04
MAC_NR_HARQID = 0x06

UDP_DLT = 149
F1AP_DLT = 154
E2AP_DLT = 155

# radio/rnti type enums of the Wireshark mac-nr dissector
FDD_RADIO, TDD_RADIO = 1, 2
DIRECTION_UPLINK, DIRECTION_DOWNLINK = 0, 1
NO_RNTI, P_RNTI, RA_RNTI, C_RNTI, SI_RNTI = 0, 1, 2, 3, 4


class _PcapFile:
    def __init__(self, filename: str, dlt: int) -> None:
        self._f = open(filename, "wb")
        self._lock = threading.Lock()
        # pcap global header, usec resolution, snaplen 256 KiB
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  1 << 18, dlt))

    def write_record(self, payload: bytes) -> None:
        ts = time.time()
        sec, usec = int(ts), int((ts % 1) * 1e6)
        with self._lock:
            self._f.write(struct.pack("<IIII", sec, usec, len(payload),
                                      len(payload)))
            self._f.write(payload)
            self._f.flush()

    def close(self) -> None:
        with self._lock:
            self._f.close()


class DltPcap:
    """Raw-DLT capture (one record per PDU) for F1AP/E2AP/NGAP."""

    def __init__(self, filename: str, dlt: int = F1AP_DLT) -> None:
        self._file = _PcapFile(filename, dlt)

    def push_pdu(self, pdu: bytes) -> None:
        self._file.write_record(bytes(pdu))

    def close(self) -> None:
        self._file.close()


class MacPcap:
    """MAC NR capture in Wireshark udp-framed format."""

    def __init__(self, filename: str) -> None:
        self._file = _PcapFile(filename, UDP_DLT)

    def push_pdu(self, pdu: bytes, rnti: int, direction: int,
                 harq_id: int = 0, ueid: int = 0, system_frame: int = 0,
                 sub_frame: int = 0, rnti_type: int = C_RNTI,
                 radio_type: int = TDD_RADIO) -> None:
        ctx = bytearray()
        # fake UDP header (dest 0xdead, source 0xbeef) as the dissector key
        body_len = (8 + len(MAC_NR_START_STRING) + 3 + 3 + 3 + 2 + 3 + 1
                    + len(pdu))
        ctx += struct.pack("!HHHH", 0xBEEF, 0xDEAD, body_len, 0)
        ctx += MAC_NR_START_STRING
        ctx += bytes([radio_type, direction, rnti_type])
        ctx += bytes([MAC_NR_RNTI_TAG]) + struct.pack("!H", rnti)
        ctx += bytes([MAC_NR_UEID_TAG]) + struct.pack("!H", ueid)
        ctx += bytes([MAC_NR_HARQID, harq_id])
        ctx += bytes([MAC_NR_FRAME_SUBFRAME_TAG]) + struct.pack(
            "!H", ((system_frame & 0x3FF) << 4) | (sub_frame & 0xF))
        ctx += bytes([MAC_NR_PAYLOAD_TAG])
        self._file.write_record(bytes(ctx) + bytes(pdu))

    def close(self) -> None:
        self._file.close()
