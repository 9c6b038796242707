"""RLC layer (TS 38.322) — TM/UM/AM entities (reference lib/rlc).

Entities expose the MAC-facing pull interface (pull_pdu(nof_bytes) called
at scheduling opportunities, like rlc_tx_am_entity::pull_pdu) and the
upper-layer SDU interface; rx entities consume MAC PDUs and deliver SDUs
in order to the upper layer callback.
"""
from .pdu import (AmHeader, StatusNack, StatusPdu, UmHeader, am_decode,
                  am_encode, status_decode, status_encode, um_decode,
                  um_encode)
from .tm import RlcTmRx, RlcTmTx
from .um import RlcUmRx, RlcUmTx
from .am import RlcAmConfig, RlcAmEntity

__all__ = [
    "AmHeader", "StatusNack", "StatusPdu", "UmHeader", "am_decode",
    "am_encode", "status_decode", "status_encode", "um_decode", "um_encode",
    "RlcTmRx", "RlcTmTx", "RlcUmRx", "RlcUmTx", "RlcAmConfig", "RlcAmEntity",
]
