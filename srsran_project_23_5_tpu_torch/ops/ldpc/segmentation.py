"""Transport-block segmentation / desegmentation (TS 38.212 §5.2.2).

Counterpart of ``srsran_project_23_5_tpu/ops/ldpc/segmentation.py``: TB-CRC
and per-CB CRC24B attachment with filler insertion, over a leading batch.
"""
from __future__ import annotations

import torch

from ...ran.ldpc_params import SegmentParams
from .. import crc as crc_ops


def _tb_crc_name(params: SegmentParams) -> str:
    return "crc24A" if params.tb_crc_bits == 24 else "crc16"


def segment_tx(tb_bits: torch.Tensor, params: SegmentParams) -> torch.Tensor:
    """[B, A] TB bits → [B, C, K] codeblock messages (filler = 0)."""
    bsz = tb_bits.shape[0]
    with_crc = crc_ops.crc_attach(tb_bits, _tb_crc_name(params))  # [B, A+L]
    c = params.nof_segments
    payload = params.payload_length - params.cb_crc_bits
    if with_crc.shape[-1] != c * payload:
        raise ValueError(f"TB of {tb_bits.shape[-1]} bits does not match "
                         f"{c} segments of {payload}")
    segments = with_crc.reshape(bsz, c, payload)
    if params.cb_crc_bits:
        segments = crc_ops.crc_attach(segments, "crc24B")         # [B, C, K']
    filler = segments.new_zeros((bsz, c, params.nof_filler_bits))
    return torch.cat([segments, filler], dim=-1)                  # [B, C, K]


def desegment_rx(cb_bits: torch.Tensor, params: SegmentParams
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """[B, C, K] decoded messages → (tb [B, A], tb_crc_ok [B],
    cb_crc_ok [B, C])."""
    bsz = cb_bits.shape[0]
    payload_with_crc = cb_bits[..., :params.payload_length]
    if params.cb_crc_bits:
        cb_ok = crc_ops.crc_check(payload_with_crc, "crc24B")
        payload = payload_with_crc[..., :-params.cb_crc_bits]
    else:
        cb_ok = torch.ones(cb_bits.shape[:-1], dtype=torch.bool,
                           device=cb_bits.device)
        payload = payload_with_crc
    tb_with_crc = payload.reshape(bsz, -1)
    tb_ok = crc_ops.crc_check(tb_with_crc, _tb_crc_name(params))
    return tb_with_crc[..., :-params.tb_crc_bits], tb_ok, cb_ok
