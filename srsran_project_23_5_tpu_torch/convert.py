"""Carry the JAX package's configurations over to the port, field by field.

This system has no weights: its parameters are the frozen configuration
dataclasses (and the 38.212 tables both packages read).  ``from_jax_carrier``,
``from_jax_sh`` and ``from_jax_mixed`` take a ``gnb_flagship.CarrierConfig``,
``sch.ShConfig`` or ``gnb_mixed.MixedSlotConfig`` of the JAX package as
arguments, so this module never imports JAX.  Fields the port does not carry
yet raise ``NotImplementedError`` naming the field.
"""
from __future__ import annotations

import dataclasses

from .models.gnb_flagship import CarrierConfig
from .models.gnb_mixed import MixedSlotConfig
from .phy.upper import csi_rs, pdcch, pucch, ssb
from .phy.upper.sch import ShConfig


def _refuse(cls: str, field: str, why: str) -> None:
    raise NotImplementedError(f"{cls}.{field}: {why} is not ported yet")


def _carry(port_cls, cfg, **converted):
    """The port's `port_cls` with every field taken from the JAX `cfg`
    (or from `converted`)."""
    return port_cls(**{f.name: converted.get(f.name, getattr(cfg, f.name))
                       for f in dataclasses.fields(port_cls)})


def from_jax_sh(cfg) -> ShConfig:
    """JAX ``sch.ShConfig`` → the port's ``ShConfig``."""
    if cfg.nof_layers > 2:
        _refuse("ShConfig", "nof_layers",
                f"{cfg.nof_layers}-layer spatial multiplexing")
    if cfg.uci.any:
        _refuse("ShConfig", "uci", "UCI multiplexed on PUSCH")
    if cfg.vrb_to_prb_interleaved:
        _refuse("ShConfig", "vrb_to_prb_interleaved",
                "interleaved VRB-to-PRB mapping")
    if cfg.time_interp:
        _refuse("ShConfig", "time_interp", "per-symbol time interpolation")
    return _carry(ShConfig, cfg)


def from_jax_carrier(cfg) -> CarrierConfig:
    """JAX ``gnb_flagship.CarrierConfig`` → the port's ``CarrierConfig``."""
    return CarrierConfig(mu=cfg.mu, nfft=cfg.nfft, nof_prb=cfg.nof_prb,
                         sh=from_jax_sh(cfg.sh))


def from_jax_mixed(cfg) -> MixedSlotConfig:
    """JAX ``gnb_mixed.MixedSlotConfig`` → the port's ``MixedSlotConfig``
    (flat channels, the time-domain PRACH occasion, every downlink check
    on, no UE-side decode, non-interleaved one-symbol CORESETs)."""
    if cfg.tdl_delays or cfg.tdl_gains:
        _refuse("MixedSlotConfig", "tdl_delays",
                "the frequency-selective channel")
    if not cfg.prach_time_domain:
        _refuse("MixedSlotConfig", "prach_time_domain",
                "the grid-level PRACH occasion")
    if cfg.ue_decode_dl:
        _refuse("MixedSlotConfig", "ue_decode_dl",
                "the UE-side PDSCH decode")
    for field in ("verify_dl_sch", "verify_dl_ctrl"):
        if not getattr(cfg, field):
            _refuse("MixedSlotConfig", field, "switching a downlink check off")
    for name in ("pdcch_dl", "pdcch_ul"):
        if getattr(cfg, name).interleaved:
            _refuse("PdcchConfig", "interleaved",
                    "interleaved CCE-to-REG mapping")
        if getattr(cfg, name).nof_symbols != 1:
            _refuse("PdcchConfig", "nof_symbols", "a multi-symbol CORESET")
    shs = {name: from_jax_sh(getattr(cfg, name))
           for name in ("pdsch0", "pdsch1", "pusch0", "pusch1")}
    return _carry(MixedSlotConfig, cfg, **shs,
                  pdcch_dl=_carry(pdcch.PdcchConfig, cfg.pdcch_dl),
                  pdcch_ul=_carry(pdcch.PdcchConfig, cfg.pdcch_ul),
                  ssb=_carry(ssb.SsbConfig, cfg.ssb),
                  csi_rs=_carry(csi_rs.CsiRsConfig, cfg.csi_rs),
                  pucch=_carry(pucch.PucchF1Config, cfg.pucch))
