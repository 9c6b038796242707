"""Carry the JAX package's configurations and FAPI messages over to the port,
field by field.

This system has no weights: its parameters are the frozen configuration
dataclasses (and the 38.212 tables both packages read).  ``from_jax_sh``,
``from_jax_carrier``, ``from_jax_mixed``, ``from_jax_upper_phy`` and
``from_jax_message`` take objects of the JAX package as arguments, so this
module never imports JAX.  ``from_jax_message`` turns a JAX FAPI request or
PDU into the port's, so both packages can be fed the same requests.  Fields
the port does not carry yet (3-layer shared channels, the upper PHY's
sanitizer) raise ``NotImplementedError`` naming the field.
"""
from __future__ import annotations

import dataclasses

from .fapi import messages
from .models.gnb_flagship import CarrierConfig
from .models.gnb_mixed import MixedSlotConfig
from .phy.upper import csi_rs, pdcch, pucch, ssb, ulsch
from .phy.upper.sch import ShConfig
from .phy.upper.upper_phy import UpperPhyConfig


def _refuse(cls: str, field: str, why: str) -> None:
    raise NotImplementedError(f"{cls}.{field}: {why} is not ported yet")


def _carry(port_cls, cfg, **converted):
    """The port's `port_cls` with every field taken from the JAX `cfg`
    (or from `converted`)."""
    return port_cls(**{f.name: converted.get(f.name, getattr(cfg, f.name))
                       for f in dataclasses.fields(port_cls)})


def from_jax_sh(cfg) -> ShConfig:
    """JAX ``sch.ShConfig`` → the port's ``ShConfig``."""
    if cfg.nof_layers not in (1, 2, 4):
        _refuse("ShConfig", "nof_layers",
                f"{cfg.nof_layers}-layer spatial multiplexing")
    return _carry(ShConfig, cfg, uci=_carry(ulsch.UciOnPusch, cfg.uci))


def from_jax_pdcch(cfg) -> pdcch.PdcchConfig:
    """JAX ``pdcch.PdcchConfig`` → the port's (every CORESET: 1-3 symbols,
    interleaved or not)."""
    return _carry(pdcch.PdcchConfig, cfg)


def from_jax_carrier(cfg) -> CarrierConfig:
    """JAX ``gnb_flagship.CarrierConfig`` → the port's ``CarrierConfig``."""
    return CarrierConfig(mu=cfg.mu, nfft=cfg.nfft, nof_prb=cfg.nof_prb,
                         sh=from_jax_sh(cfg.sh))


def from_jax_mixed(cfg) -> MixedSlotConfig:
    """JAX ``gnb_mixed.MixedSlotConfig`` → the port's ``MixedSlotConfig``
    (every field: the TDL channel, either PRACH occasion, the UE-side
    decode, the downlink check switches, any CORESET)."""
    shs = {name: from_jax_sh(getattr(cfg, name))
           for name in ("pdsch0", "pdsch1", "pusch0", "pusch1")}
    return _carry(MixedSlotConfig, cfg, **shs,
                  pdcch_dl=from_jax_pdcch(cfg.pdcch_dl),
                  pdcch_ul=from_jax_pdcch(cfg.pdcch_ul),
                  ssb=_carry(ssb.SsbConfig, cfg.ssb),
                  csi_rs=_carry(csi_rs.CsiRsConfig, cfg.csi_rs),
                  pucch=_carry(pucch.PucchF1Config, cfg.pucch))


def from_jax_upper_phy(cfg) -> UpperPhyConfig:
    """JAX ``upper_phy.UpperPhyConfig`` → the port's."""
    if cfg.sanitize:
        _refuse("UpperPhyConfig", "sanitize",
                "the grid write-overlap sanitizer")
    return _carry(UpperPhyConfig, cfg)


# JAX config class name → converter
_CONFIGS = {
    "ShConfig": from_jax_sh,
    "PdcchConfig": from_jax_pdcch,
    "SsbConfig": lambda c: _carry(ssb.SsbConfig, c),
    "CsiRsConfig": lambda c: _carry(csi_rs.CsiRsConfig, c),
    "PucchF1Config": lambda c: _carry(pucch.PucchF1Config, c),
    "PucchF2Config": lambda c: _carry(pucch.PucchF2Config, c),
}


def _value(v):
    if isinstance(v, list):
        return [_value(x) for x in v]
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        name = type(v).__name__
        if name in _CONFIGS:
            return _CONFIGS[name](v)
        return from_jax_message(v)
    return v


def from_jax_message(msg):
    """A JAX ``fapi.messages`` request, PDU or indication → the port's
    dataclass of the same name, its configs converted (payload arrays are
    shared, not copied)."""
    port_cls = getattr(messages, type(msg).__name__, None)
    if port_cls is None or not dataclasses.is_dataclass(port_cls):
        raise NotImplementedError(
            f"{type(msg).__name__}: no FAPI message of that name in the port")
    return port_cls(**{f.name: _value(getattr(msg, f.name))
                       for f in dataclasses.fields(port_cls)})
