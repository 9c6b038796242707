"""Carry the JAX package's configurations over to the port, field by field.

This system has no weights: its parameters are the frozen configuration
dataclasses (and the 38.212 tables both packages read).  ``from_jax_carrier``
and ``from_jax_sh`` take a ``gnb_flagship.CarrierConfig`` / ``sch.ShConfig``
of the JAX package as arguments, so this module never imports JAX.  Fields
the port does not carry yet raise ``NotImplementedError`` naming the field.
"""
from __future__ import annotations

import dataclasses

from .models.gnb_flagship import CarrierConfig
from .phy.upper.sch import ShConfig


def _refuse(field: str, why: str) -> None:
    raise NotImplementedError(f"ShConfig.{field}: {why} is not ported yet")


def from_jax_sh(cfg) -> ShConfig:
    """JAX ``sch.ShConfig`` → the port's ``ShConfig``."""
    if cfg.nof_layers > 1:
        _refuse("nof_layers", f"{cfg.nof_layers}-layer spatial multiplexing")
    if cfg.uci.any:
        _refuse("uci", "UCI multiplexed on PUSCH")
    if cfg.reserved_patterns:
        _refuse("reserved_patterns", "reserved RE patterns")
    if cfg.vrb_to_prb_interleaved:
        _refuse("vrb_to_prb_interleaved", "interleaved VRB-to-PRB mapping")
    if cfg.time_interp:
        _refuse("time_interp", "per-symbol time interpolation")
    return ShConfig(**{f.name: getattr(cfg, f.name)
                       for f in dataclasses.fields(ShConfig)})


def from_jax_carrier(cfg) -> CarrierConfig:
    """JAX ``gnb_flagship.CarrierConfig`` → the port's ``CarrierConfig``."""
    return CarrierConfig(mu=cfg.mu, nfft=cfg.nfft, nof_prb=cfg.nof_prb,
                         sh=from_jax_sh(cfg.sh))
