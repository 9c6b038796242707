"""The reference's receive stages and OFDM against the program's on the
same random inputs: they compute the same definitions, so they agree to
float32 rounding, and they are computed otherwise (float64, other
formulations), so their outputs are not the program's bit for bit."""
import numpy as np
import pytest
import torch

from ranbench.reference.ops import equalizer as r_eq
from ranbench.reference.ops import estimator as r_est
from ranbench.reference.ops import modulation as r_mod
from ranbench.reference.ops import prach as r_prach
from ranbench.reference.phy.lower import ofdm as r_ofdm
from ranbench.reference.phy.upper import pucch as r_pucch
from srsran_project_23_5_tpu_torch.ops import equalizer as p_eq
from srsran_project_23_5_tpu_torch.ops import estimator as p_est
from srsran_project_23_5_tpu_torch.ops import modulation as p_mod
from srsran_project_23_5_tpu_torch.ops import prach as p_prach
from srsran_project_23_5_tpu_torch.phy.lower import ofdm as p_ofdm
from srsran_project_23_5_tpu_torch.phy.upper import pucch as p_pucch


def _cn(g, *shape):
    return torch.complex(torch.randn(*shape, generator=g),
                         torch.randn(*shape, generator=g))


def _gap(ref, port) -> float:
    """Widest gap over the reference's largest magnitude."""
    ref, port = torch.as_tensor(ref), torch.as_tensor(port)
    return float((ref - port).abs().max() / ref.abs().max())


def _check(pairs, departs=True):
    gaps = [_gap(r, p) for r, p in pairs]
    assert max(gaps) < 1e-4, gaps
    if departs:
        assert max(gaps) > 0.0, gaps


def test_estimators():
    g = torch.Generator().manual_seed(1)
    tx = _cn(g, 3, 40) / np.sqrt(2.0)
    rx = tx * (1.0 + 0.1 * _cn(g, 2, 1, 40)) + 0.05 * _cn(g, 2, 3, 40)
    r = r_est.estimate_comb2(rx, tx, time_interp=True)
    p = p_est.estimate_comb2(rx, tx, time_interp=True)
    _check([(r.h_alloc, p.h_alloc), (r.h_dmrs, p.h_dmrs),
            (r.noise_var, p.noise_var), (r.rsrp, p.rsrp),
            (r.ta_norm, p.ta_norm)])
    for off in (0, 1):
        r = r_est.estimate_comb2_occ2(rx, tx, sc_offset=off)
        p = p_est.estimate_comb2_occ2(rx, tx, sc_offset=off)
        _check([(r.h_alloc, p.h_alloc), (r.noise_var, p.noise_var)])
    sc = np.arange(1, 120, 3)
    r = r_est.estimate_port(rx, tx, sc, 130, 14)
    p = p_est.estimate_port(rx, tx, sc, 130, 14)
    _check([(r.h, p.h), (r.noise_var, p.noise_var), (r.epre, p.epre)])


@pytest.mark.parametrize("layers", [1, 2, 4])
def test_equalizers(layers):
    g = torch.Generator().manual_seed(layers)
    nrx = max(layers, 2)
    h = _cn(g, 3, nrx, layers, 50)
    x = _cn(g, 3, layers, 50)
    y = torch.einsum("brln,bln->brn", h, x) + 0.01 * _cn(g, 3, nrx, 50)
    nv = torch.rand(3, generator=g) + 0.01
    if layers == 1:
        r, p = r_eq.zf_1xn(y, h[:, :, 0], nv), p_eq.zf_1xn(y, h[:, :, 0], nv)
    elif layers == 2:
        r, p = r_eq.zf_nx2(y, h, nv), p_eq.zf_nx2(y, h, nv)
    else:
        r, p = r_eq.zf_nx4(y, h, nv), p_eq.zf_nx4(y, h, nv)
    _check([(r[0], p[0]), (r[1], p[1])])


@pytest.mark.parametrize("qm", [2, 4, 6, 8])
def test_mapper_and_demapper(qm):
    g = torch.Generator().manual_seed(qm)
    bits = torch.randint(0, 2, (2, 60 * qm), generator=g, dtype=torch.int8)
    _check([(r_mod.modulate(bits, qm), p_mod.modulate(bits, qm))],
           departs=False)
    y = r_mod.modulate(bits, qm) + 0.05 * _cn(g, 2, 60)
    nv = torch.rand(2, 60, generator=g) + 0.01
    _check([(r_mod.demodulate_soft(y, nv, qm),
             p_mod.demodulate_soft(y, nv, qm))])


def test_ofdm():
    g = torch.Generator().manual_seed(3)
    grid = _cn(g, 2, 14, 72)
    r, p = (r_ofdm.modulate_slot(grid, 1, 128),
            p_ofdm.modulate_slot(grid, 1, 128))
    _check([(r, p)])
    _check([(r_ofdm.demodulate_slot(r, 72, 1, 128),
             p_ofdm.demodulate_slot(r, 72, 1, 128))])


def test_pucch_f1_detector():
    g = torch.Generator().manual_seed(4)
    cfg = r_pucch.PucchF1Config(prb=2, nof_harq_bits=2)
    pcfg = p_pucch.PucchF1Config(prb=2, nof_harq_bits=2)
    bits = torch.tensor([[0, 1], [1, 1]], dtype=torch.int8)
    grid = r_pucch.pucch_f1_transmit(
        bits, cfg, torch.zeros((2, 14, 48), dtype=torch.complex64))
    rx = grid[:, None] * (0.7 + 0.2j) + 0.1 * _cn(g, 2, 2, 14, 48)
    r, p = r_pucch.pucch_f1_detect(rx, cfg), p_pucch.pucch_f1_detect(rx, pcfg)
    assert torch.equal(r.bits, p.bits) and torch.equal(r.bits, bits)
    _check([(r.detection_metric, p.detection_metric)])


def test_prach_detector():
    g = torch.Generator().manual_seed(5)
    pre = torch.from_numpy(r_prach.generate(22, 3, 139, 12))
    rx = pre * (0.5 - 0.3j) + 0.2 * _cn(g, 2, 139)
    r = r_prach.detect(rx, 22, 139, 12)
    p = p_prach.detect(rx, 22, 139, 12)
    assert int(r[0].mean(0).argmax()) == int(p[0].mean(0).argmax()) == 3
    assert torch.equal(r[1], p[1])
    _check([(r[0], p[0]), (r[2], p[2])])
