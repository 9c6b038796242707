"""Parity of the port's HARQ retransmission batch of the mixed slot with
the JAX package (CPU): a first transmission below the MCS cliff, its rv=2
retransmission, and their soft combination, on the mixed slot's front half
(``gnb_mixed.harq_retx_batch``).  The port is given the JAX noise draws of
both transmissions; verdicts are equal, combined LLRs within 1e-4 of the
LLR clip, and the port's full-graph decode of the JAX combined LLRs is
bit-equal to the Pallas decoder in interpret mode.
"""
import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from srsran_project_23_5_tpu.models import gnb_mixed
from srsran_project_23_5_tpu.ops.ldpc import decoder_pallas
from srsran_project_23_5_tpu_torch import convert
from srsran_project_23_5_tpu_torch.models import gnb_mixed as tmixed
from srsran_project_23_5_tpu_torch.ops.ldpc import decoder_cuda
from srsran_project_23_5_tpu_torch.ran.constants import LLR_MAX

torch.set_num_threads(1)

B = 2

SNR1_DB = 1.5     # tiny_mixed: each transmission alone fails, the sum passes


def _jax_noise(key, sigma, slot_samples):
    k_dl, k_ul = jax.random.split(key)
    out = []
    for k in (k_dl, k_ul):
        nz = (sigma / np.sqrt(2)) * jax.random.normal(
            k, (2, 2, slot_samples), jnp.float32)
        out.append(np.asarray(jax.lax.complex(nz[0], nz[1])))
    return out


def test_harq_retx_batch_matches_jax_with_same_noise():
    """The JAX HARQ batch and the port's, given the JAX noise draws of both
    transmissions (fold_in(key, 1 | 2), split, normal): the three verdicts
    equal for both UEs (first and retransmission fail, the combination
    passes); the combined LLRs within 1e-4 of the LLR clip; and the port's
    decoder on the JAX combined LLRs bit-equal to the Pallas decoder in
    interpret mode on the full graph."""
    jax.clear_caches()     # XLA:CPU faults on accumulated giant compiles
    jcfg = gnb_mixed.tiny_mixed()
    tcfg = convert.from_jax_mixed(jcfg)
    payloads = gnb_mixed.make_payloads(jcfg, np.random.default_rng(2),
                                       batch=B)
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    cfg1 = dataclasses.replace(jcfg, snr_db=SNR1_DB)
    cfg2 = dataclasses.replace(
        cfg1, pusch0=dataclasses.replace(jcfg.pusch0, rv=2),
        pusch1=dataclasses.replace(jcfg.pusch1, rv=2))

    def jax_side(p, ks):
        out = gnb_mixed.harq_retx_batch(p, ks, jcfg, SNR1_DB)
        fronts = [jax.vmap(lambda q, k: gnb_mixed._mixed_front(
            q, jax.random.fold_in(k, i), c))(p, ks)
            for i, c in ((1, cfg1), (2, cfg2))]
        return out, {n: fronts[0][n].llr_full + fronts[1][n].llr_full
                     for n in ("u0", "u1")}

    want, w_comb = jax.jit(jax_side)(payloads, keys)
    sigma = tmixed.noise_sigma(dataclasses.replace(tcfg, snr_db=SNR1_DB))
    draws = [[_jax_noise(jax.random.fold_in(k, i), sigma, jcfg.slot_samples)
              for k in keys] for i in (1, 2)]
    noise = [torch.from_numpy(np.stack([d[j] for d in draws[i]]))
             for i in range(2) for j in range(2)]
    t_pay = {k: torch.from_numpy(np.array(v)) for k, v in payloads.items()}
    got = tmixed.harq_retx_batch(t_pay, noise, tcfg, SNR1_DB, device="cpu")
    for ue in ("u0", "u1"):
        for v in ("first_ok", "retx_ok", "combined_ok"):
            assert got[ue][v].tolist() == np.asarray(want[ue][v]).tolist(), (
                ue, v)
        assert not got[ue]["first_ok"].any()
        assert not got[ue]["retx_ok"].any()
        assert got[ue]["combined_ok"].all()
    # the combined buffers, and the full-graph decode of the JAX ones
    cfg2_t = dataclasses.replace(tcfg, snr_db=SNR1_DB, pusch0=dataclasses.replace(
        tcfg.pusch0, rv=2), pusch1=dataclasses.replace(tcfg.pusch1, rv=2))
    f1 = tmixed._mixed_front(t_pay, noise[0], noise[1],
                             dataclasses.replace(tcfg, snr_db=SNR1_DB))
    f2 = tmixed._mixed_front(t_pay, noise[2], noise[3], cfg2_t)
    for ue, sh in (("u0", tcfg.pusch0), ("u1", tcfg.pusch1)):
        comb = np.asarray(w_comb[ue])
        np.testing.assert_allclose(
            (f1[ue].llr_full + f2[ue].llr_full).numpy(), comb, rtol=0,
            atol=1e-4 * LLR_MAX)
        seg = sh.segments
        llr = comb.reshape(-1, comb.shape[-1])[:1].copy()  # slot 0, CB 0
        w_bits, w_ok = decoder_pallas.decode(
            jnp.asarray(llr), seg.base_graph, seg.lifting_size, 6,
            interpret=True)
        bits, ok = decoder_cuda.decode(torch.from_numpy(llr),
                                       seg.base_graph, seg.lifting_size, 6)
        assert np.array_equal(ok.numpy(), np.asarray(w_ok)) and ok.all()
        assert np.array_equal(bits.numpy(), np.asarray(w_bits))
