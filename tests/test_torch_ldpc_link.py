"""The LDPC links of commpy_tpu_torch as a whole, and carrying params across.

The same NumPy bits, complex noise and channel gains go through the JAX
package's stages composed by hand (encode -> modulate -> channel ->
``-demodulate_soft`` -> BP decode) and through the port's link
``transceive``.  The LLRs must agree within rtol 1e-5 (PR 1's modem
tolerance); the port's plain core on the JAX package's LLRs must decode
bit for bit like the XLA core; and the whole link must return the same
bits on frames that converge (the port's kernel path folds flooding
totals in the Pallas order, the JAX package's CPU path in the XLA order).
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commpy_tpu.ops import dvbs2 as JD
from commpy_tpu.ops import ldpc as JL
from commpy_tpu.ops import modem as JM
from commpy_tpu.ops import nrldpc as JN
from commpy_tpu.ops import qcldpc as JQ
from commpy_tpu_torch import convert
from commpy_tpu_torch.models import (make_ldpc_rayleigh_link,
                                     make_qcldpc_awgn_link,
                                     wifi80211n_ldpc_link)
from commpy_tpu_torch.ops import dvbs2 as PD
from commpy_tpu_torch.ops import ldpc as PL
from commpy_tpu_torch.ops import nrldpc as PN
from commpy_tpu_torch.ops import qcldpc as PQ

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIMAX = os.path.join(REPO, "commpy_tpu", "designs", "ldpc", "wimax",
                     "1440.720.txt")


def _draws(link, F, seed, fading=False):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (F, link.frame_bits)).astype(np.int8)
    n = link.n_symbols
    noise = (rng.randn(F, n) + 1j * rng.randn(F, n)).astype(np.complex64)
    h = ((rng.randn(F, n) + 1j * rng.randn(F, n)) * np.sqrt(0.5)).astype(
        np.complex64) if fading else None
    return bits, noise, h


# (n, modulation, SNR dB): SNRs on the waterfall, where most frames
# converge and some do not
@pytest.mark.parametrize("n,m,snr_db", [(648, 16, 10.0), (1944, 16, 10.0),
                                        (648, 2, 3.0)])
def test_80211n_ldpc_link_matches_jax_stages(n, m, snr_db):
    link = wifi80211n_ldpc_link(n, m, device="cpu")
    bits, noise, _ = _draws(link, 4, n + m)
    ns = float(np.float32(link.noise_std_fn(snr_db)))
    jp = JQ.ieee80211n_params(n, "1/2")
    const = (JM.psk_constellation(m) if m == 2
             else JM.qam_constellation(m)).astype(np.complex64)
    bps = int(np.log2(m))
    nsj = jnp.float32(ns)
    y = JM.modulate(JQ.qc_encode_device(bits, jp), const, bps) + \
        jnp.asarray(noise) * (nsj * 0.5)
    llr = np.asarray(-JM.demodulate_soft(y, const, bps, nsj ** 2))
    dj, oj = JQ.qc_bp_decode_device(llr, jp, "MSA", 15, backend="xla")
    want = np.asarray(dj)[:, :link.frame_bits]
    rx = link.receive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    np.testing.assert_allclose(rx.numpy(), llr, rtol=1e-5, atol=1e-5)
    # the port's plain core on JAX's LLRs: bit for bit
    dp, op = PQ.qc_bp_decode_device(llr, PQ.ieee80211n_params(n, "1/2"),
                                    "MSA", 15, backend="torch", device="cpu")
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    # the whole port link (its kernel path) on the same draws
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != bits).mean() < 0.05


def test_rayleigh_link_matches_jax_stages():
    a = JL.get_ldpc_code_params(WIMAX)
    JL.build_matrix(a)
    b = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, "wimax",
                                             "1440.720.txt"))
    link = make_ldpc_rayleigh_link(ldpc_params=b, modulation_m=4,
                                   algorithm="MSA", n_iterations=10,
                                   device="cpu")
    bits, noise, h = _draws(link, 3, 8, fading=True)
    ns = float(np.float32(link.noise_std_fn(7.0)))
    G = np.asarray(a["generator_matrix"].todense()) % 2
    const = JM.qam_constellation(4).astype(np.complex64)
    nsj = jnp.float32(ns)
    hj = jnp.asarray(h)
    y = hj * JM.modulate(JL.ldpc_encode_device(bits, G), const, 2) + \
        jnp.asarray(noise) * (nsj * 0.5)
    nv_eff = nsj ** 2 / jnp.maximum(jnp.abs(hj) ** 2, 1e-12)
    llr = np.asarray(-JM.demodulate_soft(y / hj, const, 2, nv_eff))
    dj, _ = JL.ldpc_bp_decode_device(llr, a, "MSA", 10)
    want = np.asarray(dj)[:, :link.frame_bits]
    rx = link.receive(torch.as_tensor(bits), torch.as_tensor(noise), ns,
                      torch.as_tensor(h))
    np.testing.assert_allclose(rx.numpy(), llr, rtol=1e-4, atol=1e-4)
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns,
                          torch.as_tensor(h))
    np.testing.assert_array_equal(got.numpy(), want)
    # faded at 7 dB: one frame fails, one is clean, one nearly
    assert 0 < (want != bits).sum() < bits.size // 20


@pytest.mark.parametrize("make,low_db", [
    (lambda: wifi80211n_ldpc_link(648, 16, device="cpu"), 3.0),
    (lambda: make_qcldpc_awgn_link(qc_params=PQ.ieee80211n_params(648,
                                                                  "2/3"),
                                   modulation_m=4, device="cpu"), 1.0),
])
def test_ldpc_link_error_free_at_high_snr(make, low_db):
    link = make()
    gen = torch.Generator()
    gen.manual_seed(3)
    e35 = int(link.link_step(gen, 16, float(link.noise_std_fn(35.0))))
    e_low = int(link.link_step(gen, 16, float(link.noise_std_fn(low_db))))
    assert e35 == 0 < e_low


def test_convert_round_trips_decode_alike():
    # JAX package params dicts, caches included, carried into the port:
    # the port then decodes the same code as the JAX package
    jqc = JQ.ieee80211n_params(648, "1/2")
    jl = JL.get_ldpc_code_params(WIMAX, True)
    JL.ldpc_bp_decode_device(np.zeros((1, 1440), np.float32), jl, "MSA", 1)
    assert "_qc_lift" in jl
    pl = convert.ldpc_params_from_arrays(jl)
    assert not [k for k in pl if k.startswith("_")]
    pq = convert.qc_params_from_arrays(jqc)
    for jp in (JN.nr_code_params(2, 16),
               JD.dvbs2_qc_params(JD.synthetic_address_table(16200, "1/2"),
                                  16200, "1/2"),
               JQ.random_qc_params(6, 12, 16, seed=1)):
        q = convert.qc_params_from_arrays(jp)
        assert PQ.select_backend(q) == PQ.select_backend(jp)
    rng = np.random.RandomState(8)
    llr = (rng.randn(2, 648) * 2 + 1.5).astype(np.float32)
    dj, oj = JQ.qc_bp_decode_device(llr, jqc, "MSA", 5, backend="xla")
    dp, op = PQ.qc_bp_decode_device(llr, pq, "MSA", 5, backend="torch",
                                    device="cpu")
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    llr = (rng.randn(2, 1440) * 2 + 1.5).astype(np.float32)
    dj, _ = JL.ldpc_bp_decode_device(llr, jl, "MSA", 5, backend="dense")
    dp, _ = PL.ldpc_bp_decode_device(llr, pl, "MSA", 5, backend="dense",
                                     device="cpu")
    assert (dp.numpy() != np.asarray(dj)).mean() < 1e-3
    # a tampered dict is refused
    bad = dict(jqc, encode_matrix=jqc["encode_matrix"] ^ 1)
    with pytest.raises(ValueError, match="encode_matrix"):
        convert.qc_params_from_arrays(bad)
    bad = dict(jl, cnode_deg_list=jl["cnode_deg_list"] + 1)
    with pytest.raises(ValueError, match="degree"):
        convert.ldpc_params_from_arrays(bad)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    qc = PQ.ieee80211n_params(648, "1/2")
    pd = PD.dvbs2_qc_params(PD.synthetic_address_table(16200, "1/2"), 16200,
                            "1/2")
    pn = PN.nr_code_params(2, 16)
    wimax = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, "wimax",
                                                 "1440.720.txt"))
    z = np.zeros
    calls = [
        lambda: wifi80211n_ldpc_link(648, 16),
        lambda: make_qcldpc_awgn_link(qc_params=qc),
        lambda: make_ldpc_rayleigh_link(ldpc_params=wimax),
        lambda: PQ.qc_bp_decode_device(z((1, 648), np.float32), qc, "MSA", 2),
        lambda: PQ.qc_encode_device(z((1, 324), np.int8), qc),
        lambda: PL.ldpc_bp_decode_device(z((1, 1440), np.float32), wimax,
                                         "MSA", 2, backend="dense"),
        lambda: PL.ldpc_bp_decode(z(1440), wimax, "MSA", 2),
        lambda: PD.dvbs2_encode_device(z((1, 7200), np.int8), pd),
        lambda: PD.dvbs2_decode_device(z((1, 16200), np.float32), pd),
        lambda: PN.nr_encode_device(z((1, pn["k_bits"]), np.int8), pn),
        lambda: PN.nr_rate_recover(pn, z((1, 100), np.float32), 100),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
