"""The port's OFDM, impairments and sync modules against the JAX package.

The same NumPy inputs, made from a seed, go through both packages on the
CPU (the port with ``device="cpu"``).  The FFTs and the phase ramps of the
two packages differ in the last bits, so OFDM outputs, CFO estimates and
derotated waveforms are held to an absolute tolerance of 1e-5 times the
signal's RMS; host-made tables (subcarrier bins, the smoothing matrix,
the Schmidl-Cox preamble) and integer CFO estimates are identical.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.ops import impairments as JI
from commpy_tpu.ops import ofdm as JO
from commpy_tpu.ops import sync as JS
from commpy_tpu_torch.ops import impairments as PI
from commpy_tpu_torch.ops import ofdm as PO
from commpy_tpu_torch.ops import sync as PS

torch.set_num_threads(1)


def _crandn(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _rms_close(got, want, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rms = scale if scale is not None else np.sqrt(np.mean(np.abs(want) ** 2))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * rms)


def _ofdm_frames(rng, F, nfft, nsc, cp, n_sym):
    """Time-domain OFDM frames of random QPSK, from the JAX package."""
    qpsk = ((rng.randint(0, 2, (F, nsc, n_sym)) * 2 - 1)
            + 1j * (rng.randint(0, 2, (F, nsc, n_sym)) * 2 - 1)) / np.sqrt(2)
    return np.asarray(JO.ofdm_tx(qpsk.astype(np.complex64), nfft, nsc, cp))


@pytest.mark.parametrize("nfft,nsc,cp,lead", [(64, 48, 16, (3,)),
                                              (128, 54, 8, (2, 2))])
def test_ofdm_tx_rx_match_jax(nfft, nsc, cp, lead):
    rng = np.random.RandomState(nfft + nsc)
    x = _crandn(rng, *lead, nsc, 5)
    want = np.asarray(JO.ofdm_tx(x, nfft, nsc, cp))
    got = PO.ofdm_tx(x, nfft, nsc, cp, device="cpu")
    assert got.dtype == torch.complex64
    _rms_close(got.numpy(), want)
    y = want + _crandn(rng, *want.shape) * 0.05
    back = PO.ofdm_rx(y, nfft, nsc, cp, device="cpu")
    _rms_close(back.numpy(), np.asarray(JO.ofdm_rx(y, nfft, nsc, cp)))
    # the round trip recovers the symbols
    clean = PO.ofdm_rx(got, nfft, nsc, cp, device="cpu").numpy()
    np.testing.assert_allclose(clean, x, atol=1e-5)


def test_channel_estimation_tables_match_jax():
    np.testing.assert_array_equal(PO.subcarrier_bins(64, 52),
                                  JO.subcarrier_bins(64, 52))
    np.testing.assert_array_equal(PO.delay_subspace_matrix(64, 52, 4),
                                  JO.delay_subspace_matrix(64, 52, 4))
    slots = np.arange(0, 52, 6)
    est_j = JO.make_comb_estimator(64, 52, slots, 4)
    est_p = PO.make_comb_estimator(64, 52, slots, 4, device="cpu")
    rng = np.random.RandomState(3)
    hp = _crandn(rng, 5, slots.size)
    want = np.asarray(est_j(hp))
    np.testing.assert_allclose(est_p(hp).numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.sqrt(np.mean(np.abs(want) ** 2)))
    # exact for a 4-tap channel seen on its pilots
    g = _crandn(rng, 4)
    w = np.exp(-2j * np.pi * PO.subcarrier_bins(64, 52)[:, None]
               * np.arange(4)[None, :] / 64)
    h_true = (w @ g).astype(np.complex64)
    np.testing.assert_allclose(est_p(h_true[slots]).numpy(), h_true,
                               atol=1e-3)


@pytest.mark.parametrize("delta_f", [0.2 * 20e6 / 64, -3.7e3])
def test_add_frequency_offset_matches_jax(delta_f):
    rng = np.random.RandomState(4)
    w = _crandn(rng, 2, 400)
    want = np.asarray(JI.add_frequency_offset(w, 20e6, delta_f))
    got = PI.add_frequency_offset(w, 20e6, delta_f, device="cpu")
    _rms_close(got.numpy(), want)


def test_cfo_correct_matches_jax():
    rng = np.random.RandomState(5)
    w = _crandn(rng, 3, 400)
    eps = np.array([0.21, -0.37, 0.05], np.float32)
    _rms_close(PS.cfo_correct(w, torch.as_tensor(eps), 64,
                              device="cpu").numpy(),
               np.asarray(JS.cfo_correct(w, eps, 64)))
    _rms_close(PS.cfo_correct(w, 0.3, 64, start=80, device="cpu").numpy(),
               np.asarray(JS.cfo_correct(w, 0.3, 64, start=80)))
    # correction inverts the injector
    rot = PI.add_frequency_offset(w, 64.0, 0.3, device="cpu")
    _rms_close(PS.cfo_correct(rot, 0.3, 64, device="cpu").numpy(), w)


def test_cfo_estimate_cp_matches_jax():
    rng = np.random.RandomState(6)
    nfft, cp, n_sym = 64, 16, 6
    tx = _ofdm_frames(rng, 4, nfft, 52, cp, n_sym)
    eps = np.array([0.23, -0.41, 0.0, 0.12])
    rx = np.stack([np.asarray(JI.add_frequency_offset(tx[i], nfft, eps[i]))
                   for i in range(4)]) + _crandn(rng, *tx.shape) * 0.01
    want = np.asarray(JS.cfo_estimate_cp(rx, nfft, cp, n_sym))
    got = PS.cfo_estimate_cp(rx, nfft, cp, n_sym, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, eps, atol=0.02)
    # derotating by the estimate: the same waveform in both packages
    _rms_close(PS.cfo_correct(rx, torch.as_tensor(got), nfft,
                              device="cpu").numpy(),
               np.asarray(JS.cfo_correct(rx, want, nfft)))


@pytest.mark.parametrize("spacing", [1, 2])
def test_integer_cfo_estimate_matches_jax(spacing):
    rng = np.random.RandomState(7 + spacing)
    nfft = 64
    if spacing == 2:
        block = PS.schmidl_cox_preamble(nfft, seed=3)
    else:
        block = _crandn(rng, nfft) / np.sqrt(2)
    ref = np.fft.fft(block).astype(np.complex64)
    shifts = np.array([-3, 0, 2, 5])
    # a whole-bin offset is a circular shift of the spectrum
    rx = np.stack([np.fft.ifft(np.roll(ref, s)) for s in shifts]).astype(
        np.complex64) + _crandn(rng, 4, nfft) * 0.01
    want = np.asarray(JS.integer_cfo_estimate(rx, ref, 8, spacing))
    got = PS.integer_cfo_estimate(rx, ref, 8, spacing, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, shifts)


def test_schmidl_cox_matches_jax():
    nfft, cp = 64, 16
    pre = PS.schmidl_cox_preamble(nfft, seed=3)
    np.testing.assert_array_equal(pre, JS.schmidl_cox_preamble(nfft,
                                                               seed=3))
    rng = np.random.RandomState(8)
    lead = 37
    sym = np.concatenate([pre[-cp:], pre])
    body = _crandn(rng, 300) * 0.7
    w = np.concatenate([_crandn(rng, lead) * 0.1, sym, body])
    w = np.asarray(JI.add_frequency_offset(w, nfft, 0.3))
    w = np.stack([w, np.roll(w, 11)]) + _crandn(rng, 2, w.size) * 0.02
    mj, pj = (np.asarray(a) for a in JS.schmidl_cox_metric(w, nfft))
    mp, pp = (a.numpy() for a in PS.schmidl_cox_metric(w, nfft,
                                                       device="cpu"))
    _rms_close(pp, pj)
    np.testing.assert_allclose(mp, mj, rtol=0, atol=1e-5)
    d_p, eps_p, _ = PS.schmidl_cox_estimate(w, nfft, device="cpu")
    d_j, eps_j, _ = JS.schmidl_cox_estimate(w, nfft)
    # the metric plateaus across the CP, so its argmax may move within
    # the plateau by rounding: the port's pick is a maximum of JAX's M,
    # and both estimates read P there
    d_p, d_j = d_p.numpy(), np.asarray(d_j)
    for i in range(2):
        assert mj[i, d_p[i]] >= mj[i].max() - 1e-5
        assert abs(int(d_p[i]) - int(d_j[i])) <= cp
    np.testing.assert_allclose(eps_p.numpy(), np.angle(
        pj[np.arange(2), d_p]) / np.pi, rtol=0, atol=1e-5)
    np.testing.assert_allclose(eps_p.numpy(), np.asarray(eps_j), atol=1e-3)
    np.testing.assert_allclose(eps_p.numpy(), 0.3, atol=0.03)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    z = np.zeros((1, 160), np.complex64)
    calls = [lambda: PO.ofdm_tx(np.zeros((48, 2), np.complex64), 64, 48, 16),
             lambda: PO.ofdm_rx(z, 64, 48, 16),
             lambda: PI.add_frequency_offset(z, 64.0, 0.1),
             lambda: PS.cfo_estimate_cp(z, 64, 16, 2),
             lambda: PS.schmidl_cox_metric(z, 64),
             lambda: PO.make_comb_estimator(64, 48, [0, 8, 16, 24], 4)(
                 np.zeros((1, 4), np.complex64))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
