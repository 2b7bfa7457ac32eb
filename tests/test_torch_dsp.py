"""The port's single-carrier DSP against the JAX package.

Filter taps and sequences are host NumPy in both packages and must be
identical.  The device paths run on the CPU: FIR filtering and polyphase
resampling within 1e-5 x RMS of the JAX output (an FFT on either side),
the MMSE / ZF designs within 1e-4 x (1 + |w|) (a float32 solve of the
same real block system), equalizer outputs within 1e-5 x RMS, and block
LMS ``(z, w, mse)`` within 1e-4 relative on a short stationary stream.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.ops import equalize as JE
from commpy_tpu.ops import filters as JF
from commpy_tpu.ops import fir as JFIR
from commpy_tpu.ops import sequences as JS
from commpy_tpu_torch.ops import equalize as PE
from commpy_tpu_torch.ops import filters as PF
from commpy_tpu_torch.ops import fir as PFIR
from commpy_tpu_torch.ops import sequences as PS

torch.set_num_threads(1)

H3 = (np.array([1.0, 0.45, -0.2]) + 1j * np.array([0.1, -0.3, 0.05])
      ).astype(np.complex64)


def _close_rms(got, want, tol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    assert np.max(np.abs(got - want)) <= tol * rms


def _qpsk(rng, *shape):
    return (((rng.integers(0, 2, shape) * 2 - 1)
             + 1j * (rng.integers(0, 2, shape) * 2 - 1)) / np.sqrt(2)
            ).astype(np.complex64)


# ------------------------------------------------------------ taps, sequences

@pytest.mark.parametrize("N,alpha,Ts,Fs", [
    (64, 0.35, 1.0, 8.0), (64, 0.25, 1.0, 8.0), (32, 0.5, 1.0, 4.0),
    (31, 0.0, 1.0, 4.0), (100, 0.22, 2.0, 10.0)])
def test_filter_taps_identical(N, alpha, Ts, Fs):
    # (64, 0.25, 1, 8) hits the RRC singularity t = Ts / (4 alpha) exactly
    for name in ("rcosfilter", "rrcosfilter"):
        tj, hj = getattr(JF, name)(N, alpha, Ts, Fs)
        tp, hp = getattr(PF, name)(N, alpha, Ts, Fs)
        np.testing.assert_array_equal(tp, tj)
        np.testing.assert_array_equal(hp, hj)
    if alpha:
        for a, b in zip(PF.gaussianfilter(N, alpha, Ts, Fs),
                        JF.gaussianfilter(N, alpha, Ts, Fs)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(PF.rectfilter(N, Ts, Fs), JF.rectfilter(N, Ts, Fs)):
        np.testing.assert_array_equal(a, b)


def test_sequences_identical():
    for order, seed, mask, length in ((4, "0011", [1, 1, 0, 1], 7),
                                      (5, "01011", "01001", 31),
                                      (7, [1] * 7, [0, 0, 0, 1, 0, 0, 1], 200)):
        host = PS.pnsequence(order, seed, mask, length)
        np.testing.assert_array_equal(host, JS.pnsequence(order, seed, mask,
                                                          length))
        dev = PS.pnsequence_device(order, seed, mask, length, device="cpu")
        assert dev.dtype == torch.int8
        np.testing.assert_array_equal(dev.numpy(), host)
    with pytest.raises(ValueError):
        PS.pnsequence(4, "001", "1101", 15)
    for u, n, q in ((1, 31, 0), (5, 63, 2), (25, 139, 0)):
        np.testing.assert_array_equal(PS.zcsequence(u, n, q),
                                      JS.zcsequence(u, n, q))
    with pytest.raises(ValueError):
        PS.zcsequence(3, 9)


# ------------------------------------------------------------------------- FIR

@pytest.mark.parametrize("cplx", [False, True], ids=["real", "complex"])
@pytest.mark.parametrize("mode", ["full", "same"])
def test_fir_filter_matches_jax(cplx, mode):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 357)).astype(np.float32)
    h = rng.normal(size=33).astype(np.float32)
    if cplx:
        x = (x + 1j * rng.normal(size=x.shape)).astype(np.complex64)
    want = np.asarray(JFIR.fir_filter(x, h, mode))
    got = PFIR.fir_filter(x, h, mode, device="cpu").numpy()
    _close_rms(got, want)
    ref = np.convolve(x[1], h, mode)
    np.testing.assert_allclose(got[1], ref, atol=1e-4)


@pytest.mark.parametrize("up", [1, 2, 3, 4])
@pytest.mark.parametrize("down", [1, 2, 3])
def test_upfirdn_matches_jax(up, down):
    signal = pytest.importorskip("scipy.signal")
    rng = np.random.default_rng(up * 10 + down)
    x = (rng.normal(size=(2, 123)) + 1j * rng.normal(size=(2, 123))).astype(
        np.complex64)
    h = rng.normal(size=31).astype(np.float32)
    want = np.asarray(JFIR.upfirdn(x, h, up, down))
    got = PFIR.upfirdn(x, h, up, down, device="cpu").numpy()
    _close_rms(got, want)
    # scipy.signal.upfirdn's output-length convention
    ref = signal.upfirdn(h, x[0], up, down)
    assert got.shape[-1] == ref.shape[-1]
    np.testing.assert_allclose(got[0], ref, atol=1e-4)
    xr = x.real.copy()
    _close_rms(PFIR.upfirdn(xr, h, up, down, device="cpu").numpy(),
               np.asarray(JFIR.upfirdn(xr, h, up, down)))


def test_pulse_shape_matches_jax():
    _, h = PF.rrcosfilter(32, 0.35, 1.0, 4.0)
    syms = np.random.default_rng(3).choice([-1.0, 1.0], 50)
    _close_rms(PFIR.pulse_shape(syms, h, 4, device="cpu").numpy(),
               np.asarray(JFIR.pulse_shape(syms, h, 4)))


# ------------------------------------------------------------------ equalizers

@pytest.mark.parametrize("n_taps", [1, 15, 31])
def test_mmse_and_zf_taps_match_jax(n_taps):
    rng = np.random.default_rng(n_taps)
    hb = ((rng.normal(size=(5, 5)) + 1j * rng.normal(size=(5, 5)))
          * np.sqrt(0.5 / 5)).astype(np.complex64)
    for h, nv in ((H3, 0.1), (hb, 0.05)):
        want = np.asarray(JE.mmse_fir_taps(h, nv, n_taps))
        got = PE.mmse_fir_taps(h, nv, n_taps, device="cpu").numpy()
        assert got.dtype == np.complex64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * (1 + np.abs(want).max()))
        assert np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want)))
    want = np.asarray(JE.zf_fir_taps(H3, n_taps))
    got = PE.zf_fir_taps(H3, n_taps, device="cpu").numpy()
    assert np.all(np.abs(got - want) <= 1e-4 * (1 + np.abs(want)))
    with pytest.raises(ValueError, match="delay"):
        PE.mmse_fir_taps(H3, 0.1, n_taps, delay=n_taps + 2, device="cpu")


def test_equalize_matches_jax():
    rng = np.random.default_rng(1)
    x = _qpsk(rng, 4, 600)
    y = np.stack([np.convolve(r, H3)[:600] for r in x]).astype(np.complex64)
    y += (0.05 * (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape))
          ).astype(np.complex64)
    for n_taps in (1, 21):
        d = PE.equalizer_delay(n_taps, 3)
        assert d == JE.equalizer_delay(n_taps, 3)
        w = np.asarray(JE.mmse_fir_taps(H3, 0.01, n_taps))
        want = np.asarray(JE.equalize(y, w, d))
        got = PE.equalize(y, w, d, device="cpu").numpy()
        _close_rms(got, want)
        _close_rms(PE.equalize(y, w, d, n_out=550, device="cpu").numpy(),
                   np.asarray(JE.equalize(y, w, d, n_out=550)))
    # the 21-tap design undoes the channel
    assert np.mean(np.abs(got[:, 20:560] - x[:, 20:560]) ** 2) < 0.02
    with pytest.raises(ValueError, match="per-batch"):
        PE.equalize(y, np.stack([w, w]), d, device="cpu")


def test_equalize_vmap_over_per_batch_taps():
    # per-batch taps, as the JAX package's equalizer bench maps them
    rng = np.random.default_rng(2)
    h = ((rng.normal(size=(4, 5)) + 1j * rng.normal(size=(4, 5)))
         * np.sqrt(0.1)).astype(np.complex64)
    y = (rng.normal(size=(4, 256)) + 1j * rng.normal(size=(4, 256))).astype(
        np.complex64)
    d = PE.equalizer_delay(31, 5)
    w = PE.mmse_fir_taps(h, 0.05, 31, device="cpu")
    got = torch.vmap(lambda yy, ww: PE.equalize(yy, ww, d, device="cpu"))(
        torch.as_tensor(y), w)
    for b in range(4):
        np.testing.assert_array_equal(
            got[b].numpy(), PE.equalize(y[b], w[b], d, device="cpu").numpy())


def test_lms_equalize_matches_jax():
    rng = np.random.default_rng(4)
    x = _qpsk(rng, 2, 1000)
    y = np.stack([np.convolve(r, H3)[:1000] for r in x]).astype(np.complex64)
    y += (0.03 * (rng.normal(size=y.shape) + 1j * rng.normal(size=y.shape))
          ).astype(np.complex64)
    d = PE.equalizer_delay(11, 3)
    zj, wj, mj = (np.asarray(a) for a in JE.lms_equalize(y, x, 11, 0.01, d))
    zp, wp, mp = (a.numpy() for a in PE.lms_equalize(y, x, 11, 0.01, d,
                                                     device="cpu"))
    for got, want in ((zp, zj), (wp, wj), (mp, mj)):
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
    assert mp[-5:].mean() < 0.1 * mp[:2].mean()  # it converged
