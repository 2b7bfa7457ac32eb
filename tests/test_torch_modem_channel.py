"""commpy_tpu_torch modem, AWGN channel and scrambler against commpy_tpu.

Constellations, modulation, hard demapping and the scramblers must be
identical.  Soft LLRs agree within rtol 1e-5 and atol 1e-5 * max|llr|:
the two frameworks evaluate exp/log and sum the logsumexp terms in a
different order, so the last float32 bits can differ.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.ops import channel as JC
from commpy_tpu.ops import modem as JM
from commpy_tpu.ops import scramble as JS
from commpy_tpu_torch.ops import channel as PC
from commpy_tpu_torch.ops import modem as PM
from commpy_tpu_torch.ops import scramble as PS

torch.set_num_threads(1)

MODEMS = [("psk", 2), ("psk", 4), ("psk", 8), ("qam", 4), ("qam", 16),
          ("qam", 64), ("qam", 256)]


def _const(kind, m, mod):
    return (mod.psk_constellation(m) if kind == "psk"
            else mod.qam_constellation(m))


def _symbols(const, n_frames, n_sym, snr_scale, seed):
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(const), (n_frames, n_sym))
    noise = (rng.randn(n_frames, n_sym) + 1j * rng.randn(n_frames, n_sym))
    return (const[idx] + noise * snr_scale).astype(np.complex64)


@pytest.mark.parametrize("kind,m", MODEMS)
def test_constellations_and_hard_paths_match(kind, m):
    jc, pc = _const(kind, m, JM), _const(kind, m, PM)
    np.testing.assert_array_equal(jc, pc)
    bps = int(np.log2(m))
    np.testing.assert_array_equal(JM.constellation_bit_masks(m, bps),
                                  PM.constellation_bit_masks(m, bps))
    rng = np.random.RandomState(m)
    bits = rng.randint(0, 2, (3, 12 * bps)).astype(np.int8)
    const = jc.astype(np.complex64)
    np.testing.assert_array_equal(
        np.asarray(JM.modulate(bits, const, bps)),
        PM.modulate(torch.as_tensor(bits), const, bps,
                    device="cpu").numpy())
    y = _symbols(const, 3, 40, 0.3, seed=m)
    want = np.asarray(JM.demodulate_hard(y, const, bps))
    got = PM.demodulate_hard(torch.as_tensor(y), const, bps)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(want, got.numpy())


def _assert_llr_close(want, got):
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# 'auto' is the joint path below order 64 and the separable one from 64
@pytest.mark.parametrize("kind,m,method", [
    ("psk", 8, "auto"), ("psk", 8, "separable"), ("qam", 16, "joint"),
    ("qam", 16, "separable"), ("qam", 64, "auto"), ("qam", 64, "joint"),
    ("qam", 256, "auto")])
def test_soft_demappers_match(kind, m, method):
    const = _const(kind, m, JM).astype(np.complex64)
    bps = int(np.log2(m))
    y = _symbols(const, 2, 30, 0.4, seed=m + len(method))
    nv = np.float32(0.35)
    yt = torch.as_tensor(y)
    _assert_llr_close(JM.demodulate_soft(y, const, bps, nv, method=method),
                      PM.demodulate_soft(yt, const, bps, nv, method=method))
    _assert_llr_close(
        JM.demodulate_maxlog(y, const, bps, nv, method=method),
        PM.demodulate_maxlog(yt, const, bps, nv, method=method))


def test_soft_demapper_per_symbol_noise_variance():
    const = JM.qam_constellation(16).astype(np.complex64)
    y = _symbols(const, 2, 25, 0.3, seed=4)
    nv = np.random.RandomState(5).uniform(0.1, 1.0, (2, 25)).astype(
        np.float32)
    _assert_llr_close(JM.demodulate_soft(y, const, 4, nv),
                      PM.demodulate_soft(torch.as_tensor(y), const, 4,
                                         torch.as_tensor(nv)))


def test_demapper_rejects_unknown_method():
    const = PM.qam_constellation(16)
    with pytest.raises(ValueError, match="method"):
        PM.demodulate_soft(torch.zeros(1, 2, dtype=torch.complex64), const,
                           4, 1.0, method="fast")


@pytest.mark.parametrize("rate,Es,cplx", [(1.0, 1.0, True), (0.75, 10.0,
                                                             True),
                                          (0.5, 1.0, False)])
def test_snr_to_noise_std_matches(rate, Es, cplx):
    snrs = np.array([-3.0, 0.0, 2.5, 12.0, 35.0])
    want = np.asarray(JC.snr_to_noise_std(snrs, code_rate=rate, Es=Es,
                                          is_complex=cplx))
    got = PC.snr_to_noise_std(snrs, code_rate=rate, Es=Es, is_complex=cplx)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_awgn_noise_power():
    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.ones(200_000, dtype=torch.complex64)
    y = PC.awgn(x, 3.0, generator=gen, device="cpu")
    # noise variance avg_energy / (2 * snr) per component
    want = 1.0 / (2 * 10 ** 0.3)
    np.testing.assert_allclose(float((y - x).real.var()), want, rtol=0.02)
    np.testing.assert_allclose(float((y - x).imag.var()), want, rtol=0.02)
    xr = torch.ones(200_000)
    yr = PC.awgn(xr, 3.0, generator=gen, device="cpu")
    np.testing.assert_allclose(float((yr - xr).var()), 2 * want, rtol=0.02)


@pytest.mark.parametrize("seed", [0x7F, 0x5D, 1])
def test_scrambler_matches_jax(seed):
    np.testing.assert_array_equal(JS.wifi_scrambler_sequence(seed, 300),
                                  PS.wifi_scrambler_sequence(seed, 300))
    bits = np.random.RandomState(seed).randint(0, 2, (3, 300)).astype(
        np.int8)
    tb = torch.as_tensor(bits)
    scr = PS.scramble(tb, seed, device="cpu")
    np.testing.assert_array_equal(np.asarray(JS.scramble(bits, seed)),
                                  scr.numpy())
    np.testing.assert_array_equal(
        PS.descramble(scr, seed, device="cpu").numpy(), bits)
    ss = PS.selfsync_scramble(tb, seed, device="cpu")
    np.testing.assert_array_equal(np.asarray(JS.selfsync_scramble(bits,
                                                                  seed)),
                                  ss.numpy())
    np.testing.assert_array_equal(
        PS.selfsync_descramble(ss, seed, device="cpu").numpy(), bits)
    np.testing.assert_array_equal(PS.selfsync_descramble_host(ss.numpy(),
                                                              seed), bits)
    np.testing.assert_array_equal(
        np.asarray(JS.selfsync_descramble(ss.numpy(), seed)), bits)


def test_scrambler_published_sequence_and_seed_check():
    # IEEE 802.11 all-ones seed: 00001110 11110010 ...
    np.testing.assert_array_equal(
        PS.wifi_scrambler_sequence(0x7F, 16),
        [0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 0, 0, 1, 0])
    with pytest.raises(ValueError, match="seed"):
        PS.wifi_scrambler_sequence(0)
