"""The port's CommPy-compatible API against ``commpy_tpu``'s.

Deterministic outputs, NumPy in and out: ``Modem`` mapping and hard
demapping bit for bit, soft LLRs within rtol 1e-5 x (1 + max |LLR|) (an
exact float32 logsumexp each side); ``ofdm_tx``/``ofdm_rx`` within 1e-5
(an FFT each side); ``utilities`` exactly; the ``channelcoding``
encoders bit for bit and its decoders' bits identical (``map_decode``'s
extrinsics within 1e-4 x (1 + |L|), a float32 BCJR each side).

The stateful channels cannot draw the JAX package's numbers: their SNR
setters, ``noise_std``, ``fading_param`` and its invariants, ``k_factor``
and the Kronecker factors are held exactly, ``propagate`` with given
gains and no noise within float32 rounding, and the draws by their
moments.  ``LinkModel`` runs clean on a noiseless channel;
``link_performance_device`` for uncoded QPSK is within rtol 0.25 of
``erfc(sqrt(snr/2))/2``; ``Wifi80211.link_performance`` at a small
``tx_max`` is within Monte-Carlo error of the port's batched 802.11 link
at the same noise_std.  Every compatible module's ``__all__`` equals the
JAX package's.
"""
import importlib
import os

import numpy as np
import pytest
import torch
from scipy.special import erfc

import commpy_tpu
import commpy_tpu_torch

torch.set_num_threads(1)

CPU = "cpu"
MODULES = ["filters", "sequences", "impairments", "utilities", "modulation",
           "channels", "links", "wifi80211", "channelcoding",
           "channelcoding.algcode", "channelcoding.convcode",
           "channelcoding.gfields", "channelcoding.interleavers",
           "channelcoding.ldpc", "channelcoding.turbo"]


def _pair(name):
    return (importlib.import_module(f"commpy_tpu.{name}"),
            importlib.import_module(f"commpy_tpu_torch.{name}"))


@pytest.mark.parametrize("name", MODULES)
def test_all_equals_the_jax_modules(name):
    j, p = _pair(name)
    assert list(p.__all__) == list(j.__all__)
    for n in p.__all__:
        assert hasattr(p, n), n


def test_top_level_star_exports():
    star = set()
    for name in ("filters", "modulation", "impairments", "sequences",
                 "channels"):
        star |= set(_pair(name)[1].__all__)
    for n in star:
        assert hasattr(commpy_tpu_torch, n) and hasattr(commpy_tpu, n), n
        assert getattr(commpy_tpu_torch, n).__module__.startswith(
            "commpy_tpu_torch")


# ------------------------------------------------------------------ modems

@pytest.mark.parametrize("kind,m", [("psk", 2), ("psk", 4), ("psk", 8),
                                    ("qam", 4), ("qam", 16), ("qam", 64)])
def test_modem_matches_jax(kind, m):
    J, P = _pair("modulation")
    cls = "PSKModem" if kind == "psk" else "QAMModem"
    a, b = getattr(P, cls)(m, device=CPU), getattr(J, cls)(m)
    np.testing.assert_array_equal(a.constellation, b.constellation)
    assert (a.Es, a.m, a.num_bits_symbol) == (b.Es, b.m, b.num_bits_symbol)
    rng = np.random.RandomState(m)
    bits = rng.randint(0, 2, 64 * a.num_bits_symbol + 1)
    sym = a.modulate(bits)
    np.testing.assert_array_equal(sym, b.modulate(bits))
    y = sym + 0.4 * (rng.randn(sym.size) + 1j * rng.randn(sym.size))
    hard = a.demodulate(y, "hard")
    assert hard.dtype == np.int8
    np.testing.assert_array_equal(hard, b.demodulate(y, "hard"))
    soft, want = a.demodulate(y, "soft", 0.3), b.demodulate(y, "soft", 0.3)
    assert soft.dtype == want.dtype == np.float64
    np.testing.assert_allclose(soft, want, rtol=0,
                               atol=1e-5 * (1 + np.abs(want).max()))
    with pytest.raises(ValueError):
        a.demodulate(y, "nope")


def test_custom_modem_and_ofdm_match_jax():
    J, P = _pair("modulation")
    pts = np.exp(1j * np.pi / 4 * np.arange(8)) * (1 + np.arange(8) % 2)
    for gray in (True, False):
        a, b = P.Modem(pts, gray, device=CPU), J.Modem(pts, gray)
        np.testing.assert_array_equal(a.constellation, b.constellation)
    with pytest.raises(ValueError):
        P.Modem(pts[:6], False, device=CPU)
    rng = np.random.RandomState(2)
    x = rng.randn(48, 3) + 1j * rng.randn(48, 3)
    tx = P.ofdm_tx(x, 64, 48, 16, device=CPU)
    np.testing.assert_allclose(tx, J.ofdm_tx(x, 64, 48, 16), atol=1e-5)
    np.testing.assert_allclose(P.ofdm_rx(tx, 64, 48, 16, device=CPU),
                               J.ofdm_rx(tx, 64, 48, 16), atol=1e-5)
    # the MIMO detectors are re-exported from the port's ops
    from commpy_tpu_torch.ops import mimo
    assert P.kbest is mimo.kbest and P.mimo_ml is mimo.mimo_ml


def test_utilities_and_impairments_match_jax():
    J, P = _pair("utilities")
    for args in ((5, 4), ([1, 2, 3], 3), (np.arange(4), 2)):
        np.testing.assert_array_equal(P.dec2bitarray(*args, device=CPU),
                                      J.dec2bitarray(*args))
    np.testing.assert_array_equal(P.decimal2bitarray(9, 5, device=CPU),
                                  J.decimal2bitarray(9, 5))
    for bits in ([1, 0, 1, 1], [], [1] * 40):
        assert P.bitarray2dec(bits, device=CPU) == J.bitarray2dec(bits)
    a, b = [1, 0, 1, 1, 0], [0, 0, 1, 0, 1]
    assert P.hamming_dist(a, b, device=CPU) == J.hamming_dist(a, b)
    x, y = np.array([1.0, 2.5, -3.0]), np.array([0.5, 2.0, 1.0])
    assert P.euclid_dist(x, y, device=CPU) == J.euclid_dist(x, y)
    z = np.array([1 + 2j, -0.5j, 3.0])
    assert P.signal_power(z, device=CPU) == pytest.approx(
        J.signal_power(z), rel=1e-15)
    up = P.upsample(z, 3, device=CPU)
    assert up.dtype == complex
    np.testing.assert_array_equal(up, J.upsample(z, 3))
    JI, PI = _pair("impairments")
    w = np.exp(1j * np.linspace(0, 6, 200)).astype(np.complex64)
    np.testing.assert_allclose(PI.add_frequency_offset(w, 1e6, 3e3,
                                                       device=CPU),
                               JI.add_frequency_offset(w, 1e6, 3e3),
                               atol=1e-5)


# ------------------------------------------------------------- channelcoding

def test_channelcoding_conv_and_viterbi_match_jax():
    J, P = _pair("channelcoding")
    mem, g = np.array([2]), np.array([[5, 7]])
    jt, pt = J.Trellis(mem, g), P.Trellis(mem, g)
    rng = np.random.RandomState(3)
    msg = rng.randint(0, 2, 100)
    for term in ("term", "cont"):
        np.testing.assert_array_equal(
            P.conv_encode(msg, pt, term, device=CPU),
            J.conv_encode(msg, jt, term))
    coded = P.conv_encode(msg, pt, device=CPU)
    punct = [1, 1, 1, 0]
    np.testing.assert_array_equal(P.puncturing(coded, punct),
                                  J.puncturing(coded, punct))
    np.testing.assert_array_equal(
        P.depuncturing(P.puncturing(coded, punct), punct, coded.size),
        J.depuncturing(J.puncturing(coded, punct), punct, coded.size))
    rx = (2.0 * coded - 1.0) + rng.randn(coded.size) * 0.8
    for dt, r in (("soft", rx), ("hard", (rx > 0).astype(float)),
                  ("unquantized", -rx)):
        np.testing.assert_array_equal(
            P.viterbi_decode(r, pt, 15, dt, device=CPU),
            J.viterbi_decode(r, jt, 15, dt))


def test_channelcoding_turbo_matches_jax():
    J, P = _pair("channelcoding")
    mem, g = np.array([2]), np.array([[7, 5]])
    jt = J.Trellis(mem, g, feedback=7, code_type="rsc")
    pt = P.Trellis(mem, g, feedback=7, code_type="rsc")
    il_j, il_p = J.RandInterlv(64, 0), P.RandInterlv(64, 0)
    np.testing.assert_array_equal(il_p.p_array, il_j.p_array)
    rng = np.random.RandomState(4)
    msg = rng.randint(0, 2, 64)
    streams_p = P.turbo_encode(msg, pt, pt, il_p, device=CPU)
    streams_j = J.turbo_encode(msg, jt, jt, il_j)
    for a, b in zip(streams_p, streams_j):
        np.testing.assert_array_equal(a, b)
    # the message part of each stream (the decoders take no tail)
    ys = [2.0 * np.asarray(s[:64], float) - 1.0 + rng.randn(64) * 0.7
          for s in streams_p]
    np.testing.assert_array_equal(
        P.turbo_decode(*ys, pt, 0.49, 4, il_p, device=CPU),
        J.turbo_decode(*ys, jt, 0.49, 4, il_j))
    L_int = np.zeros(len(ys[0]))
    lp, dp = P.map_decode(ys[0], ys[1], pt, 0.49, L_int, device=CPU)
    lj, dj = J.map_decode(ys[0], ys[1], jt, 0.49, L_int)
    np.testing.assert_array_equal(dp, np.asarray(dj))
    np.testing.assert_allclose(lp, np.asarray(lj), rtol=0,
                               atol=1e-4 * (1 + np.abs(lj).max()))


def test_channelcoding_ldpc_algebraic_and_polar_match_jax():
    J, P = _pair("channelcoding")
    from commpy_tpu_torch.ops import ldpc as PL
    design = os.path.join(PL.DESIGNS, "gallager", "96.3.963.txt")
    jp, pp = (J.get_ldpc_code_params(design, True),
              P.get_ldpc_code_params(design, True))
    rng = np.random.RandomState(5)
    msg = rng.randint(0, 2, (pp["n_vnodes"] - pp["n_cnodes"], 3))
    cw = P.triang_ldpc_systematic_encode(msg, pp, device=CPU)
    np.testing.assert_array_equal(cw, J.triang_ldpc_systematic_encode(msg,
                                                                      jp))
    llr = ((1.0 - 2.0 * cw.T.ravel()) * 2.0
           + rng.randn(cw.size) * 1.2).astype(np.float32)
    got = P.ldpc_bp_decode(llr, pp, "MSA", 10, device=CPU)
    want = J.ldpc_bp_decode(llr, jp, "MSA", 10)
    np.testing.assert_array_equal(got[0], want[0])
    # BCH, RS and polar encode through the same namespace
    bp, bj = P.bch_construct(5, 2), J.bch_construct(5, 2)
    m_b = rng.randint(0, 2, (4, bp.k))
    word = P.bch_encode(bp, m_b, device=CPU)
    np.testing.assert_array_equal(word.numpy(),
                                  np.asarray(J.bch_encode(bj, m_b)))
    word = word.numpy().copy()
    word[:, 3] ^= 1
    np.testing.assert_array_equal(
        P.bch_decode(bp, word, device=CPU)[0].numpy(),
        np.asarray(J.bch_decode(bj, word)[0]))
    rp, rj = P.rs_construct(4, 2), J.rs_construct(4, 2)
    m_r = rng.randint(0, 16, (4, rp.k))
    np.testing.assert_array_equal(P.rs_encode(rp, m_r, device=CPU).numpy(),
                                  np.asarray(J.rs_encode(rj, m_r)))
    pc, jc = (P.polar_construct(64, 30, crc="crc6"),
              J.polar_construct(64, 30, crc="crc6"))
    m_p = rng.randint(0, 2, (4, 30))
    np.testing.assert_array_equal(P.polar_encode(pc, m_p, device=CPU).numpy(),
                                  np.asarray(J.polar_encode(jc, m_p)))
    assert P.GF(np.arange(4), 2).elements.tolist() == \
        J.GF(np.arange(4), 2).elements.tolist()
    np.testing.assert_array_equal(P.cyclic_code_genpoly(7, 4),
                                  J.cyclic_code_genpoly(7, 4))


# ----------------------------------------------------------------- channels

def test_channel_setters_and_invariants_match_jax():
    J, P = _pair("channels")
    for fading in ((1, 0), (1 + 0j, 0), (0j, 1), (np.sqrt(0.5) + 0j, 0.5)):
        a = P.SISOFlatChannel(fading_param=fading, device=CPU)
        b = J.SISOFlatChannel(fading_param=fading)
        assert (a.isComplex, a.nb_tx, a.nb_rx) == (b.isComplex, 1, 1)
        for args in ((7.5,), (3.0, 0.5, 10), (-2.0, 1 / 3, 2)):
            a.set_SNR_dB(*args)
            b.set_SNR_dB(*args)
            assert a.noise_std == b.noise_std
        a.set_SNR_lin(12.0, 0.75, 10)
        b.set_SNR_lin(12.0, 0.75, 10)
        assert a.noise_std == b.noise_std
        with np.errstate(divide="ignore"):
            assert a.k_factor == b.k_factor
    with pytest.raises(ValueError):
        P.SISOFlatChannel(fading_param=(1, 0.5), device=CPU)
    a, b = (P.MIMOFlatChannel(4, 3, device=CPU), J.MIMOFlatChannel(4, 3))
    rng = np.random.RandomState(6)
    mean = rng.randn(3, 4) + 1j * rng.randn(3, 4)
    calls = [("uncorr_rayleigh_fading", (complex,)),
             ("expo_corr_rayleigh_fading", (np.exp(0.3j), np.exp(-0.7j))),
             ("expo_corr_rayleigh_fading", (np.exp(0.3j), 1.0, 0.2, 0.5)),
             ("uncorr_rician_fading", (mean, 3.0)),
             ("expo_corr_rician_fading", (mean, 2.0, np.exp(0.1j),
                                          np.exp(0.4j), 0.1, 0.3))]
    for meth, args in calls:
        getattr(a, meth)(*args)
        getattr(b, meth)(*args)
        for x, y in zip(a.fading_param, b.fading_param):
            np.testing.assert_array_equal(x, y)
        assert a.k_factor == b.k_factor and a.isComplex == b.isComplex
        a.set_SNR_dB(5.0, 0.5, 2)
        b.set_SNR_dB(5.0, 0.5, 2)
        assert a.noise_std == b.noise_std
    np.testing.assert_array_equal(a.specular_compo(0.3, 0.5, 1.1, 0.25),
                                  b.specular_compo(0.3, 0.5, 1.1, 0.25))
    for bad in (lambda: a.expo_corr_rayleigh_fading(2.0, 1),
                lambda: a._update_corr_KBSM(-1, 0),
                lambda: setattr(a, "fading_param", (mean, np.eye(4),
                                                    np.eye(3)))):
        with pytest.raises(ValueError):
            bad()


def test_channel_propagate_with_given_gains_and_no_noise():
    J, P = _pair("channels")
    rng = np.random.RandomState(7)
    msg = rng.randn(64) + 1j * rng.randn(64)
    a = P.SISOFlatChannel(noise_std=0.0, fading_param=(0.6 + 0.8j, 0),
                          device=CPU)
    b = J.SISOFlatChannel(noise_std=0.0, fading_param=(0.6 + 0.8j, 0))
    np.testing.assert_allclose(a.propagate(msg), b.propagate(msg), atol=1e-6)
    np.testing.assert_allclose(a.unnoisy_output, b.unnoisy_output,
                               atol=1e-6)
    assert not a.noises.any()
    with pytest.raises(TypeError):
        P.SISOFlatChannel(noise_std=0.1, device=CPU).propagate(msg)
    # LOS only: the gains are the mean, every vector
    mean = (rng.randn(3, 2) + 1j * rng.randn(3, 2))
    mean *= np.sqrt(6 / np.sum(np.abs(mean) ** 2))
    fading = (mean, np.zeros((2, 2)), np.zeros((3, 3)))
    a = P.MIMOFlatChannel(2, 3, 0.0, fading, device=CPU)
    b = J.MIMOFlatChannel(2, 3, 0.0, fading)
    out_a, out_b = a.propagate(msg[:63]), b.propagate(msg[:63])
    assert out_a.shape == out_b.shape == (32, 3)
    np.testing.assert_allclose(out_a, out_b, atol=1e-5)
    np.testing.assert_allclose(a.channel_gains,
                               np.broadcast_to(mean, (32, 3, 2)), atol=1e-6)


def test_channel_draws_moments_and_seeding():
    _, P = _pair("channels")
    np.random.seed(11)
    c = P.SISOFlatChannel(fading_param=(0j, 1), device=CPU)
    c.set_SNR_dB(3.0)
    n = 200_000
    out = c.propagate(np.ones(n, complex))
    g, z = c.channel_gains, c.noises
    assert abs(np.mean(np.abs(g) ** 2) - 1) < 0.02
    assert abs(np.mean(g)) < 0.01
    assert abs(np.var(z) / (c.noise_std ** 2 / 2) - 1) < 0.02
    np.testing.assert_allclose(out, g + z, atol=1e-6)
    # Kronecker correlation: H = Rr^1/2 H_iid Rt^T/2, so E[H H^H] =
    # tr(Rt) Rr
    m = P.MIMOFlatChannel(2, 3, device=CPU)
    m.expo_corr_rayleigh_fading(np.exp(0.5j), np.exp(-0.3j), 0.4, 0.2)
    m.noise_std = 0.0
    m.propagate(np.ones(2 * 100_000, complex))
    H = m.channel_gains
    emp = np.mean(H @ H.conj().transpose(0, 2, 1), axis=0)
    want = np.trace(m.fading_param[1]) * m.fading_param[2]
    np.testing.assert_allclose(emp, want, atol=0.03)
    # np.random.seed makes the draws reproducible
    outs = []
    for _ in range(2):
        np.random.seed(5)
        outs.append((P.bsc(np.zeros(1000, int), 0.2, device=CPU),
                     P.bec(np.ones(1000, int), 0.3, device=CPU),
                     P.awgn(np.ones(1000), 6.0, device=CPU)))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    flips, erased, noisy = outs[0]
    assert abs(flips.mean() - 0.2) < 0.05
    assert abs((erased == -1).mean() - 0.3) < 0.05
    assert abs(np.var(noisy) / (1 / (2 * 10 ** 0.6)) * 0.5 - 1) < 0.2


# ------------------------------------------------------------------- links

def _qpsk_model(channel):
    M, L = _pair("modulation")[1], _pair("links")[1]
    modem = M.QAMModem(4, device=CPU)
    return L.LinkModel(modem.modulate, channel,
                       lambda y, h, c, nv: modem.demodulate(y, "hard"),
                       modem.num_bits_symbol, modem.constellation, modem.Es,
                       device=CPU), modem


def test_link_model_noiseless_channel():
    C = _pair("channels")[1]
    model, _ = _qpsk_model(C.SISOFlatChannel(fading_param=(1 + 0j, 0),
                                             device=CPU))
    np.random.seed(3)
    bers = model.link_performance([300.0, 400.0], 4000, 10, 400)
    np.testing.assert_array_equal(bers, [0.0, 0.0])
    BERs, BEs, CEs, NCs = model.link_performance_full_metrics(
        [300.0], 3, 10, 400)
    assert BERs[0] == 0 and not BEs.any() and NCs.sum() == 3
    L = _pair("links")[1]
    assert L.link_performance(model, [300.0], 800, 10, 400)[0] == 0


def test_link_performance_device_uncoded_qpsk_against_theory():
    from commpy_tpu_torch.ops import modem as PM
    C, L = _pair("channels")[1], _pair("links")[1]
    const = PM.qam_constellation(4).astype(np.complex64)
    channel = C.SISOFlatChannel(fading_param=(1 + 0j, 0), device=CPU)
    model = L.LinkModel(
        lambda bits: PM.modulate(bits, const, 2, device=CPU), channel,
        lambda y, h, c, nv: PM.demodulate_hard(y, const, 2),
        2, const, 2.0, device=CPU)
    snrs = np.array([0.0, 4.0])
    bers = model.link_performance_device(snrs, 64_000, 500, 1000,
                                         frames_per_round=16)
    theory = erfc(np.sqrt(10 ** (snrs / 10) / 2)) / 2
    np.testing.assert_allclose(bers, theory, rtol=0.25)
    # over a mesh (one rank here): each round's frames split over the
    # ranks, the same BERs as without a mesh for the same seed
    from commpy_tpu_torch.parallel import make_mesh
    meshed = model.link_performance_device(snrs, 64_000, 500, 1000,
                                           frames_per_round=16,
                                           mesh=make_mesh(1, device=CPU))
    np.testing.assert_array_equal(meshed, bers)


def test_wifi80211_link_performance_matches_batched_link():
    """MCS 4 at 10 dB: the host loop (20 chunks of 1200 bits, the port's
    modem, channel and Viterbi on the CPU) against the port's batched
    802.11 link at the same noise_std.  Both count ~2e3 errors; frames err
    in bursts (a Viterbi error event spans several bits), so the pooled
    binomial 4-sigma band (~9%) is widened to 30%."""
    C, W = _pair("channels")[1], _pair("wifi80211")[1]
    from commpy_tpu_torch.models import wifi80211_device_link
    np.random.seed(21)
    wifi = W.Wifi80211(4, device=CPU)
    channel = C.SISOFlatChannel(fading_param=(1 + 0j, 0), device=CPU)
    BERs, BEs, _, NCs = wifi.link_performance(channel, [10.0], 20, 10**9,
                                              send_chunk=1200)
    link = wifi80211_device_link(4, frame_bits=1200, device=CPU)
    # the two SNR conventions give one noise_std (Es = 10, rate 3/4)
    assert channel.noise_std == pytest.approx(link.noise_std_fn(10.0),
                                              rel=1e-12)
    gen = torch.Generator().manual_seed(21)
    dev_errs = int(link.link_step(gen, 20, float(link.noise_std_fn(10.0))))
    host_errs = int(BEs.sum())
    assert NCs.sum() == 20 and BERs[0] == host_errs / (20 * 1200)
    assert host_errs > 300 and dev_errs > 300, (host_errs, dev_errs)
    assert abs(host_errs - dev_errs) <= 0.3 * max(host_errs, dev_errs)


def test_compatible_api_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    M, C, W = (_pair(n)[1] for n in ("modulation", "channels", "wifi80211"))
    U, L = _pair("utilities")[1], _pair("links")[1]
    for call in (lambda: M.QAMModem(16), lambda: M.ofdm_tx(
                     np.zeros((4, 1)), 8, 4, 2),
                 lambda: C.SISOFlatChannel(), lambda: C.MIMOFlatChannel(2, 2),
                 lambda: C.bsc(np.zeros(4, int), 0.1),
                 lambda: W.Wifi80211(4), lambda: U.signal_power([1.0]),
                 lambda: L.LinkModel(None, None, None, 2, None)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
