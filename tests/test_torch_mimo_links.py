"""The port's four MIMO and OFDM links against the JAX package.

The deterministic part: the same NumPy bits, unit complex noise and
channel draws go through the JAX package's public ops composed by hand
(modulate -> channel -> OFDM -> detect -> decode) and through the port's
link ``receive``/``transceive`` on the CPU.  The decoder inputs must agree
(LLRs within rtol 1e-4 with the +-inf positions equal, detected symbols
identically) and the decoded bits must be identical.  The detectors'
+-inf LLRs reach the Viterbi and LDPC decoders, which clip them; the
kernels' route (its plain versions on the CPU) must decode them as the
plain path does.

The random part: each link's ``link_step`` is clean at high SNR and makes
errors at low SNR, and the K-best link's BER at the reference's anchor
point agrees with the JAX link's within Monte-Carlo error.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commpy_tpu.models import device_links as JDL
from commpy_tpu.ops import convcode as JCC
from commpy_tpu.ops import impairments as JI
from commpy_tpu.ops import ldpc as JL
from commpy_tpu.ops import mimo as JMI
from commpy_tpu.ops import modem as JM
from commpy_tpu.ops import ofdm as JO
from commpy_tpu.ops import qcldpc as JQ
from commpy_tpu.ops import sync as JS
from commpy_tpu.ops import viterbi as JV
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu_torch.models import (make_bestfirst_ldpc_mimo_link,
                                     make_kbest_mimo_link,
                                     make_ofdm_mimo_conv_link,
                                     make_ofdm_qcldpc_link)
from commpy_tpu_torch.ops import ldpc as PL
from commpy_tpu_torch.ops import qcldpc as PQ
from commpy_tpu_torch.ops import viterbi as PV
from commpy_tpu_torch.ops.trellis import Trellis

torch.set_num_threads(1)

# the JAX detectors under jit: one compile a shape instead of one a
# primitive, the same arithmetic
J_KBEST = jax.jit(JMI.kbest_device, static_argnums=(3, 5, 6))
J_BEST_FIRST = jax.jit(JMI.best_first_device, static_argnames=("beam",))

K7 = (np.array([6]), np.array([[0o133, 0o171]]))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIMAX = os.path.join(REPO, "commpy_tpu", "designs", "ldpc", "wimax",
                     "1440.720.txt")


def _crandn(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _draws(link, F, seed, scale):
    """Bits, unit complex noise and the link's channel draw (NumPy)."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (F, link.frame_bits)).astype(np.int8)
    noise = _crandn(rng, F, *link.extras["noise_shape"])
    h = _crandn(rng, F, *link.extras["channel_shape"]) * np.float32(scale)
    return bits, noise, h


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _close_with_infs(got, want, rtol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=rtol)


def _jax_mimo_channel(x, h, noise, ns):
    return (jnp.einsum("fvrt,fvt->fvr", jnp.asarray(h), x)
            + jnp.asarray(noise) * (jnp.float32(ns) * 0.5))


def _step_errors(link, snr_db, F, seed):
    gen = torch.Generator().manual_seed(seed)
    return int(link.link_step(gen, F, float(link.noise_std_fn(snr_db))))


# ------------------------------------------------------------ K-best (uncoded)

def test_kbest_link_transceive_matches_jax_ops():
    link = make_kbest_mimo_link(vectors_per_frame=16, device="cpu")
    F, nv = 4, 16
    bits, noise, h = _draws(link, F, 1, np.sqrt(0.5))
    ns = float(np.float32(link.noise_std_fn(16.0)))
    const = JM.qam_constellation(16).astype(np.complex64)
    x = JM.modulate(bits, const, 4).reshape(F, nv, 4)
    y = _jax_mimo_channel(x, h, noise, ns)
    xh = J_KBEST(y.reshape(-1, 4), jnp.asarray(h).reshape(-1, 4, 4), const,
                 16)
    want = np.asarray(JM.demodulate_hard(xh.reshape(F, -1), const, 4))
    got_x = link.receive(*_t(bits, noise), ns, torch.as_tensor(h))
    np.testing.assert_array_equal(got_x.numpy(),
                                  np.asarray(xh).reshape(F, -1))
    got = link.transceive(*_t(bits, noise), ns, torch.as_tensor(h))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want != bits).sum() < bits.size // 10


def test_kbest_link_clean_noiseless_and_ber_matches_jax_link():
    link = make_kbest_mimo_link(vectors_per_frame=8, device="cpu")
    assert _step_errors(link, 60.0, 8, 2) == 0
    # the reference's anchor point, 10 + 10 log10(4) dB (BER ~3e-2)
    snr = 10.0 + 10 * np.log10(4)
    F = 64
    port = _step_errors(link, snr, F, 3)
    jlink = JDL.make_kbest_mimo_link(vectors_per_frame=8)
    keys = jax.random.split(jax.random.PRNGKey(3), F)
    jerr = int(jlink.link_step(keys, jlink.noise_std_fn(snr)))
    n = F * link.frame_bits
    # two independent estimates of one BER: their difference within four
    # standard deviations of its binomial spread
    p = (port + jerr) / (2 * n)
    assert abs(port - jerr) <= 4 * np.sqrt(2 * n * p * (1 - p)), (port, jerr)
    assert 0.3 * 3e-2 < p < 3 * 3e-2


# ------------------------------------------------------ best-first / K-best LDPC

@pytest.fixture(scope="module")
def wimax():
    a = JL.get_ldpc_code_params(WIMAX, True)
    b = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, "wimax",
                                             "1440.720.txt"), True)
    return a, b


@pytest.mark.parametrize("detector", ["bestfirst", "kbest"])
def test_ldpc_mimo_link_transceive_matches_jax_ops(wimax, detector):
    a, b = wimax
    link = make_bestfirst_ldpc_mimo_link(ldpc_params=b, detector=detector,
                                         beam=16, device="cpu")
    F, n_vec = 2, 90
    bits, noise, h = _draws(link, F, 4, np.sqrt(0.5))
    ns = float(np.float32(link.noise_std_fn(19.0)))
    G = np.asarray(a["generator_matrix"].todense()) % 2
    const = JM.qam_constellation(16).astype(np.complex64)
    x = JM.modulate(JL.ldpc_encode_device(bits, G), const, 4).reshape(
        F, n_vec, 4)
    y = _jax_mimo_channel(x, h, noise, ns)
    yv, hv = y.reshape(-1, 4), jnp.asarray(h).reshape(-1, 4, 4)
    if detector == "kbest":
        llr = J_KBEST(yv, hv, const, 16, jnp.float32(ns) ** 2, "soft", 4)
    else:
        llr = J_BEST_FIRST(yv, hv, const, beam=16)
    llr = np.asarray(llr).reshape(F, 1440)
    dj, _ = jax.jit(lambda x: JL.ldpc_bp_decode_device(x, a, "MSA", 15))(
        llr)
    want = np.asarray(dj)[:, :link.frame_bits]
    rx = link.receive(*_t(bits, noise), ns, torch.as_tensor(h))
    _close_with_infs(rx.numpy(), llr)
    if detector == "kbest":
        # +-inf LLRs reach the decoder; its kernel route (the plain K4 on
        # the CPU) clips them as the plain core does
        assert np.isinf(rx.numpy()).any()
        kern = PL.ldpc_bp_decode_device(rx, b, "MSA", 15, device="cpu")
        clipped = PL.ldpc_bp_decode_device(torch.clamp(rx, -PQ._llr_max,
                                                       PQ._llr_max), b,
                                           "MSA", 15, device="cpu")
        for k, c in zip(kern, clipped):
            np.testing.assert_array_equal(k.numpy(), c.numpy())
        assert b["_qc_lift"] is not None  # the QC route: K4's on the card
    got = link.transceive(*_t(bits, noise), ns, torch.as_tensor(h))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != bits).mean() < 0.05


def test_ldpc_mimo_link_high_vs_low_snr(wimax):
    link = make_bestfirst_ldpc_mimo_link(ldpc_params=wimax[1], beam=16,
                                         device="cpu")
    assert _step_errors(link, 35.0, 2, 5) == 0 < _step_errors(link, 8.0, 2,
                                                              6)
    with pytest.raises(ValueError, match="unknown detector"):
        make_bestfirst_ldpc_mimo_link(ldpc_params=wimax[1], detector="ml",
                                      device="cpu")


# ---------------------------------------------------------------- OFDM MIMO conv

def test_ofdm_mimo_link_transceive_matches_jax_ops():
    link = make_ofdm_mimo_conv_link(trellis=Trellis(*K7), n_ofdm_symbols=2,
                                    device="cpu")
    F, nt, nsc, n_ofdm, nfft = 3, 2, 48, 2, 64
    bits, noise, h = _draws(link, F, 7, np.sqrt(0.5))
    ns = float(np.float32(link.noise_std_fn(14.0)))
    jt = JTrellis(*K7)
    const = JM.qam_constellation(16).astype(np.complex64)
    coded, _ = JCC.encode_scan(bits, jt)
    grids = jnp.moveaxis(JM.modulate(coded, const, 4).reshape(
        F, nt, n_ofdm, nsc), -1, -2)
    tx = JO.ofdm_tx(grids, nfft, nsc, 16)
    rx = (jnp.einsum("frt,ftn->frn", jnp.asarray(h), tx)
          + jnp.asarray(noise) * (jnp.float32(ns) * 0.5))
    rx_vec = jnp.moveaxis(JO.ofdm_rx(rx, nfft, nsc, 16), 1, -1)
    h_rep = jnp.broadcast_to(jnp.asarray(h)[:, None], (F, nsc * n_ofdm, 2, 2))
    llr = J_KBEST(rx_vec.reshape(-1, 2), h_rep.reshape(-1, 2, 2), const, 8,
                  jnp.float32(ns) ** 2 * 64.0, "soft", 4)
    llr = -np.asarray(jnp.transpose(llr.reshape(F, nsc, n_ofdm, nt, 4),
                                    (0, 3, 2, 1, 4))).reshape(F, -1)
    want = np.asarray(JV.viterbi_decode_device(llr, jt, 30, "soft",
                                               L=link.frame_bits))
    got_llr = link.receive(*_t(bits, noise), ns, torch.as_tensor(h))
    _close_with_infs(got_llr.numpy(), llr)
    assert np.isinf(got_llr.numpy()).any()
    # K1/K2's route (their plain versions here) clips the +-inf LLRs at
    # +-500: it decodes them as it decodes the clipped values
    pt = Trellis(*K7)
    kern = PV.viterbi_decode_device(got_llr, pt, 30, "soft",
                                    L=link.frame_bits, device="cpu")
    clipped = PV.viterbi_decode_device(torch.clamp(got_llr, -500, 500), pt,
                                       30, "soft", L=link.frame_bits,
                                       device="cpu")
    np.testing.assert_array_equal(kern.numpy(), clipped.numpy())
    got = link.transceive(*_t(bits, noise), ns, torch.as_tensor(h))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(kern.numpy(), want)


def test_ofdm_mimo_link_high_vs_low_snr():
    # block fading, one channel a frame: a deep fade can cost a frame even
    # at high SNR (the JAX package's test asks < 1% there)
    link = make_ofdm_mimo_conv_link(trellis=Trellis(*K7), n_ofdm_symbols=2,
                                    device="cpu")
    F = 16
    hi = _step_errors(link, 35.0, F, 8)
    assert hi / (F * link.frame_bits) < 0.01
    assert _step_errors(link, 5.0, F, 9) > hi


# ------------------------------------------------------------------ OFDM LDPC

def _jax_ofdm_ldpc(jp, bits, noise, g, ns, csi, cfo, cfo_correction,
                   nfft=64, nsc=54, cp=16, n_taps=4):
    """The JAX package's OFDM-LDPC chain on the given draws (QPSK)."""
    const = JM.qam_constellation(4).astype(np.complex64)
    Es = float(np.mean(np.abs(JM.qam_constellation(4)) ** 2))
    F = bits.shape[0]
    n_sym = jp["n_vnodes"] // 2
    n_ofdm = n_sym // nsc
    grids = jnp.moveaxis(JM.modulate(JQ.qc_encode_device(bits, jp), const,
                                     2).reshape(F, n_ofdm, nsc), -1, -2)
    pilot = (np.sqrt(Es) * (1.0 - 2.0 * (np.arange(nsc) % 2))).astype(
        np.complex64)
    if csi != "perfect":
        grids = jnp.concatenate([jnp.broadcast_to(
            jnp.asarray(pilot)[None, :, None], (F, nsc, 1)), grids], -1)
    tx = JO.ofdm_tx(grids, nfft, nsc, cp)
    g = jnp.asarray(g)
    rx = jnp.zeros_like(tx)
    for tap in range(n_taps):
        shifted = tx if tap == 0 else jnp.pad(tx, ((0, 0), (tap, 0)))[
            :, :tx.shape[1]]
        rx = rx + g[:, tap:tap + 1] * shifted
    if cfo:
        rx = JI.add_frequency_offset(rx, Fs=float(nfft), delta_f=cfo)
    nsj = jnp.float32(ns)
    rx = rx + jnp.asarray(noise) * (nsj * 0.5)
    if cfo_correction:
        eps = JS.cfo_estimate_cp(rx, nfft, cp, rx.shape[1] // (nfft + cp))
        rx = JS.cfo_correct(rx, eps, nfft)
    rg = JO.ofdm_rx(rx, nfft, nsc, cp)
    if csi != "perfect":
        H = rg[:, :, 0] / jnp.asarray(pilot)[None, :]
        if csi == "smooth":
            H = H @ jnp.asarray(JO.delay_subspace_matrix(nfft, nsc,
                                                         n_taps)).T
        rg = rg[:, :, 1:]
    else:
        bins = JO.subcarrier_bins(nfft, nsc)
        W = np.exp(-2j * np.pi * bins[:, None] * np.arange(n_taps)[None, :]
                   / nfft).astype(np.complex64)
        H = jnp.einsum("st,ft->fs", jnp.asarray(W), g)
    z = jnp.moveaxis(rg / H[:, :, None], -1, -2).reshape(F, n_sym)
    nv = nsj ** 2 * float(nfft) / jnp.maximum(jnp.abs(H[:, :, None]) ** 2,
                                               1e-12)
    nv = jnp.moveaxis(jnp.broadcast_to(nv, (F, nsc, n_ofdm)), -1,
                      -2).reshape(F, n_sym)
    llr = np.asarray(-JM.demodulate_soft(z, const, 2, nv))
    dec, _ = jax.jit(lambda x: JQ.qc_bp_decode_device(
        x, jp, "MSA", 15, backend="xla"))(llr)
    return llr, np.asarray(dec)[:, :jp["k_bits"]]


@pytest.mark.parametrize("csi,cfo,corr,snr", [
    ("perfect", 0.0, False, 10.0), ("ls", 0.0, False, 15.0),
    ("smooth", 0.0, False, 14.0), ("ls", 0.2, True, 20.0)],
    ids=["perfect", "ls", "smooth", "ls-cfo-corrected"])
def test_ofdm_ldpc_link_transceive_matches_jax_ops(csi, cfo, corr, snr):
    # at SNRs where every frame's BP converges: on a frame that does not,
    # the port's K4 route (Pallas order) and the JAX package's XLA core
    # fold the flooding totals in different orders
    jp = JQ.ieee80211n_params(648, "1/2")
    link = make_ofdm_qcldpc_link(qc_params=PQ.ieee80211n_params(648, "1/2"),
                                 csi=csi, cfo=cfo, cfo_correction=corr,
                                 device="cpu")
    F = 4
    bits, noise, g = _draws(link, F, 11, np.sqrt(0.5 / 4))
    ns = float(np.float32(link.noise_std_fn(snr)))
    llr, want = _jax_ofdm_ldpc(jp, bits, noise, g, ns, csi, cfo, corr)
    rx = link.receive(*_t(bits, noise), ns, torch.as_tensor(g))
    np.testing.assert_allclose(rx.numpy(), llr, rtol=1e-4, atol=1e-4)
    got = link.transceive(*_t(bits, noise), ns, torch.as_tensor(g))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != bits).mean() < 0.1


def test_ofdm_ldpc_link_csi_cfo_behaviour():
    qc = PQ.ieee80211n_params(648, "1/2")

    def link(**kw):
        return make_ofdm_qcldpc_link(qc_params=qc, device="cpu", **kw)

    for csi in ("perfect", "ls", "smooth"):
        assert _step_errors(link(csi=csi), 30.0, 8, 12) == 0, csi
    assert _step_errors(link(csi="ls"), 0.0, 8, 13) > 0
    # smoothing the LS estimate does not lose to LS on the same draws
    ls = _step_errors(link(csi="ls"), 6.0, 16, 14)
    sm = _step_errors(link(csi="smooth"), 6.0, 16, 14)
    assert sm <= ls and ls > 0
    # a fractional CFO: blind CP correction recovers it, nothing else does
    assert _step_errors(link(csi="ls", cfo=0.2, cfo_correction=True), 30.0,
                        8, 15) == 0
    assert _step_errors(link(csi="ls", cfo=0.2), 30.0, 8, 15) > 0
    with pytest.raises(ValueError, match="csi must be"):
        link(csi="blind")
    with pytest.raises(ValueError, match="cyclic prefix"):
        link(n_taps=20)


def test_links_default_to_cuda(wimax):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    calls = [lambda: make_kbest_mimo_link(),
             lambda: make_bestfirst_ldpc_mimo_link(ldpc_params=wimax[1]),
             lambda: make_ofdm_mimo_conv_link(trellis=Trellis(*K7)),
             lambda: make_ofdm_qcldpc_link(
                 qc_params=PQ.ieee80211n_params(648, "1/2"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
