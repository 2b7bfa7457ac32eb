"""The port's five DSP and algebraic-code links against the JAX package.

The deterministic part: the same NumPy bits and unit complex noise go
through the JAX package's public ops composed by hand and through the
port's link ``receive`` / ``transceive`` on the CPU.  The decoder inputs
must agree within 1e-4 (an FFT or a float32 solve on either side; LLRs
within 1e-4 x (1 + max |LLR|)) or exactly (hard bits), and the decoded
bits must be identical.  For the DVB-S2 concatenation the inner decode
rests on ``dvbs2_decode_device``, which ``tests/test_torch_dvbs2_nrldpc.py``
holds; its BCH stage, the GF(2^16) t = 12 outer code, is held against the
JAX package's decoder on the link's words and on words with 12 and 14
errors.

The random part: each link's ``link_step`` is clean at high SNR and errs
at low SNR, as in the JAX package's own tests, and 'auto' takes K1/K2
(RRC, ISI) and K5 (DVB-S2) on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commpy_tpu.ops import bch as JB
from commpy_tpu.ops import convcode as JCC
from commpy_tpu.ops import equalize as JE
from commpy_tpu.ops import fir as JFIR
from commpy_tpu.ops import modem as JM
from commpy_tpu.ops import rs as JR
from commpy_tpu.ops import viterbi as JV
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu_torch.models import (make_bch_awgn_link,
                                     make_dvbs2_concat_link,
                                     make_isi_conv_link, make_rrc_conv_awgn_link,
                                     make_rs_awgn_link)
from commpy_tpu_torch.ops import bch as PB
from commpy_tpu_torch.ops import dvbs2 as PD
from commpy_tpu_torch.ops import filters as PF
from commpy_tpu_torch.ops import qcldpc as PQ
from commpy_tpu_torch.ops import rs as PR
from commpy_tpu_torch.ops import viterbi as PV
from commpy_tpu_torch.ops.trellis import Trellis

torch.set_num_threads(1)

K7 = (np.array([6]), np.array([[0o133, 0o171]]))
K3 = (np.array([2]), np.array([[5, 7]]))
H3 = (np.array([1.0, 0.45, -0.2]) + 1j * np.array([0.1, -0.3, 0.05])
      ).astype(np.complex64)


def _draws(link, F, seed):
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 2, (F, link.frame_bits)).astype(np.int8)
    shape = (F,) + link.extras["noise_shape"]
    noise = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    return bits, noise


def _noisy(x, noise, ns):
    return x + jnp.asarray(noise) * (jnp.float32(ns) * 0.5)


def _llr_close(got, want):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * (1 + np.abs(want).max()))


def _step_errors(link, snr_db, F, seed):
    gen = torch.Generator().manual_seed(seed)
    return int(link.link_step(gen, F, float(link.noise_std_fn(snr_db))))


def _qam(m, psk=False):
    c = JM.psk_constellation(m) if psk else JM.qam_constellation(m)
    return c.astype(np.complex64)


# ----------------------------------------------------------------------- RRC

@pytest.mark.parametrize("use_maxlog", [True, False])
def test_rrc_link_transceive_matches_jax_ops(use_maxlog):
    link = make_rrc_conv_awgn_link(trellis=Trellis(*K7), frame_bits=240,
                                   use_maxlog=use_maxlog, device="cpu")
    F, sps, n_taps = 3, 4, 32
    n_sym = 240 * 2 // 4
    assert link.extras["noise_shape"] == ((n_sym - 1) * sps + n_taps,)
    bits, noise = _draws(link, F, 1)
    ns = float(np.float32(link.noise_std_fn(10.0)))
    _, taps = PF.rrcosfilter(n_taps, 0.35, 1.0, float(sps))
    taps = (taps / np.sqrt(np.sum(taps ** 2))).astype(np.float32)
    jt, const = JTrellis(*K7), _qam(16)
    coded, _ = JCC.encode_scan(bits, jt)
    wave = JFIR.upfirdn(JM.modulate(coded, const, 4), taps, up=sps)
    mf = JFIR.fir_filter(_noisy(wave, noise, ns), taps, "full")
    sampled = mf[:, n_taps:n_taps + n_sym * sps:sps]
    demod = JM.demodulate_maxlog if use_maxlog else JM.demodulate_soft
    llr = np.asarray(demod(sampled, const, 4, jnp.float32(ns) ** 2))
    want = np.asarray(JV.viterbi_decode_device(llr, jt, 30, "soft", L=240))
    _llr_close(link.receive(torch.as_tensor(bits), torch.as_tensor(noise),
                            ns).numpy(), llr)
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (want != bits).sum() < bits.size // 10


def test_rrc_link_high_vs_low_snr():
    link = make_rrc_conv_awgn_link(trellis=Trellis(*K3), frame_bits=400,
                                   device="cpu")
    assert _step_errors(link, 25.0, 8, 2) == 0 < _step_errors(link, 8.0, 8, 3)


# ----------------------------------------------------------------------- ISI

def _jax_isi(bits, noise, ns, n_eq):
    jt, const = JTrellis(*K7), _qam(4, psk=True)
    coded, _ = JCC.encode_scan(bits, jt)
    symbols = JM.modulate(coded, const, 2)
    rx = JFIR.fir_filter(symbols, jnp.asarray(H3), "full")[
        ..., :symbols.shape[-1]]
    y = _noisy(rx, noise, ns)
    nv = jnp.float32(ns) ** 2
    w = JE.mmse_fir_taps(jnp.asarray(H3), nv, n_eq)
    d = JE.equalizer_delay(n_eq, 3)
    z = JE.equalize(y, w, d)
    pvec = JE._conv_matrix(jnp.asarray(H3), n_eq)[:, d]
    mse = jnp.maximum(1.0 - jnp.real(jnp.sum(pvec * w)), nv * 1e-2)
    llr = np.asarray(JM.demodulate_soft(z, const, 2, mse))
    return llr, np.asarray(JV.viterbi_decode_device(
        llr, jt, 30, "soft", L=bits.shape[1]))


@pytest.mark.parametrize("n_eq", [1, 21])
def test_isi_link_transceive_matches_jax_ops(n_eq):
    link = make_isi_conv_link(trellis=Trellis(*K7), channel_taps=H3,
                              n_eq_taps=n_eq, frame_bits=300, device="cpu")
    F = 3
    bits, noise = _draws(link, F, 4)
    ns = float(np.float32(link.noise_std_fn(6.0)))
    llr, want = _jax_isi(bits, noise, ns, n_eq)
    _llr_close(link.receive(torch.as_tensor(bits), torch.as_tensor(noise),
                            ns).numpy(), llr)
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    np.testing.assert_array_equal(got.numpy(), want)


def test_isi_link_high_vs_low_snr_and_equalizer_gain():
    # the JAX package's own test: 25 dB clean, 2 dB errs, and at 8 dB the
    # MMSE front end beats a 1-tap receiver tenfold
    tr = Trellis(*K3)
    link = make_isi_conv_link(trellis=tr, channel_taps=H3, frame_bits=500,
                              device="cpu")
    assert _step_errors(link, 25.0, 16, 5) == 0 < _step_errors(link, 2.0, 16,
                                                               5)
    one_tap = make_isi_conv_link(trellis=tr, channel_taps=H3, frame_bits=500,
                                 n_eq_taps=1, device="cpu")
    assert _step_errors(link, 8.0, 16, 6) * 10 < _step_errors(one_tap, 8.0,
                                                              16, 6)


# ----------------------------------------------------------------------- BCH

@pytest.mark.parametrize("decoder", ["hard", "chase"])
def test_bch_link_transceive_matches_jax_ops(decoder):
    pc, jc = PB.bch_construct(5, 2), JB.bch_construct(5, 2)
    link = make_bch_awgn_link(code=pc, decoder=decoder, device="cpu")
    F = 64
    bits, noise = _draws(link, F, 7)
    ns = float(np.float32(link.noise_std_fn(2.0)))
    const = _qam(2, psk=True)
    y = _noisy(JM.modulate(JB.bch_encode(jc, bits), const, 1), noise, ns)
    if decoder == "chase":
        llr = np.asarray(JM.demodulate_soft(y, const, 1,
                                            jnp.float32(ns) ** 2))
        want = JB.bch_chase_decode(jc, (llr > 0).astype(np.int8),
                                   np.abs(llr))[0]
        _llr_close(link.receive(torch.as_tensor(bits),
                                torch.as_tensor(noise), ns).numpy(), llr)
    else:
        hard = np.asarray(JM.demodulate_hard(y, const, 1))
        want = JB.bch_decode(jc, hard)[0]
        np.testing.assert_array_equal(
            link.receive(torch.as_tensor(bits), torch.as_tensor(noise),
                         ns).numpy(), hard)
    want = np.asarray(want)[:, :jc.k]
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != bits).any()


def test_bch_links_high_vs_low_snr():
    code = PB.bch_construct(6, 3, shorten=13)
    link = make_bch_awgn_link(code=code, device="cpu")
    assert _step_errors(link, 12.0, 16, 8) == 0 < _step_errors(link, 0.0, 16,
                                                               8)
    with pytest.raises(ValueError):
        make_bch_awgn_link(code=code, decoder="nope", device="cpu")
    # Chase-2 beats hard decoding at the (31,21) waterfall
    c31 = PB.bch_construct(5, 2)
    eh = _step_errors(make_bch_awgn_link(code=c31, device="cpu"), 4.0, 400,
                      9)
    ec = _step_errors(make_bch_awgn_link(code=c31, decoder="chase",
                                         device="cpu"), 4.0, 400, 9)
    assert eh > 3 * ec > 0


# ------------------------------------------------------------------------ RS

@pytest.mark.parametrize("decoder", ["hard", "gmd"])
def test_rs_link_transceive_matches_jax_ops(decoder):
    pc, jc = PR.rs_construct(4, 2, fcr=0), JR.rs_construct(4, 2, fcr=0)
    link = make_rs_awgn_link(code=pc, decoder=decoder, device="cpu")
    F, m = 16, 4
    bits, noise = _draws(link, F, 10)
    ns = float(np.float32(link.noise_std_fn(11.0)))
    const = _qam(16)
    msg = JR._bits_to_sym(jnp.asarray(bits.reshape(F, jc.k, m),
                                      jnp.float32), m)
    cw_bits = JR._sym_to_bits(JR.rs_encode(jc, msg), m).reshape(F, -1)
    y = _noisy(JM.modulate(cw_bits.astype(jnp.int8), const, 4), noise, ns)
    if decoder == "gmd":
        llr = np.asarray(JM.demodulate_soft(y, const, 4,
                                            jnp.float32(ns) ** 2))
        rx = JR._bits_to_sym(jnp.asarray((llr > 0).reshape(F, jc.n, m),
                                         jnp.float32), m)
        rel = np.abs(llr).reshape(F, jc.n, m).min(-1)
        corrected = JR.rs_gmd_decode(jc, rx, rel)[0]
        _llr_close(link.receive(torch.as_tensor(bits),
                                torch.as_tensor(noise), ns).numpy(), llr)
    else:
        hard = np.asarray(JM.demodulate_hard(y, const, 4))
        rx = JR._bits_to_sym(jnp.asarray(hard.reshape(F, jc.n, m),
                                         jnp.float32), m)
        corrected = JR.rs_decode(jc, rx)[0]
    want = np.asarray(JR._sym_to_bits(jnp.asarray(corrected)[:, :jc.k],
                                      m)).reshape(F, -1)
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != bits).any() and (want == bits).all(-1).any()


def test_rs_link_high_vs_low_snr():
    code = PR.rs_construct(4, 2, fcr=0)
    for decoder in ("hard", "gmd"):
        link = make_rs_awgn_link(code=code, decoder=decoder, device="cpu")
        assert _step_errors(link, 40.0, 16, 11) == 0 < _step_errors(
            link, 8.0, 16, 11)
    with pytest.raises(ValueError):
        make_rs_awgn_link(code=code, decoder="nope", device="cpu")


# -------------------------------------------------------- DVB-S2 concatenated

@pytest.fixture(scope="module")
def dvbs2():
    return PD.dvbs2_qc_params(PD.synthetic_address_table(16200, "1/2",
                                                         seed=0),
                              16200, "1/2")


def test_dvbs2_concat_link_bch_stage_matches_jax(dvbs2):
    link = make_dvbs2_concat_link(qc_params=dvbs2, device="cpu")
    outer = link.extras["outer"]
    assert (outer.n, outer.k, outer.m, outer.t) == (7200, 7008, 16, 12)
    jc = JB.bch_construct(16, 12, shorten=(1 << 16) - 1 - 7200)
    assert jc.genpoly == outer.genpoly
    F = 2
    bits, noise = _draws(link, F, 12)
    # the JAX package's outer encoder, the port's DVB-S2 encoder
    inner = np.asarray(JB.bch_encode(jc, bits))
    np.testing.assert_array_equal(
        PB.bch_encode(outer, bits, device="cpu").numpy(), inner)
    ns = float(np.float32(link.noise_std_fn(1.6)))
    cw = PD.dvbs2_encode_device(inner, dvbs2, device="cpu").numpy()
    const = _qam(4, psk=True)
    y = _noisy(JM.modulate(cw, const, 2), noise, ns)
    llr = -np.asarray(JM.demodulate_soft(y, const, 2, jnp.float32(ns) ** 2))
    rx = link.receive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    _llr_close(rx.numpy(), llr)
    dec, _ = PD.dvbs2_decode_device(rx, dvbs2, "MSA", 30, msa_scale=0.75,
                                    device="cpu")
    words = dec[:, :7200].numpy().astype(np.int8)
    # two more words, with 12 and 14 errors: one corrected, one refused
    rng = np.random.default_rng(13)
    extra = np.repeat(inner[:1], 2, axis=0)
    for row, e in enumerate((12, 14)):
        extra[row, rng.choice(7200, e, replace=False)] ^= 1
    words = np.concatenate([words, extra])
    want = [np.asarray(a) for a in JB.make_bch_decoder(jc)(
        jnp.asarray(words))]
    got = PB.make_bch_decoder(outer, device="cpu")(words)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert list(want[1][2:]) == [12, 0] and list(want[2][2:]) == [True,
                                                                  False]
    out = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    np.testing.assert_array_equal(out.numpy(), want[0][:F, :7008])


def test_dvbs2_concat_link_high_vs_low_snr(dvbs2):
    link = make_dvbs2_concat_link(qc_params=dvbs2, device="cpu")
    assert _step_errors(link, 5.0, 2, 14) == 0 < _step_errors(link, 1.0, 2,
                                                              14)


# ------------------------------------------------------------ routes, device

def test_auto_routes_take_the_kernels_on_cuda(dvbs2):
    for link in (make_rrc_conv_awgn_link(trellis=Trellis(*K7), device="cpu"),
                 make_isi_conv_link(trellis=Trellis(*K7), channel_taps=H3,
                                    frame_bits=1200, device="cpu")):
        # Paths H and I: K1 and K2
        assert PV.viterbi_route(link.extras["trellis"], "auto",
                                "cuda") == "kernels"
    # Path L: the layered decode of the 16200 code goes to K5
    assert PQ.select_backend(dvbs2, "layered") == "streamed"


def test_links_default_to_cuda(dvbs2):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    calls = [lambda: make_rrc_conv_awgn_link(trellis=Trellis(*K7)),
             lambda: make_isi_conv_link(trellis=Trellis(*K7),
                                        channel_taps=H3),
             lambda: make_bch_awgn_link(code=PB.bch_construct(5, 2)),
             lambda: make_rs_awgn_link(code=PR.rs_construct(4, 2)),
             lambda: make_dvbs2_concat_link(qc_params=dvbs2)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
