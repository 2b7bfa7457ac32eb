"""The port's polar codes against the JAX package and ``tests/polar_ref.py``.

Construction (Bhattacharyya and GA frozen sets), the encoder, the
systematic encoder and rate matching in all three modes are integer or
float64 host arithmetic and are held bit for bit.  SC and both SCL
decoders (the blocked scan and the one specialised to the frozen
mask) are held bit for bit with min-sum f and the approximate path
metric: payload, path metrics and the whole list (``full=True``), also
on inputs built to tie.  The exact rules (``logaddexp``) round
differently in XLA and PyTorch: their path metrics are held within
rtol = atol = 1e-5 (float32 rounding of sums of ~100 terms), with
identical decisions, on the configurations the JAX package's own tests
hold its two SCL decoders to.

CRC24C: the port's ``crc24c`` is the 3GPP polynomial and the JAX
package's is not (see ``commpy_tpu_torch/ops/crc.py``), so the parity
tests use crc6, crc11 and crc16; a crc24c code is held against the JAX
package only through :func:`convert.polar_code_from_fields`, which
carries the JAX package's polynomial as an explicit ``CrcSpec``.

The link: on shared draws (``transceive``) the port's decisions equal
the JAX ops composed by hand; its BER from its own draws is held to the
JAX link's within Monte-Carlo error.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import polar_ref
from commpy_tpu.models.device_links import \
    make_polar_awgn_link as jax_polar_link
from commpy_tpu.ops import modem as JM
from commpy_tpu.ops import polar as JP
from commpy_tpu_torch import convert
from commpy_tpu_torch.models import make_polar_awgn_link
from commpy_tpu_torch.ops import polar as PP

torch.set_num_threads(1)

CPU = "cpu"


def _codes(N, K, **kw):
    return (JP.polar_construct(N, K, **kw), PP.polar_construct(N, K, **kw))


def _random_codes(rng, N, K, crc=None):
    frozen = np.ones(N, bool)
    k_total = K + (PP.CrcSpec.named(crc).length if crc else 0)
    frozen[rng.choice(N, k_total, replace=False)] = False
    mask = tuple(frozen.tolist())
    return (JP.PolarCode(N=N, K=K, frozen=mask,
                         crc=JP.CrcSpec.named(crc) if crc else None),
            PP.PolarCode(N=N, K=K, frozen=mask,
                         crc=PP.CrcSpec.named(crc) if crc else None))


def _np(outs):
    return [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
            for o in outs]


# ------------------------------------------------------------ construction

@pytest.mark.parametrize("method", ["bhattacharyya", "ga"])
@pytest.mark.parametrize("N,K,snr,kw", [
    (8, 4, 0.0, {}), (128, 64, 1.0, {}), (256, 77, -0.5, {}),
    (1024, 512, 2.0, {}), (1024, 512, 2.0, {"crc": "crc11"}),
    (128, 80, 2.0, {"E": 100}), (128, 30, 2.0, {"E": 100}),
    (128, 64, 2.0, {"E": 200}), (256, 120, 2.0, {"crc": "crc11",
                                                "systematic": True})])
def test_construction_identical(method, N, K, snr, kw):
    j, p = _codes(N, K, method=method, design_snr_db=snr, **kw)
    assert p.frozen == j.frozen
    assert (p.N, p.K, p.rm, p.systematic, p.E, p.rate) == \
        (j.N, j.K, j.rm, j.systematic, j.E, j.rate)
    assert np.array_equal(p.info_positions, j.info_positions)


def test_construction_validation():
    with pytest.raises(ValueError):
        PP.polar_construct(100, 10)
    with pytest.raises(ValueError):
        PP.polar_construct(64, 65)
    with pytest.raises(ValueError):
        PP.polar_construct(64, 32, method="nope")
    with pytest.raises(ValueError):
        PP.PolarCode(N=8, K=5, frozen=(True,) * 4 + (False,) * 4)
    with pytest.raises(ValueError):
        PP.polar_construct(128, 90, E=80)
    with pytest.raises(ValueError):
        PP.polar_construct(128, 64, E=200, rm_mode="shorten")


# ----------------------------------------------------------------- encoders

@pytest.mark.parametrize("N,K,kw", [
    (2, 1, {}), (64, 30, {}), (256, 200, {}), (128, 60, {"crc": "crc11"}),
    (256, 100, {"crc": "crc16"}), (128, 60, {"crc": "crc11",
                                             "systematic": True}),
    (256, 120, {"crc": "crc6", "systematic": True})])
def test_encoder_bit_for_bit(N, K, kw):
    j, p = _codes(N, K, design_snr_db=2.0, **kw)
    rng = np.random.default_rng(7 + N + K)
    msg = rng.integers(0, 2, (5, K))
    got = PP.polar_encode(p, msg, device=CPU)
    assert got.dtype == torch.int8
    want = np.asarray(JP.polar_encode(j, msg))
    np.testing.assert_array_equal(got.numpy(), want)
    if not kw:
        u = np.zeros((5, N), np.int64)
        u[:, p.info_positions] = msg
        np.testing.assert_array_equal(got.numpy(), polar_ref.encode_np(u))
    if kw.get("systematic"):
        np.testing.assert_array_equal(
            got.numpy()[:, p.info_positions[:K]], msg)


@pytest.mark.parametrize("E,K,mode", [(96, 60, "shorten"),
                                      (96, 30, "puncture"),
                                      (200, 64, "repeat"),
                                      (300, 40, "repeat")])
def test_rate_match_and_recover_bit_for_bit(E, K, mode):
    j, p = _codes(128, K, E=E, rm_mode=mode, design_snr_db=2.0)
    assert p.rm == j.rm == (mode, E)
    rng = np.random.default_rng(E)
    msg = rng.integers(0, 2, (4, K))
    tx = PP.polar_rate_match(p, PP.polar_encode(p, msg, device=CPU),
                             device=CPU)
    want = np.asarray(JP.polar_rate_match(j, JP.polar_encode(j, msg)))
    np.testing.assert_array_equal(tx.numpy(), want)
    llr_e = (rng.normal(size=(4, E)) * 3).astype(np.float32)
    got = PP.polar_rate_recover(p, llr_e, device=CPU).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(JP.polar_rate_recover(j, jnp.asarray(llr_e))))
    if mode == "shorten":
        assert np.all(got[:, E:] == PP._SHORTEN_LLR)
    # noiseless round trip through the recovered LLRs
    clean = ((1.0 - 2.0 * tx.numpy()) * 12.0).astype(np.float32)
    llr = PP.polar_rate_recover(p, clean, device=CPU)
    np.testing.assert_array_equal(
        PP.polar_sc_decode(p, llr, device=CPU).numpy(), msg)


# --------------------------------------------------------------- SC decoder

@pytest.mark.parametrize("N,K,rule,seed,scale", [
    (2, 1, "minsum", 13, 3.0), (8, 4, "minsum", 19, 3.0),
    (128, 77, "minsum", 139, 3.0), (256, 128, "minsum", 267, 3.0),
    # the exact rule on the JAX package's own SC golden input
    # (tests/test_polar.py:124): elsewhere an f value near 0 can round to
    # the other sign in XLA, where the golden and the port agree
    (64, 40, "exact", 5, 2.0)])
def test_sc_bit_for_bit(N, K, rule, seed, scale):
    rng = np.random.default_rng(seed)
    j, p = _random_codes(rng, N, K)
    llr = (rng.normal(size=(6, N)) * scale).astype(np.float32)
    want = np.asarray(JP.make_polar_sc_decoder(j, rule=rule, full=True)(
        jnp.asarray(llr)))
    for be in (None, 2, 6, 9):
        got = PP.make_polar_sc_decoder(p, rule=rule, full=True, block_exp=be,
                                       device=CPU)(llr).numpy()
        np.testing.assert_array_equal(got, want)
    for b in range(6):
        np.testing.assert_array_equal(
            want[b], polar_ref.sc_decode_np(llr[b], p.frozen_mask, rule))
    assert not want[:, p.frozen_mask].any()


def test_sc_systematic_payload_and_bf16_ber():
    j, p = _codes(256, 128, design_snr_db=2.0, systematic=True)
    rng = np.random.default_rng(23)
    msg = rng.integers(0, 2, (512, 128))
    x = PP.polar_encode(p, msg, device=CPU).numpy()
    sigma = 1.0 / np.sqrt(2.0 * 10 ** 0.3 * p.rate)
    llr = ((2.0 / sigma**2) * ((1.0 - 2.0 * x) + sigma * rng.normal(
        size=x.shape))).astype(np.float32)
    got32 = PP.polar_sc_decode(p, llr, device=CPU).numpy()
    np.testing.assert_array_equal(
        got32, np.asarray(JP.polar_sc_decode(j, llr)))
    got16 = PP.make_polar_sc_decoder(p, dtype="bf16", device=CPU)(llr)
    ber32 = np.mean(got32 != msg)
    ber16 = np.mean(got16.numpy() != msg)
    # the JAX package's own bound for its bf16 state (test_polar.py:145)
    assert ber16 < max(3.0 * ber32, 5e-3), (ber16, ber32)


# -------------------------------------------------------------- SCL decoders

@functools.lru_cache(maxsize=None)
def _jax_scl(j, P, rule, pm_rule, llr_bytes, shape):
    llr = np.frombuffer(llr_bytes, np.float32).reshape(shape)
    return _np(JP.make_polar_scl_decoder(j, list_size=P, rule=rule,
                                         pm_rule=pm_rule, full=True)(
        jnp.asarray(llr)))


def _both_scl(p, P, rule, pm_rule, llr):
    kw = dict(list_size=P, rule=rule, pm_rule=pm_rule, full=True, device=CPU)
    return (_np(PP.make_polar_scl_decoder(p, **kw)(llr)),
            _np(PP.make_polar_scl_decoder_unrolled(p, **kw)(llr)))


@pytest.mark.parametrize("N,K,P", [(8, 4, 2), (32, 20, 4), (64, 32, 8),
                                   (128, 64, 4)])
def test_scl_golden_bit_for_bit(N, K, P):
    rng = np.random.default_rng(31 + N + P)
    _, p = _random_codes(rng, N, K)
    llr = (rng.normal(size=(4, N)) * 2.5).astype(np.float32)
    for payload, pms, u_all in _both_scl(p, P, "minsum", "approx", llr):
        for b in range(4):
            want_u, want_pms, want_all = polar_ref.scl_decode_np(
                llr[b], p.frozen_mask, P, rule="minsum", pm_rule="approx")
            active = want_pms < 1e20
            np.testing.assert_array_equal(u_all[b][active], want_all[active])
            np.testing.assert_array_equal(pms[b][active], want_pms[active])
            np.testing.assert_array_equal(payload[b],
                                          want_u[~p.frozen_mask][:K])


@pytest.mark.parametrize("N,K,crc,systematic,P,rule,pm_rule", [
    (64, 32, None, False, 8, "minsum", "approx"),
    (64, 28, "crc11", False, 4, "minsum", "approx"),
    (128, 80, None, True, 8, "minsum", "exact"),
    (128, 64, "crc11", True, 8, "exact", "approx"),
    (64, 64, None, False, 8, "minsum", "approx"),   # all-info
    (64, 1, None, False, 8, "minsum", "approx"),    # near-all-frozen
    (256, 100, "crc6", False, 8, "minsum", "approx")])
def test_scl_scan_and_unrolled_match_jax(N, K, crc, systematic, P, rule, pm_rule):
    j, p = _codes(N, K, crc=crc, systematic=systematic, design_snr_db=2.0)
    rng = np.random.default_rng(7 + N + K + P)
    llr = (rng.normal(size=(5, N)) * 2).astype(np.float32)
    want = _jax_scl(j, P, rule, pm_rule, llr.tobytes(), llr.shape)
    exact = rule == "exact" or pm_rule == "exact"
    for got in _both_scl(p, P, rule, pm_rule, llr):
        np.testing.assert_array_equal(got[0], want[0])  # payload
        np.testing.assert_array_equal(got[2], want[2])  # u_all
        if exact:
            np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("kind", ["zeros", "integers", "magnitudes"])
def test_scl_ties_bit_for_bit(kind):
    """Inputs whose candidates tie: all-zero LLRs (every metric equal),
    small integers and one magnitude with random signs (many equal sums);
    ties go to the lower candidate index in both packages."""
    j, p = _codes(64, 32, crc="crc11", design_snr_db=2.0)
    rng = np.random.default_rng(5)
    if kind == "zeros":
        llr = np.zeros((4, 64), np.float32)
    elif kind == "integers":
        llr = rng.integers(-2, 3, (4, 64)).astype(np.float32)
    else:
        llr = (rng.choice([-1.0, 1.0], (4, 64)) * 1.5).astype(np.float32)
    want = _jax_scl(j, 8, "minsum", "approx", llr.tobytes(), llr.shape)
    for got in _both_scl(p, 8, "minsum", "approx", llr):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    for b in range(4):
        _, want_pms, want_all = polar_ref.scl_decode_np(
            llr[b], p.frozen_mask, 8, rule="minsum", pm_rule="approx")
        active = want_pms < 1e20
        np.testing.assert_array_equal(want[2][b][active], want_all[active])


def test_scl_list1_equals_sc_and_route_by_device():
    rng = np.random.default_rng(41)
    _, p = _random_codes(rng, 128, 70)
    llr = (rng.normal(size=(5, 128)) * 2).astype(np.float32)
    sc = PP.polar_sc_decode(p, llr, device=CPU)
    scl = PP.polar_scl_decode(p, llr, list_size=1, device=CPU)
    np.testing.assert_array_equal(sc.numpy(), scl.numpy())
    un = PP.make_polar_scl_decoder_unrolled(p, list_size=1, device=CPU)(llr)
    np.testing.assert_array_equal(sc.numpy(), un.numpy())


def test_scl_crc_rescues_wrong_best_path():
    code = PP.polar_construct(128, 48, crc="crc11", design_snr_db=1.0)
    nocrc = PP.PolarCode(N=128, K=code.k_total, frozen=code.frozen)
    rng = np.random.default_rng(101)
    msg = rng.integers(0, 2, (400, code.K))
    x = PP.polar_encode(code, msg, device=CPU).numpy()
    sigma = 1.0 / np.sqrt(2.0 * 10 ** (-1.0 / 10.0))
    llr = ((2.0 / sigma**2) * ((1.0 - 2.0 * x) + sigma * rng.normal(
        size=x.shape))).astype(np.float32)
    with_crc = PP.polar_scl_decode(code, llr, list_size=8, device=CPU)
    plain = PP.polar_scl_decode(nocrc, llr, list_size=8, device=CPU)
    fer_crc = np.mean(np.any(with_crc.numpy() != msg, axis=1))
    fer_plain = np.mean(np.any(plain.numpy()[:, :code.K] != msg, axis=1))
    assert fer_plain > 0.01 and fer_crc < fer_plain


# --------------------------------------------------------------------- link

def _jax_transceive(j, P, decoder, bits, noise, ns):
    const = JM.psk_constellation(2).astype(np.complex64)
    x = JP.polar_rate_match(j, JP.polar_encode(j, bits))
    y = JM.modulate(x, const, 1) + jnp.asarray(noise) * (jnp.float32(ns)
                                                         * 0.5)
    llr = JP.polar_rate_recover(j, -JM.demodulate_soft(y, const, 1,
                                                       jnp.float32(ns)**2))
    if decoder == "sc":
        return np.asarray(JP.make_polar_sc_decoder(j)(llr))
    return np.asarray(JP.make_polar_scl_decoder(j, list_size=P)(llr))


@pytest.mark.parametrize("decoder,kw", [("sc", {}),
                                        ("scl", {"crc": "crc11"}),
                                        ("scl", {"crc": "crc11", "E": 200})])
def test_link_transceive_matches_jax_ops(decoder, kw):
    j, p = _codes(256, 100, design_snr_db=2.0, **kw)
    link = make_polar_awgn_link(code=p, decoder=decoder, list_size=4,
                                device=CPU)
    rng = np.random.RandomState(3)
    F = 16
    bits = rng.randint(0, 2, (F, p.K)).astype(np.int8)
    shape = (F,) + link.extras["noise_shape"]
    noise = (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)
    ns = float(link.noise_std_fn(1.0))
    got = link.transceive(bits, noise, ns).numpy()
    want = _jax_transceive(j, 4, decoder, bits, noise, ns)
    np.testing.assert_array_equal(got, want)
    assert 0 < (got != bits).sum()
    gen = torch.Generator().manual_seed(0)
    assert int(link.link_step(gen, 8, float(link.noise_std_fn(35.0)))) == 0


def test_link_ber_matches_jax_within_monte_carlo_error():
    """SCL-4 + CRC-11 at Eb/N0 1.5 dB, 512 frames of 64 bits each side:
    both counts are ~1e3, so a 3-sigma band of the pooled binomial count is
    ~10%; frames err in bursts, so the band is widened to 30%."""
    j, p = _codes(128, 64, crc="crc11", design_snr_db=2.0)
    link = make_polar_awgn_link(code=p, list_size=4, device=CPU)
    jlink = jax_polar_link(code=j, list_size=4)
    ns = float(link.noise_std_fn(1.5))
    assert ns == pytest.approx(float(jlink.noise_std_fn(1.5)), rel=1e-6)
    port = sum(int(link.link_step(torch.Generator().manual_seed(s), 128, ns))
               for s in range(4))
    keys = jax.random.split(jax.random.PRNGKey(1), 512)
    ref = int(jlink.link_step(keys, ns))
    assert ref > 300 and port > 300, (port, ref)
    assert abs(port - ref) <= 0.3 * ref, (port, ref)


def test_link_validation_and_entry_points_need_a_gpu():
    p = PP.polar_construct(64, 32)
    with pytest.raises(ValueError):
        make_polar_awgn_link(code=p, decoder="nope", device=CPU)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    msg = np.zeros((1, 32), np.int8)
    for call in (lambda: PP.polar_encode(p, msg),
                 lambda: PP.polar_sc_decode(p, np.zeros((1, 64))),
                 lambda: PP.polar_scl_decode(p, np.zeros((1, 64))),
                 lambda: PP.polar_rate_match(p, msg),
                 lambda: make_polar_awgn_link(code=p)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


# ------------------------------------------------------------------ convert

@pytest.mark.parametrize("kw", [{}, {"crc": "crc11", "E": 100},
                                {"crc": "crc16", "systematic": True},
                                {"crc": "crc24c"}])
def test_polar_code_from_fields_round_trips(kw):
    j = JP.polar_construct(128, 40, design_snr_db=2.0, **kw)
    p = convert.polar_code_from_fields(j)
    assert (p.N, p.K, p.frozen, p.rm, p.systematic) == \
        (j.N, j.K, j.frozen, j.rm, j.systematic)
    if j.crc is not None:
        # the JAX package's polynomial travels as an explicit CrcSpec; for
        # crc24c it is not the port's named crc24c
        assert p.crc.poly == j.crc.poly
        assert (kw["crc"] == "crc24c") == (
            p.crc != PP.CrcSpec.named(kw["crc"]))
    msg = np.random.default_rng(2).integers(0, 2, (4, 40))
    np.testing.assert_array_equal(PP.polar_encode(p, msg, device=CPU).numpy(),
                                  np.asarray(JP.polar_encode(j, msg)))
    bad = dict(N=j.N, K=j.K + 1, frozen=j.frozen, crc=None, rm=None,
               systematic=False)
    with pytest.raises(ValueError):
        convert.polar_code_from_fields(bad)
