"""The port's example scripts (``examples/torch/*.py``) at small sizes.

Each script is loaded by path and its ``main(device="cpu", ...)`` run at
a size that keeps this file within about a minute on one worker.

* Where a script's draws come from NumPy, its numbers are held to the
  JAX package's on the same draws: the test calls the JAX functions the
  JAX script calls, in its order (the JAX scripts themselves are not
  run): ``dvbt_outer_chain`` (the decode counts, exact),
  ``nr_ldpc_rate_matching`` (raw and decoded BER, exact),
  ``design_qc_ldpc`` (girth, design-file size, decoded BER, exact),
  ``receiver_frontend`` (each CFO estimate within 1e-4, the payload BER
  within 1e-3 and the CRC pass count within one frame of 16: the two
  frameworks' FFTs round apart) and ``sharded_decoding``'s edge-sharded
  LDPC decisions (equal), the last on D = 2 gloo rank processes.
* The Monte-Carlo scripts draw from torch generators, so they are held
  by physics: BER falls with SNR (the first point above the last), soft
  decoding no worse than hard at the top point, SCL-8 + CRC no worse than
  SC at the top SNR.
* Without a GPU, a script run with the default device raises.
"""
import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples", "torch")
SCRIPTS = ("conv_encode_decode", "design_qc_ldpc", "dvbt_outer_chain",
           "ldpc_turbo_links", "nr_ldpc_rate_matching",
           "plot_constellations", "polar_ber", "receiver_frontend",
           "sharded_decoding", "wifi80211_bers")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def _own_process_group():
    """The scripts' one-rank meshes start a gloo group in this process;
    drop it afterwards if this module started it."""
    import torch.distributed as dist

    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module", autouse=True)
def sharded_two_ranks():
    """``sharded_decoding`` on D = 2 gloo rank processes, started with
    the module so that they run while the other tests do."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_load("sharded_decoding").main, "cpu", ranks=2,
                          turbo_per_rank=256, n_iterations=3)


def _falls(bers):
    return bers[0] > bers[-1]


def test_every_jax_example_has_a_port():
    jax_scripts = {f[:-3] for f in os.listdir(os.path.dirname(EXAMPLES))
                   if f.endswith(".py") and not f.startswith("_")}
    assert jax_scripts == set(SCRIPTS)
    for name in SCRIPTS:
        assert os.path.exists(os.path.join(EXAMPLES, f"{name}.py"))


@pytest.mark.parametrize("name", SCRIPTS)
def test_default_device_raises_without_a_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load(name).main()


def test_conv_encode_decode():
    out = _load("conv_encode_decode").main(
        "cpu", snrs=np.array([0.0, 4.0]), frame_bits=200,
        frames_per_round=8, max_rounds=2, err_min=50)
    assert len(out["bers"]) == 6
    for name, bers in out["bers"].items():
        assert _falls(bers), name
    for code in ("K=3 (5,7)", "K=3 RSC", "K=7 (133,171)o"):
        assert out["bers"][f"{code} soft"][-1] <= \
            out["bers"][f"{code} hard"][-1]


def test_wifi80211_bers():
    out = _load("wifi80211_bers").main(
        "cpu", snrs=np.array([3.0, 12.0]), frames_per_round=4,
        max_rounds=1, err_min=10)
    for name, bers in out["bers"].items():
        assert _falls(bers), name


def test_polar_ber():
    out = _load("polar_ber").main("cpu", N=64, K=32,
                                  snrs=np.array([0.0, 4.0]),
                                  frames_per_device=16, max_rounds=2,
                                  err_min=10 ** 9)
    for name, bers in out["bers"].items():
        assert _falls(bers), name
    assert out["bers"]["SCL-8+CRC11"][-1] <= out["bers"]["SC"][-1]


def test_ldpc_turbo_links():
    out = _load("ldpc_turbo_links").main(
        "cpu", turbo_L=128, qc_shape=(5, 9, 24), sweeps={
            "turbo": ([-2.0, 3.0], 8, 1, 50),
            "wimax": ([6.0, 14.0], 2, 1, 50),
            "80211n_648": ([2.0, 6.0], 4, 1, 50),
            "dvbs2_16200": ([1.0, 6.0], 8, 1, 50)})
    assert set(out) == {"turbo", "wimax", "80211n_648", "dvbs2_16200"}
    for name, res in out.items():
        assert _falls(res["bers"]), name


def test_plot_constellations(tmp_path):
    out = _load("plot_constellations").main("cpu", out=str(tmp_path))
    assert out["path"] == str(tmp_path / "constellations.png")
    assert os.path.getsize(out["path"]) > 10000
    assert out["points"] == {"8-PSK": 8, "16-QAM": 16, "64-QAM": 64}


def test_dvbt_outer_chain_matches_jax():
    from commpy_tpu.ops.interleave import (conv_deinterleave,
                                           conv_interleave,
                                           conv_interleaver_delay)
    from commpy_tpu.ops.rs import rs_construct, rs_decode, rs_encode

    got = _load("dvbt_outer_chain").main("cpu")
    code = rs_construct(8, 8, shorten=51, fcr=0)
    I, M, F = 12, 17, 40
    D = conv_interleaver_delay(I, M)
    rng = np.random.default_rng(0)
    msg = rng.integers(0, 256, (F, code.k))
    stream = np.asarray(rs_encode(code, msg)).reshape(-1)
    rx = np.asarray(conv_interleave(stream, I, M)).copy()
    rx[8 * code.n:8 * code.n + 90] ^= rng.integers(1, 256, 90)
    de = np.asarray(conv_deinterleave(jnp.asarray(rx), I, M))
    corrected, nerr, ok = (np.asarray(a) for a in rs_decode(
        code, de.reshape(F, code.n)[D // code.n:]))
    rx2 = stream.copy()
    rx2[8 * code.n:8 * code.n + 90] ^= rng.integers(1, 256, 90)
    ok2 = np.asarray(rs_decode(code, rx2.reshape(F, code.n))[2])
    want = {"delay": D, "max_symbol_errors": int(nerr.max()),
            "total_symbol_errors": int(nerr.sum()),
            "all_decoded": bool(ok.all()),
            "payload_exact": bool(np.array_equal(
                corrected, np.asarray(rs_encode(code, msg))[:F - D // code.n])),
            "lost_without_interleaving": int((~ok2).sum())}
    assert got == want
    assert got["all_decoded"] and got["payload_exact"]
    assert got["lost_without_interleaving"] > 0


def test_nr_ldpc_rate_matching_matches_jax():
    from commpy_tpu.ops.nrldpc import (nr_code_params, nr_encode_device,
                                       nr_rate_match, nr_rate_recover)
    from commpy_tpu.ops.qcldpc import qc_bp_decode_device

    Z, frames, sigma, iters = 16, 4, 0.55, 10
    got = _load("nr_ldpc_rate_matching").main("cpu", Z=Z, frames=frames,
                                               sigma=sigma, n_iters=iters)
    params = nr_code_params(2, Z)
    n, k = params["n_vnodes"], params["k_bits"]
    rng = np.random.RandomState(0)
    msg = jnp.asarray(rng.randint(0, 2, (frames, k)), jnp.int8)
    cw = nr_encode_device(msg, params)
    for E in (2 * k, n - 2 * Z, n - 2 * Z + 4 * Z):
        tx = np.asarray(nr_rate_match(params, cw, E), np.float32)
        y = (1.0 - 2.0 * tx) + rng.randn(*tx.shape) * sigma
        llr = nr_rate_recover(params, jnp.asarray(2.0 * y / sigma ** 2), E)
        dec, _ = qc_bp_decode_device(llr, params, "MSA", iters,
                                     backend="xla")
        assert got["raw_ber"][E] == float(((y < 0) != tx).mean())
        assert got["info_ber"][E] == float(
            (np.asarray(dec)[:, :k] != np.asarray(msg)).mean())
    assert (got["n"], got["k"], got["bg"]) == (n, k, 2)


def test_design_qc_ldpc_matches_jax(tmp_path):
    from commpy_tpu.ops.ldpc import get_ldpc_code_params
    from commpy_tpu.ops.qcldpc import (detect_qc_structure,
                                       qc_bp_decode_device, qc_encode_device,
                                       qc_export_design, qc_girth,
                                       random_qc_params)

    kw = dict(Mb=6, Nb=12, Z=32, girth_tries=200, frames=8,
              ebn0s=(1.0, 3.0), n_iters=10)
    got = _load("design_qc_ldpc").main("cpu", **kw)
    params = random_qc_params(6, 12, 32, col_weight=3, seed=7,
                              target_girth=8, girth_tries=200)
    path = str(tmp_path / "qc.txt")
    qc_export_design(params, path)
    assert detect_qc_structure(get_ldpc_code_params(path, True), 32)
    assert got["girth"] == qc_girth(params["base_matrix"], 32) >= 8
    assert got["design_file_bytes"] == os.path.getsize(path)
    assert got["relifted"]
    rng = np.random.RandomState(0)
    rate = params["k_bits"] / params["n_vnodes"]
    for ebn0 in kw["ebn0s"]:
        sigma = 1.0 / np.sqrt(2 * rate * 10 ** (ebn0 / 10))
        msg = rng.randint(0, 2, (8, params["k_bits"])).astype(np.int8)
        cw = np.asarray(qc_encode_device(jnp.asarray(msg), params))
        x = 1.0 - 2.0 * cw
        llr = 2.0 * (x + rng.randn(*x.shape) * sigma) / sigma ** 2
        dec, _ = qc_bp_decode_device(jnp.asarray(llr.astype(np.float32)),
                                     params, "MSA", 10, schedule="layered")
        assert got["ber"][ebn0] == float((np.asarray(dec) != cw).mean())
    assert got["ber"][1.0] > got["ber"][3.0]


def _jax_receiver(frames):
    """The JAX script's transmit and receive chain on its draws."""
    from commpy_tpu.ops import modem as M
    from commpy_tpu.ops.crc import CrcSpec, make_crc_attach, make_crc_check
    from commpy_tpu.ops.impairments import add_frequency_offset
    from commpy_tpu.ops.ofdm import make_comb_estimator, ofdm_rx, ofdm_tx
    from commpy_tpu.ops.scramble import descramble, scramble
    from commpy_tpu.ops.sync import cfo_correct, cfo_estimate_cp

    NFFT, NSC, CP, N_TAPS, BPS, N_SYM, SEED = 64, 48, 16, 4, 2, 8, 0x5D
    PILOT = np.arange(0, NSC, 4)
    DATA = np.setdiff1d(np.arange(NSC), PILOT)
    crc = CrcSpec.named("crc16")
    K = len(DATA) * BPS * N_SYM - crc.length
    F = frames
    rng = np.random.RandomState(0)
    const = M.qam_constellation(4).astype(np.complex64)
    pv = (1.0 - 2.0 * (PILOT % 2)).astype(np.complex64)
    attach = make_crc_attach(crc, K)
    check = make_crc_check(crc, K + crc.length)
    estimate = make_comb_estimator(NFFT, NSC, PILOT, N_TAPS)
    bits = jnp.asarray(rng.randint(0, 2, (F, K)), jnp.int32)

    @jax.jit
    def transmit(bits, g_r, g_i, n_r, n_i):
        syms = M.modulate(scramble(attach(bits), seed=SEED), const, BPS)
        grid = jnp.zeros((F, NSC, N_SYM), jnp.complex64)
        grid = grid.at[:, DATA, :].set(
            syms.reshape(F, N_SYM, -1).transpose(0, 2, 1))
        grid = grid.at[:, PILOT, :].set(pv[None, :, None])
        wave = ofdm_tx(grid, NFFT, NSC, CP)
        g = g_r + 1j * g_i
        rx = jnp.zeros_like(wave)
        for tap in range(N_TAPS):
            sh = wave if tap == 0 else jnp.pad(
                wave, ((0, 0), (tap, 0)))[:, :wave.shape[1]]
            rx = rx + g[:, tap:tap + 1] * sh
        rx = add_frequency_offset(rx, Fs=NFFT, delta_f=0.23)
        return rx + 0.008 * (n_r + 1j * n_i)

    @jax.jit
    def receive(rx):
        eps = cfo_estimate_cp(rx, NFFT, CP, n_symbols=N_SYM)
        grid = ofdm_rx(cfo_correct(rx, eps, NFFT), NFFT, NSC, CP)
        h = estimate(grid[:, PILOT, 0] / pv)
        ref = h[:, PILOT, None] * pv[None, :, None]
        cpe = jnp.sum(grid[:, PILOT, :] * jnp.conj(ref), axis=1)
        rot = jnp.exp(1j * jnp.angle(cpe))
        z = grid[:, DATA, :] / h[:, DATA, None] / rot[:, None, :]
        rx_bits = M.demodulate_hard(z.transpose(0, 2, 1).reshape(F, -1),
                                    const, BPS)
        framed = descramble(rx_bits.astype(jnp.int32), seed=SEED)
        return eps, framed, check(framed)

    pdp = np.sqrt(np.array([0.85, 0.08, 0.05, 0.02]) / 2)
    g = ((rng.randn(F, N_TAPS) + 1j * rng.randn(F, N_TAPS))
         * pdp[None, :]).astype(np.complex64)
    n = (rng.randn(F, N_SYM * (NFFT + CP)), rng.randn(F, N_SYM * (NFFT + CP)))
    eps, framed, ok = receive(transmit(
        bits, g.real.copy(), g.imag.copy(), n[0].astype(np.float32),
        n[1].astype(np.float32)))
    return (np.asarray(eps),
            float(jnp.mean(jnp.not_equal(framed[:, :K], bits))),
            int(jnp.sum(ok)))


def test_receiver_frontend_matches_jax():
    got = _load("receiver_frontend").main("cpu", frames=16)
    eps, ber, crc_pass = _jax_receiver(16)
    np.testing.assert_allclose(got["cfo"], eps, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["cfo"], 0.23, rtol=0, atol=0.05)
    assert abs(got["ber"] - ber) <= 1e-3
    assert abs(got["crc_pass"] - crc_pass) <= 1
    assert got["frames"] == 16 and 0 < got["crc_pass"] <= 16


def test_sharded_decoding_on_two_ranks_matches_jax(sharded_two_ranks):
    """D = 2 gloo ranks; the edge-sharded decisions equal the JAX dense
    decoder's on the script's draws (RandomState(1): the turbo message
    and three noise rows of L = 2 * 256 values come first)."""
    from commpy_tpu.ops.ldpc import (get_ldpc_code_params,
                                     ldpc_bp_decode_device)

    got = sharded_two_ranks.result()
    assert got["ranks"] == 2 and got["turbo_L"] == 512
    rng = np.random.RandomState(1)
    rng.randint(0, 2, 512)
    for _ in range(3):
        rng.randn(512)
    llr = rng.randn(8, 1440).astype(np.float32) * 2 + 1.0
    params = get_ldpc_code_params(os.path.join(
        os.path.dirname(EXAMPLES), "..", "commpy_tpu", "designs", "ldpc",
        "wimax", "1440.720.txt"))
    dec, _ = ldpc_bp_decode_device(jnp.asarray(llr), params, "MSA", 10)
    np.testing.assert_array_equal(got["ldpc_decisions"], np.asarray(dec))
    assert got["ldpc_equal"]
    # sigma 0.9 on rate 1/3: each turbo decode is well under 1e-2
    assert max(got["turbo_ber"].values()) < 1e-2
    assert got["turbo_sharded_eq_serial"] > 0.99
    assert got["pipeline_eq_payload"] == 1.0
    assert got["viterbi_ber"] < 1e-2
    assert got["fir_max_err"] < 1e-4


def test_dvbs2_class_link_decodes_layered_on_the_streamed_route(monkeypatch):
    """``ldpc_turbo_links``'s 16200 code (Z=360): flooding is past the
    resident kernel's plan and 'auto' takes the plain core; the link's
    ``schedule='layered'`` routes it to the streamed kernel (its plain
    version on these CPU tensors), and decodes clean at 6 dB."""
    from commpy_tpu_torch.models import make_qcldpc_awgn_link
    from commpy_tpu_torch.ops import qcldpc as Q

    params = Q.random_qc_params(25, 45, 360)
    assert Q.select_backend(params) == "torch"
    assert Q.select_backend(params, "layered") == "streamed"
    calls = []
    real = Q.qc_bp_streamed
    monkeypatch.setattr(Q, "qc_bp_streamed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    link = make_qcldpc_awgn_link(qc_params=params, modulation_m=4,
                                 n_iterations=20, msa_scale=0.75,
                                 schedule="layered", device="cpu")
    gen = torch.Generator().manual_seed(0)
    errs = link.link_step(gen, 1, float(link.noise_std_fn(6.0)))
    assert int(errs) == 0 and calls == [1]
