"""The commpy_tpu_torch slice as a whole: 802.11 link and Monte-Carlo engine.

The same NumPy bits and complex noise go through the JAX package's stages
composed by hand (encode -> puncture -> modulate -> +noise ->
demodulate_soft -> depuncture -> Viterbi) and through the port's link;
the decoded bits must be identical.  Random link steps are held
statistically (BER against theory, high versus low SNR), and the port
must import neither jax nor commpy_tpu.
"""
import ast
import os
import pkgutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import erfc

import commpy_tpu_torch
from commpy_tpu.models import wifi80211_link as JW
from commpy_tpu.ops import convcode as JCC
from commpy_tpu.ops import modem as JM
from commpy_tpu.ops import scramble as JS
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu.ops.viterbi import viterbi_decode_device as jdecode
from commpy_tpu_torch.models import wifi80211_device_link
from commpy_tpu_torch.ops import modem as PM
from commpy_tpu_torch.ops import scramble as PS
from commpy_tpu_torch.ops.channel import snr_to_noise_std
from commpy_tpu_torch.ops.convcode import conv_encode, encode_scan
from commpy_tpu_torch.ops.trellis import Trellis
from commpy_tpu_torch.ops.viterbi import viterbi_decode_device
from commpy_tpu_torch.parallel import make_round_fn, montecarlo_ber

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K7 = (np.array([6]), np.array([[0o133, 0o171]]))
FRAME_BITS = 240


def _jax_link(mcs, bits, noise, noise_std, scramble_seed):
    """The JAX package's link stages composed by hand, as
    commpy_tpu/models/device_links.py:make_conv_awgn_link runs them."""
    m, use_psk, coding = JW.WIFI_MCS_TABLE[mcs]
    jt = JTrellis(*K7)
    const = (JM.psk_constellation(m) if use_psk
             else JM.qam_constellation(m)).astype(np.complex64)
    bps = int(np.log2(m))
    pv = JW._PUNCTURES[coding]
    keep = None if pv is None else JCC.puncture_mask(pv, 2 * FRAME_BITS)
    tx = bits if scramble_seed is None else JS.scramble(bits, scramble_seed)
    coded, _ = JCC.encode_scan(tx, jt)
    if keep is not None:
        coded = coded[:, np.where(keep)[0]]
    ns = jnp.float32(noise_std)
    y = JM.modulate(coded, const, bps) + jnp.asarray(noise) * (ns * 0.5)
    rx = JM.demodulate_soft(y, const, bps, ns ** 2)
    if keep is not None:
        rx = JCC.depuncture_device(rx, keep)
    dec = jdecode(rx, jt, 30, "soft", L=FRAME_BITS)
    if scramble_seed is not None:
        dec = JS.descramble(dec, scramble_seed)
    return np.asarray(rx), np.asarray(dec)


# (mcs, snr_db, scramble_seed): BPSK, scrambled QPSK, 16-QAM 3/4 (the
# main path's MCS) and separable 64-QAM 2/3, at SNRs with some errors
@pytest.mark.parametrize("mcs,snr_db,seed", [(0, 1.0, None), (1, 5.0, 0x5D),
                                             (4, 11.0, None),
                                             (5, 17.0, None)])
def test_link_matches_jax_stages(mcs, snr_db, seed):
    link = wifi80211_device_link(mcs, frame_bits=FRAME_BITS,
                                 scramble_seed=seed, device="cpu")
    rng = np.random.RandomState(mcs)
    F = 4
    bits = rng.randint(0, 2, (F, FRAME_BITS)).astype(np.int8)
    noise = (rng.randn(F, link.n_symbols)
             + 1j * rng.randn(F, link.n_symbols)).astype(np.complex64)
    ns = float(np.float32(link.noise_std_fn(snr_db)))
    rx, want = _jax_link(mcs, bits, noise, ns, seed)
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    errors = int((want != bits).sum())
    assert 0 < errors < bits.size // 4  # a decode with work to do
    # the port's decoder on JAX's LLRs: identical whatever the LLRs' ulps
    dec_rx = viterbi_decode_device(torch.as_tensor(rx.copy()),
                                   Trellis(*K7), 30, "soft", L=FRAME_BITS,
                                   device="cpu")
    if seed is not None:
        dec_rx = PS.descramble(dec_rx, seed, device="cpu")
    np.testing.assert_array_equal(dec_rx.numpy(), want)
    # the whole port link on the same draws
    np.testing.assert_array_equal(got.numpy(), want)


# the low SNR sits below each MCS's waterfall: BPSK rate 1/2 is
# error-free at 5 dB already
@pytest.mark.parametrize("mcs,low_snr_db", [(0, 1.0), (4, 5.0)])
def test_link_error_free_at_high_snr(mcs, low_snr_db):
    link = wifi80211_device_link(mcs, frame_bits=FRAME_BITS, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(mcs)
    e35 = int(link.link_step(gen, 16, float(link.noise_std_fn(35.0))))
    e_low = int(link.link_step(gen, 16, float(link.noise_std_fn(low_snr_db))))
    assert e35 == 0 < e_low


def test_link_rejects_a_frame_that_leaves_a_partial_symbol():
    # MCS 6, 64-QAM at rate 3/4: 1200 bits puncture to 1600 coded bits,
    # not a whole number of 6-bit symbols
    with pytest.raises(ValueError, match="whole symbols"):
        wifi80211_device_link(6, frame_bits=1200, device="cpu")


def _uncoded_qpsk_step():
    qpsk = PM.qam_constellation(4).astype(np.complex64)

    def step(gen, frames, noise_std):
        bits = torch.randint(0, 2, (frames, 1000), generator=gen,
                             dtype=torch.int8)
        z = torch.randn((2, frames, 500), generator=gen)
        y = PM.modulate(bits, qpsk, 2, device="cpu") + torch.complex(
            z[0], z[1]) * (noise_std * 0.5)
        return torch.sum(PM.demodulate_hard(y, qpsk, 2) ^ bits,
                         dtype=torch.int32)

    return step


def test_montecarlo_uncoded_qpsk_matches_theory():
    snrs = np.arange(0, 9, 2.0)
    res = montecarlo_ber(_uncoded_qpsk_step(), snrs,
                         lambda s: snr_to_noise_std(s, Es=2.0), 1000,
                         seed=0, frames_per_round=64, max_rounds=20,
                         err_min=400, device="cpu")
    np.testing.assert_allclose(res.bers,
                               erfc(np.sqrt(10 ** (snrs / 10) / 2)) / 2,
                               rtol=0.25)
    assert (res.bit_errors[:-1] >= 400).all()


def test_montecarlo_checkpoint_resume(tmp_path):
    kw = dict(snrs_db=[2.0, 6.0],
              noise_std_fn=lambda s: snr_to_noise_std(s, Es=2.0),
              frame_bits=1000, seed=11, frames_per_round=8,
              err_min=10 ** 9, device="cpu")
    step = _uncoded_qpsk_step()
    straight = montecarlo_ber(step, max_rounds=4, **kw)
    ckpt = str(tmp_path / "sweep.json")
    first = montecarlo_ber(step, max_rounds=2, checkpoint_path=ckpt, **kw)
    assert first.rounds == 2
    resumed = montecarlo_ber(step, max_rounds=4, checkpoint_path=ckpt, **kw)
    assert resumed.rounds == straight.rounds == 4
    np.testing.assert_array_equal(resumed.bit_errors, straight.bit_errors)
    np.testing.assert_array_equal(resumed.bits_sent, straight.bits_sent)


def test_montecarlo_early_stop_and_round_fn_checks():
    step = _uncoded_qpsk_step()
    nsf = lambda s: snr_to_noise_std(s, Es=2.0)  # noqa: E731
    res = montecarlo_ber(step, [0.0, 8.0], nsf, 1000, seed=1,
                         frames_per_round=16, max_rounds=50, err_min=300,
                         device="cpu")
    # the low-SNR point froze after its first round, the other ran on
    assert res.bits_sent[0] == 16_000 < res.bits_sent[1]
    rf = make_round_fn(step, [float(nsf(0.0))], 16, device="cpu")
    with pytest.raises(ValueError, match="frames_per_round"):
        montecarlo_ber(step, [0.0], nsf, 1000, frames_per_round=8,
                       round_fn=rf, device="cpu")
    with pytest.raises(ValueError, match="noise_stds"):
        montecarlo_ber(step, [3.0], nsf, 1000, frames_per_round=16,
                       round_fn=rf, device="cpu")


def _counting_step(calls):
    """A fake ``link_step``: its bit errors are about ten times the noise
    std plus a draw from the round's generator; each call's noise std is
    appended to ``calls``."""

    def step(gen, frames, noise_std):
        calls.append(float(noise_std))
        extra = torch.randint(0, 3, (), generator=gen, dtype=torch.int32)
        return extra + int(round(10 * noise_std))

    return step


# noise std = the "SNR": the points stop after 2, 3, 5 and 10 rounds
SWEEP = dict(snrs_db=[8.0, 4.0, 2.0, 1.0], noise_std_fn=float, frame_bits=10,
             seed=2**31 + 77, frames_per_round=4, err_min=100,
             device="cpu")


def _sweep_from_full_rounds(max_rounds, send_max=None):
    """The sweep recomputed from whole rounds called outside any sweep:
    (bit errors, bits sent, rounds, the points active in each round)."""
    stds = [float(s) for s in SWEEP["snrs_db"]]
    rf = make_round_fn(_counting_step([]), stds, SWEEP["frames_per_round"],
                       device="cpu")
    per_round = SWEEP["frames_per_round"] * SWEEP["frame_bits"]
    send_max = per_round * max_rounds if send_max is None else send_max
    errs = np.zeros(len(stds))
    sent = np.zeros(len(stds))
    ran = []
    for r in range(max_rounds):
        active = np.flatnonzero((errs < SWEEP["err_min"]) & (sent < send_max))
        if not len(active):
            break
        full = rf(SWEEP["seed"], r)
        assert (full > 0).all()
        errs[active] += full[active]
        sent[active] += per_round
        ran.append(active.tolist())
    return errs, sent, len(ran), ran


def _calls_of(ran):
    stds = [float(s) for s in SWEEP["snrs_db"]]
    return [stds[i] for active in ran for i in active]


def test_montecarlo_simulates_only_the_points_it_still_counts():
    errs, sent, rounds, ran = _sweep_from_full_rounds(12)
    # the points stop at different rounds, all before max_rounds
    assert [len([a for a in ran if i in a]) for i in range(4)] == \
        [2, 3, 5, 10] and rounds == 10
    calls = []
    res = montecarlo_ber(_counting_step(calls), max_rounds=12, **SWEEP)
    assert calls == _calls_of(ran)
    np.testing.assert_array_equal(res.bit_errors, errs)
    np.testing.assert_array_equal(res.bits_sent, sent)
    assert res.rounds == rounds
    # send_max stops the last point first at round 6
    errs6, sent6, rounds6, ran6 = _sweep_from_full_rounds(12, 240)
    calls.clear()
    res = montecarlo_ber(_counting_step(calls), max_rounds=12, send_max=240,
                         **SWEEP)
    assert calls == _calls_of(ran6) and res.rounds == rounds6 == 6
    np.testing.assert_array_equal(res.bit_errors, errs6)
    np.testing.assert_array_equal(res.bits_sent, sent6)


def test_montecarlo_skips_stopped_points_through_a_wrapper():
    errs, sent, rounds, ran = _sweep_from_full_rounds(12)
    calls = []
    stds = [float(s) for s in SWEEP["snrs_db"]]
    rf = make_round_fn(_counting_step(calls), stds,
                       SWEEP["frames_per_round"], device="cpu")
    seen = []

    def wrapper(s, r):
        seen.append(r)
        return rf(s, r)

    res = montecarlo_ber(_counting_step([]), max_rounds=12, round_fn=wrapper,
                         **SWEEP)
    assert seen == list(range(rounds)) and calls == _calls_of(ran)
    np.testing.assert_array_equal(res.bit_errors, errs)
    np.testing.assert_array_equal(res.bits_sent, sent)
    calls.clear()
    montecarlo_ber(_counting_step([]), max_rounds=12,
                   round_fn=lambda s, r: rf(s, r), **SWEEP)
    assert calls == _calls_of(ran)
    # outside a sweep the same round_fn simulates every point again
    calls.clear()
    full = rf(SWEEP["seed"], rounds - 1)
    assert calls == stds and (full > 0).all()


def test_montecarlo_round_fn_runs_every_point_after_a_failed_round():
    calls = []
    stds = [float(s) for s in SWEEP["snrs_db"]]
    rf = make_round_fn(_counting_step(calls), stds,
                       SWEEP["frames_per_round"], device="cpu")

    def failing(s, r):
        out = rf(s, r)
        if r == 3:
            raise RuntimeError("round 3 failed")
        return out

    with pytest.raises(RuntimeError, match="round 3 failed"):
        montecarlo_ber(_counting_step([]), max_rounds=12, round_fn=failing,
                       **SWEEP)
    # rounds 0-3 ran: 4 + 4 + 3 + 2 points
    assert len(calls) == 13
    calls.clear()
    rf(SWEEP["seed"], 3)
    assert calls == stds


def test_montecarlo_rejects_a_mask_of_another_length():
    rf3 = make_round_fn(_counting_step([]), [8.0, 4.0, 2.0], 4, device="cpu")
    with pytest.raises(ValueError, match="mask of active points"):
        montecarlo_ber(_counting_step([]), max_rounds=2,
                       round_fn=lambda s, r: rf3(s, r), **SWEEP)


def test_montecarlo_resume_after_a_point_stopped(tmp_path):
    errs, sent, rounds, ran = _sweep_from_full_rounds(12)
    ckpt = str(tmp_path / "sweep.json")
    calls = []
    first = montecarlo_ber(_counting_step(calls), max_rounds=4,
                           checkpoint_path=ckpt, **SWEEP)
    # the first point stopped after round 1, before the checkpoint
    assert first.rounds == 4 and first.bits_sent[0] < first.bits_sent[3]
    assert calls == _calls_of(ran[:4])
    calls.clear()
    resumed = montecarlo_ber(_counting_step(calls), max_rounds=12,
                             checkpoint_path=ckpt, **SWEEP)
    assert calls == _calls_of(ran[4:])
    straight = montecarlo_ber(_counting_step([]), max_rounds=12, **SWEEP)
    assert resumed.rounds == straight.rounds == rounds
    for res in (resumed, straight):
        np.testing.assert_array_equal(res.bit_errors, errs)
        np.testing.assert_array_equal(res.bits_sent, sent)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wifi80211_device_link(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        montecarlo_ber(_uncoded_qpsk_step(), [0.0], lambda s: 1.0, 1000,
                       frames_per_round=4)
    # arrays and CPU tensors are not decoded, encoded, mapped or scrambled
    # on the host unless the caller asks for it
    x = np.zeros((2, 40), np.float32)
    for call in (lambda: viterbi_decode_device(x, Trellis(*K7), 10, "soft"),
                 lambda: viterbi_decode_device(torch.as_tensor(x),
                                               Trellis(*K7), 10, "soft"),
                 lambda: encode_scan(np.zeros((2, 20), np.int8),
                                     Trellis(*K7)),
                 lambda: conv_encode(np.zeros(20, int), Trellis(*K7)),
                 lambda: PM.modulate(np.zeros((2, 4), np.int8),
                                     PM.qam_constellation(4), 2),
                 lambda: PS.scramble(np.zeros((2, 4), np.int8), 0x5D)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def _port_modules():
    return ["commpy_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages(commpy_tpu_torch.__path__,
                                              "commpy_tpu_torch.")]


def test_port_imports_neither_jax_nor_commpy_tpu():
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'commpy_tpu' or m.startswith('commpy_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
    # and no source file of the port, nor chip_smoke.py, names them
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "commpy_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "commpy_tpu"), (path, name)
