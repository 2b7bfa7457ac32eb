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
