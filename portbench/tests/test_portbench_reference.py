"""The plain reference agrees with the port's plain CPU route, stage by
stage and end to end, on the same draws at a tiny size; in bfloat16 (the
control) it does not."""
import numpy as np
import pytest
import torch

from portbench import harness
from portbench.reference import bcc80211, draws, ldpc80211n, qam

CPU = torch.device("cpu")


def _cell_link_ref(name):
    cell = harness.load_cell(name)
    return (cell, harness.build_link(cell.config, CPU),
            harness.reference_chain(cell.config, CPU))


def test_qam_matches_the_port():
    from commpy_tpu_torch.ops import modem as M
    assert np.array_equal(qam.gray_qam(16), M.qam_constellation(16))
    q = qam.Qam(16, CPU)
    g = torch.Generator().manual_seed(3)
    coded = torch.randint(0, 2, (4, 400), generator=g, dtype=torch.int8)
    sym = q.modulate(coded)
    assert torch.equal(sym, M.modulate(coded, M.qam_constellation(16)
                                       .astype(np.complex64), 4, device=CPU))
    y = sym + torch.complex(torch.randn(4, 100, generator=g),
                            torch.randn(4, 100, generator=g)) * 0.6
    ns = np.float32(1.2)
    want = M.demodulate_soft(y, M.qam_constellation(16).astype(np.complex64),
                             4, ns * ns)
    assert torch.equal(q.llr(y.real, y.imag, float(ns)), want)


def test_bcc_encoder_and_scrambler_match_the_port():
    from commpy_tpu_torch.ops.convcode import encode_scan
    from commpy_tpu_torch.ops.scramble import scramble, wifi_scrambler_sequence
    _, link, ref = _cell_link_ref("mcs4-bcc.awgn5")
    assert np.array_equal(bcc80211.scrambler_sequence(93, 127),
                          wifi_scrambler_sequence(93, 127))
    g = torch.Generator().manual_seed(4)
    bits = torch.randint(0, 2, (3, ref.frame_bits), generator=g,
                         dtype=torch.int8)
    coded, _ = encode_scan(scramble(bits, 93, device=CPU),
                           link.extras["trellis"], device=CPU)
    assert torch.equal(ref.encode(bits), coded[:, ref.keep_idx])


def test_ldpc_encoder_satisfies_every_check():
    ref = ldpc80211n.chain(harness.load_cell("mcs4-ldpc.waterfall4").config,
                           CPU)
    g = torch.Generator().manual_seed(5)
    bits = torch.randint(0, 2, (5, ref.frame_bits), generator=g,
                         dtype=torch.int8)
    cw = ref.encode(bits)
    assert torch.equal(cw[:, :ref.frame_bits], bits)
    assert not ref.syndrome_bad(cw).any()


@pytest.mark.parametrize("name,frames,snr", [
    ("mcs4-bcc.awgn5", 2, 9.0),
    ("mcs4-ldpc.waterfall4", 24, 11.5),
    ("mcs4-ldpc.waterfall4", 24, 12.5),
])
def test_reference_equals_the_port_on_the_same_draws(name, frames, snr):
    cell, link, ref = _cell_link_ref(name)
    ns = float(np.float32(link.noise_std_fn(snr)))
    assert ref.noise_std(snr) == ns
    gen = draws.round_generator(2**31 + 7, 3, 1, CPU)
    bits, noise = link.draw(gen, frames)
    gen = draws.round_generator(2**31 + 7, 3, 1, CPU)
    rbits, rnoise = draws.draw(gen, frames, ref.frame_bits, ref.n_symbols, CPU)
    assert torch.equal(bits, rbits) and torch.equal(noise, rnoise)
    want = link.transceive(bits, noise, ns)
    got, extras = ref.transceive(bits, noise, ns)
    assert torch.equal(got, want)
    assert int((want ^ bits).sum()) > 0  # the point has errors to compare
    low, _ = ref.transceive(bits, noise, ns, torch.bfloat16)
    assert not torch.equal(low, want)
    if "sweeps" in extras:
        s = extras["sweeps"]
        assert int(s.min()) >= 0 and int(s.max()) <= ref.n_iterations
