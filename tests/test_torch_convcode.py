"""commpy_tpu_torch encoder and puncturing, bit-identical to commpy_tpu."""
import numpy as np
import pytest
import torch

from commpy_tpu.ops import convcode as J
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu_torch.ops import convcode as P
from commpy_tpu_torch.ops.trellis import Trellis

torch.set_num_threads(1)

CODES = {
    "5_7": (np.array([2]), np.array([[5, 7]]), None, "default", "MSB"),
    "k7_133_171": (np.array([6]), np.array([[0o133, 0o171]]), None,
                   "default", "MSB"),
    "rsc_legacy_int": (np.array([2]), np.array([[1, 7]]), 5, "rsc", "MSB"),
    "k2_msb": (np.array([2, 1]), np.array([[5, 7, 0], [0, 2, 3]]), None,
               "default", "MSB"),
    "k2_rsc_matrix": (np.array([1, 1]), np.array([[1, 0, 0], [0, 1, 3]]),
                      np.array([[2, 2], [3, 1]]), "rsc", "MSB"),
}
PUNCTURES = ([1, 1, 1, 0], [1, 1, 1, 0, 0, 1], [1, 1, 1, 0, 0, 1, 1, 0, 0, 1])


@pytest.mark.parametrize("name", sorted(CODES))
def test_encode_scan_matches_jax(name):
    jt, pt = JTrellis(*CODES[name]), Trellis(*CODES[name])
    rng = np.random.RandomState(len(name))
    msgs = rng.randint(0, 2, (3, 24 * pt.k)).astype(np.int8)
    jc, js = J.encode_scan(msgs, jt)
    pc, ps = P.encode_scan(torch.as_tensor(msgs), pt, device="cpu")
    np.testing.assert_array_equal(np.asarray(jc), pc.numpy())
    np.testing.assert_array_equal(np.asarray(js), ps.numpy())
    assert pc.dtype == torch.int8
    # one unbatched message, and the FSM path from a nonzero start state
    np.testing.assert_array_equal(np.asarray(J.encode_scan(msgs[0], jt)[0]),
                                  P.encode_scan(msgs[0], pt,
                                                device="cpu")[0].numpy())
    jc1, js1 = J.encode_scan(msgs, jt, start_state=1)
    pc1, ps1 = P.encode_scan(torch.as_tensor(msgs), pt, start_state=1,
                               device="cpu")
    np.testing.assert_array_equal(np.asarray(jc1), pc1.numpy())
    np.testing.assert_array_equal(np.asarray(js1), ps1.numpy())


@pytest.mark.parametrize("name", sorted(CODES))
def test_conv_encode_matches_jax(name):
    jt, pt = JTrellis(*CODES[name]), Trellis(*CODES[name])
    rng = np.random.RandomState(7)
    msg = rng.randint(0, 2, 12 * pt.k)
    for term in ("term", "cont"):
        np.testing.assert_array_equal(J.conv_encode(msg, jt, term),
                                      P.conv_encode(msg, pt, term,
                                                    device="cpu"))
    pm = np.array([[1, 1, 0, 1, 1, 0]])
    np.testing.assert_array_equal(J.conv_encode(msg, jt, "term", pm),
                                  P.conv_encode(msg, pt, "term", pm,
                                                device="cpu"))


def test_conv_encode_cont_goldens():
    # tests/test_convcode.py:74-81, message [0, 0, 1, 0]
    mes = np.array([0, 0, 1, 0])
    gold = {"5_7": [0, 0, 0, 0, 1, 1, 0, 1],
            "rsc_legacy_int": [0, 0, 0, 0, 1, 1, 0, 1],
            "k2_msb": [0, 0, 0, 1, 1, 0],
            "k2_rsc_matrix": [0, 0, 0, 1, 0, 0]}
    for name, want in gold.items():
        np.testing.assert_array_equal(
            P.conv_encode(mes, Trellis(*CODES[name]), "cont",
                          device="cpu"), want)


@pytest.mark.parametrize("pv", PUNCTURES)
def test_puncturing_matches_jax(pv):
    rng = np.random.RandomState(len(pv))
    msg = rng.randint(0, 2, 90)
    pv = np.array(pv)
    np.testing.assert_array_equal(J.puncturing(msg, pv),
                                  P.puncturing(msg, pv))
    p = P.puncturing(msg, pv)
    np.testing.assert_array_equal(J.depuncturing(p, pv, 90),
                                  P.depuncturing(p, pv, 90))
    np.testing.assert_array_equal(J.puncture_mask(pv, 93),
                                  P.puncture_mask(pv, 93))


@pytest.mark.parametrize("pv", PUNCTURES)
@pytest.mark.parametrize("length", [60, 62])
def test_depuncture_device_matches_jax(pv, length):
    # length 62 ends on dropped slots: their source index runs past the
    # punctured word and must be masked, not read
    keep = P.puncture_mask(pv, length)
    rng = np.random.RandomState(length)
    llr = rng.randn(3, int(keep.sum())).astype(np.float32)
    want = np.asarray(J.depuncture_device(llr, keep))
    got = P.depuncture_device(torch.as_tensor(llr), keep).numpy()
    np.testing.assert_array_equal(want, got)
    assert got.dtype == np.float32
