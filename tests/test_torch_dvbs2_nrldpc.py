"""commpy_tpu_torch.ops.dvbs2 and .nrldpc against the JAX package.

Tables, params, encoders and rate matching/recovery must be identical.
At n = 16200 (B = 2, two layered iterations, MSA) the port's plain core
and its streamed kernel path (the plain version here) must decode like
the JAX package's XLA core, bit for bit.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.ops import dvbs2 as JD
from commpy_tpu.ops import nrldpc as JN
from commpy_tpu.ops import qcldpc as JQ
from commpy_tpu_torch.ops import dvbs2 as PD
from commpy_tpu_torch.ops import nrldpc as PN
from commpy_tpu_torch.ops import qcldpc as PQ

torch.set_num_threads(1)


def _same(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], dict):
            _same(a[key], b[key])
        elif a[key] is None:
            assert b[key] is None, key
        else:
            np.testing.assert_array_equal(np.asarray(a[key], dtype=object),
                                          np.asarray(b[key], dtype=object),
                                          err_msg=key)


@pytest.mark.parametrize("n,rate", [(16200, "1/2"), (16200, "3/4"),
                                    (64800, "2/3")])
def test_dvbs2_tables_and_params_identical(n, rate):
    assert PD.frame_params(n, rate) == JD.frame_params(n, rate)
    tab = PD.synthetic_address_table(n, rate, seed=1)
    assert tab == JD.synthetic_address_table(n, rate, seed=1)
    _same(JD.dvbs2_qc_params(tab, n, rate), PD.dvbs2_qc_params(tab, n, rate))
    assert PD.validate_address_table(tab, n, rate) == \
        JD.validate_address_table(tab, n, rate)
    text = "\n".join(", ".join(str(x) for x in row) for row in tab[:3])
    assert PD.parse_address_table(text + "\n# note") == \
        JD.parse_address_table(text)
    with pytest.raises(ValueError):
        PD.frame_params(n, "7/8")


@pytest.fixture(scope="module")
def dvbs2_16200():
    """The DVB-S2-class (16200, 7200) code in both packages and three
    codewords from the JAX encoder (its compile is the costly part)."""
    tab = PD.synthetic_address_table(16200, "1/2", seed=0)
    jp = JD.dvbs2_qc_params(tab, 16200, "1/2")
    pp = PD.dvbs2_qc_params(tab, 16200, "1/2")
    msg = np.random.RandomState(1).randint(0, 2, (3, 7200)).astype(np.int8)
    return jp, pp, msg, np.asarray(JD.dvbs2_encode_device(msg, jp))


def test_dvbs2_encode_and_h_identical(dvbs2_16200):
    jp, pp, msg, want = dvbs2_16200
    got = PD.dvbs2_encode_device(msg, pp, device="cpu")
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    H = PD.dvbs2_expand_h(pp)
    np.testing.assert_array_equal(H, JD.dvbs2_expand_h(jp))
    assert not (H.astype(np.int64) @ want.T.astype(np.int64) % 2).any()


def test_dvbs2_decode_matches_xla(dvbs2_16200):
    jp, pp, _, cw = dvbs2_16200
    assert PQ.select_backend(pp, "layered") == "streamed"
    rng = np.random.RandomState(2)
    cw = cw[:2]
    llr = (2.0 * ((1.0 - 2.0 * cw) + 0.8 * rng.randn(*cw.shape)) / 0.64
           ).astype(np.float32)
    llr[0, 7200:7210] = -0.0
    dj, oj = JD.dvbs2_decode_device(llr, jp, "MSA", 2, backend="xla")
    dj, oj = np.asarray(dj), np.asarray(oj)
    for backend in ("torch", "auto"):
        dp, op = PD.dvbs2_decode_device(llr, pp, "MSA", 2, backend=backend,
                                        device="cpu")
        np.testing.assert_array_equal(dp.numpy(), dj)
        np.testing.assert_array_equal(op.numpy(), oj)
    # noiseless input decodes to itself through the streamed path, in
    # float32 and in bfloat16 message stores
    for io in ("f32", "bf16"):
        d, _ = PD.dvbs2_decode_device((1.0 - 2.0 * cw) * 8.0, pp, "MSA", 2,
                                      msg_io=io, device="cpu")
        np.testing.assert_array_equal(d.numpy(), cw)


@pytest.mark.parametrize("bg,Z", [(1, 208), (2, 52), (1, 15)])
def test_nr_tables_params_encode_identical(bg, Z):
    assert PN.nr_lifting_sizes() == JN.nr_lifting_sizes()
    assert PN.nr_base_graph(bg, Z) == JN.nr_base_graph(bg, Z)
    jp, pp = JN.nr_code_params(bg, Z), PN.nr_code_params(bg, Z)
    _same(jp, pp)
    PN.validate_nr_base_graph(pp["base_matrix"], bg, Z)
    rng = np.random.RandomState(bg * 1000 + Z)
    msg = rng.randint(0, 2, (2, pp["k_bits"])).astype(np.int8)
    want = np.asarray(JN.nr_encode_device(msg, jp))
    np.testing.assert_array_equal(
        PN.nr_encode_device(msg, pp, device="cpu").numpy(), want)
    H = PQ.expand_base_matrix(pp["base_matrix"], Z).astype(np.int64)
    assert not (H @ want.T.astype(np.int64) % 2).any()
    assert PN.nr_select_bg(4000, 0.8) == JN.nr_select_bg(4000, 0.8)


def test_nr_rate_match_and_recover_identical():
    jp, pp = JN.nr_code_params(2, 52), PN.nr_code_params(2, 52)
    rng = np.random.RandomState(4)
    cw = rng.randint(0, 2, (3, pp["n_vnodes"])).astype(np.int8)
    L = pp["n_vnodes"] - 2 * 52
    for E in (L // 2, L, L + 777):  # punctured, full, repeated
        np.testing.assert_array_equal(
            PN.nr_rate_match(pp, cw, E, device="cpu").numpy(),
            np.asarray(JN.nr_rate_match(jp, cw, E)))
        llr_e = rng.randn(3, E).astype(np.float32)
        np.testing.assert_array_equal(
            PN.nr_rate_recover(pp, llr_e, E, device="cpu").numpy(),
            np.asarray(JN.nr_rate_recover(jp, llr_e, E)))
    with pytest.raises(ValueError):
        PN.nr_rate_recover(pp, np.zeros((1, 10), np.float32), 11,
                           device="cpu")
    text = "0 0 3\n1 2 5  # comment\n"
    np.testing.assert_array_equal(PN.parse_nr_base_graph(text),
                                  JN.parse_nr_base_graph(text))
    with pytest.raises(ValueError):
        PN.validate_nr_base_graph(np.zeros((3, 3), np.int32), 1, 208)


def test_nr_rate_matched_link_decodes_like_jax():
    # encode, rate-match, BPSK, recover (punctured bits get LLR 0), then
    # the layered decode: the port's plain core against the XLA core
    jp, pp = JN.nr_code_params(2, 52), PN.nr_code_params(2, 52)
    rng = np.random.RandomState(5)
    msg = rng.randint(0, 2, (2, pp["k_bits"])).astype(np.int8)
    cw = np.asarray(JN.nr_encode_device(msg, jp))
    E = pp["n_vnodes"] - 2 * 52 - 300
    tx = np.asarray(JN.nr_rate_match(jp, cw, E))
    y = (1.0 - 2.0 * tx) + 0.7 * rng.randn(*tx.shape)
    llr = np.asarray(JN.nr_rate_recover(jp, (2 * y / 0.49).astype(
        np.float32), E))
    dj, oj = JQ.qc_bp_decode_device(llr, jp, "MSA", 5, backend="xla",
                                    schedule="layered")
    dp, op = PQ.qc_bp_decode_device(llr, pp, "MSA", 5, backend="torch",
                                    schedule="layered", device="cpu")
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
