"""commpy_tpu_torch.ops.qcldpc against commpy_tpu.ops.qcldpc.

The same NumPy inputs go through both packages.  Host tables, encoders
and MSA decoding must be bit-identical (the port's plain core against the
JAX package's XLA core: decisions and posteriors); SPA must give
identical decisions and posteriors within rtol = atol = 1e-4, the JAX
package's own tolerance, since tanh and atanh round differently in the
two frameworks.  The SPA inputs keep every message below tanh's float32
saturation: XLA's tanh reaches exactly 1.0 from x ~ 8.0 and PyTorch's
from x ~ 9.0, and between the two a leave-one-out message is ~17 in one
framework and the +-500 clip in the other.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.ops import dvbs2 as JD
from commpy_tpu.ops import ldpc as JL
from commpy_tpu.ops import nrldpc as JN
from commpy_tpu.ops import qcldpc as JQ
from commpy_tpu_torch.kernels import qc_bp as K
from commpy_tpu_torch.ops import dvbs2 as PD
from commpy_tpu_torch.ops import ldpc as PL
from commpy_tpu_torch.ops import nrldpc as PN
from commpy_tpu_torch.ops import qcldpc as PQ

torch.set_num_threads(1)


def _same_params(a, b):
    assert sorted(a) == sorted(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


@pytest.mark.parametrize("n,rate", sorted(JQ.IEEE80211N_BASE))
def test_80211n_params_identical(n, rate):
    _same_params(JQ.ieee80211n_params(n, rate), PQ.ieee80211n_params(n, rate))


@pytest.mark.parametrize("shape,kw", [((6, 12, 16), dict(seed=1)),
                                      ((8, 16, 32), dict(seed=5)),
                                      ((4, 8, 16), dict(seed=3,
                                                        target_girth=8))])
def test_random_qc_params_identical(shape, kw):
    _same_params(JQ.random_qc_params(*shape, **kw),
                 PQ.random_qc_params(*shape, **kw))


def test_qc_girth_and_design_roundtrip(tmp_path):
    Bm4 = np.array([[0, 1, 0, -1], [2, 3, 2, 0]], np.int32)
    p = PQ.ieee80211n_params(648, "1/2")
    for Bm, Z in ((Bm4, 8), (p["base_matrix"], p["Z"])):
        assert PQ.qc_girth(Bm, Z) == JQ.qc_girth(Bm, Z)
    assert PQ.qc_girth(Bm4, 8) == 4
    p8 = PQ.random_qc_params(4, 8, 16, seed=3)
    path = str(tmp_path / "qc_16.txt")
    PQ.qc_export_design(p8, path)
    # both packages parse the port's file alike and re-lift the code
    theirs = JL.get_ldpc_code_params(path)
    ours = PL.get_ldpc_code_params(path)
    for key in theirs:
        np.testing.assert_array_equal(theirs[key], ours[key], err_msg=key)
    qc = PQ.detect_qc_structure(ours, 16)
    np.testing.assert_array_equal(qc["base_matrix"], p8["base_matrix"])
    _same_params(qc, JQ.detect_qc_structure(theirs, 16))


@pytest.mark.parametrize("make", [
    lambda m: m.ieee80211n_params(648, "1/2"),
    lambda m: m.ieee80211n_params(1944, "5/6"),
    lambda m: m.random_qc_params(8, 16, 32, col_weight=3, seed=5),
], ids=["80211n-648", "80211n-1944-5/6", "dual-diagonal"])
def test_encoders_identical(make):
    jp, pp = make(JQ), make(PQ)
    rng = np.random.RandomState(4)
    msg = rng.randint(0, 2, (5, pp["k_bits"])).astype(np.int8)
    want = np.asarray(JQ.qc_encode_device(msg, jp))
    got = PQ.qc_encode_device(msg, pp, device="cpu")
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    H = PQ.expand_base_matrix(pp["base_matrix"], pp["Z"]).astype(np.int64)
    assert not (H @ want.T % 2).any()


def _llr(seed, B=4):
    """648-code LLRs: lane 0 clean, lane 1 a codeword in +-0.0, lane 2
    noisy with a few -0.0 entries, the rest noisy."""
    p = JQ.ieee80211n_params(648, "1/2")
    rng = np.random.RandomState(seed)
    msg = rng.randint(0, 2, (B, p["k_bits"])).astype(np.int8)
    cw = np.asarray(JQ.qc_encode_device(msg, p))
    llr = 2.0 * ((1.0 - 2.0 * cw) + 0.8 * rng.randn(B, 648)) / 0.64
    llr[0] = (1.0 - 2.0 * cw[0]) * 20
    llr[1] = np.where(cw[1] == 1, -0.0, 0.0)
    llr[2, :9] = -0.0
    return np.clip(llr, -500, 500).astype(np.float32), cw


def spa_llr(seed, B=4):
    """LLRs ``randn * 1.5 + 0.5`` for 3 SPA sweeps: posteriors stay under
    ~7, below tanh's saturation in either framework."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 648) * 1.5 + 0.5).astype(np.float32)


# MSA: bit-identical decisions and posteriors (flooding's totals fold in
# the XLA order in both); SPA: identical decisions, posteriors to 1e-4
@pytest.mark.parametrize("alg,schedule,scale,lead", [
    ("MSA", "flooding", 0.75, (2, 2)),
    ("MSA", "layered", 1.0, (4,)),
    ("SPA", "flooding", 1.0, (4,)),
    ("SPA", "layered", 1.0, (4,)),
    ("MSA", "flooding", 1.0, ()),
])
def test_torch_core_matches_xla(alg, schedule, scale, lead):
    llr, cw = _llr(21 + len(lead))
    iters = 6
    if alg == "SPA":
        llr, iters = spa_llr(21), 3
    llr = llr[:int(np.prod(lead))].reshape(lead + (648,)) if lead else llr[3]
    jp = JQ.ieee80211n_params(648, "1/2")
    pp = PQ.ieee80211n_params(648, "1/2")
    dj, oj = JQ.qc_bp_decode_device(llr, jp, alg, iters, backend="xla",
                                    schedule=schedule, msa_scale=scale)
    dp, op = PQ.qc_bp_decode_device(llr, pp, alg, iters, backend="torch",
                                    schedule=schedule, msa_scale=scale,
                                    device="cpu")
    assert dp.dtype == torch.int8 and tuple(dp.shape) == llr.shape
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    if alg == "MSA":
        np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(np.signbit(op.numpy()),
                                      np.signbit(np.asarray(oj)))
    else:
        np.testing.assert_allclose(op.numpy(), np.asarray(oj), rtol=1e-4,
                                   atol=1e-4)
    if lead == (4,) and alg == "MSA":  # the clean lane, the +-0.0 lane
        np.testing.assert_array_equal(dp.numpy()[:2], cw[:2])


def test_routing_table():
    """backend='auto' by the H100's shared memory: K4 where the frame's
    messages, LLRs and totals fit (227 KB), K5 for layered codes whose
    totals fit, the plain core otherwise (the JAX package's XLA core)."""
    rows = []
    for (n, rate) in sorted(PQ.IEEE80211N_BASE):
        rows.append((PQ.ieee80211n_params(n, rate), "resident", "resident"))
    wimax = PL.get_ldpc_code_params(f"{PL.DESIGNS}/wimax/1440.720.txt")
    rows.append((PL._maybe_qc_params(wimax), "resident", "resident"))
    for n in (16200, 64800):
        p = PD.dvbs2_qc_params(PD.synthetic_address_table(n, "1/2"), n, "1/2")
        want = "streamed" if n == 16200 else "torch"
        rows.append((p, "torch", want))
    rows.append((PN.nr_code_params(1, 208), "torch", "streamed"))
    for p, flooding, layered in rows:
        assert PQ.select_backend(p, "flooding") == flooding
        assert PQ.select_backend(p, "layered") == layered
    # the sizes of the table: 802.11n 1944 ~41-44 KB, WiMAX 30 KB,
    # DVB-S2-class 16200 totals 64.8 KB with a 20.2 KB message ring (rows
    # of 7 blocks, Z=360) and 0.7 KB of edges, DVB-S2 64800 totals 259 KB
    p = PQ.ieee80211n_params(1944, "1/2")
    nnz = int((p["block_j"] >= 0).sum())
    assert 41_000 <= K.resident_smem_bytes(1944, 81, nnz) <= 45_000
    assert K.streamed_smem_bytes(360, 45, 7, 175) == 64_800 + 20_160 + 700
    assert K.streamed_smem_bytes(360, 180, 7, 630) > K.SMEM_LIMIT


def test_resident_rejects_oversize_codes():
    # random_qc_params(12, 24, 144), the JAX package's "too large" code,
    # fits an H100 block; n = 16200 at Z = 360 does not
    small = PQ.random_qc_params(12, 24, 144, col_weight=3, seed=2)
    assert PQ.select_backend(small) == "resident"
    p = PQ.random_qc_params(25, 45, 360, col_weight=3, seed=0)
    assert PQ.select_backend(p, "flooding") == "torch"
    assert PQ.select_backend(p, "layered") == "streamed"
    llr = torch.zeros((1, p["n_vnodes"]))
    with pytest.raises(ValueError, match="too large"):
        K.qc_bp_resident(llr, "MSA", 2, (360, 45, PQ.qc_rows(p)))
    with pytest.raises(ValueError, match="too large"):
        PQ.qc_bp_decode_device(llr, p, "MSA", 2, backend="resident",
                               device="cpu")
    # the layered decode of it takes K5's path (its plain version here)
    rng = np.random.RandomState(9)
    msg = rng.randint(0, 2, (2, p["k_bits"])).astype(np.int8)
    cw = PQ.qc_encode_device(msg, p, device="cpu").numpy()
    dec, _ = PQ.qc_bp_decode_device((1.0 - 2.0 * cw) * 8.0, p, "MSA", 2,
                                    schedule="layered", device="cpu")
    np.testing.assert_array_equal(dec.numpy(), cw)


def test_decode_validation():
    p = PQ.ieee80211n_params(648, "1/2")
    llr = np.zeros((2, 648), np.float32)
    with pytest.raises(NameError):
        PQ.qc_bp_decode_device(llr, p, "BAD", 5, device="cpu")
    with pytest.raises(ValueError, match="MSA only"):
        PQ.qc_bp_decode_device(llr, p, "SPA", 5, msa_scale=0.75,
                               device="cpu")
    with pytest.raises(ValueError, match="streamed"):
        PQ.qc_bp_decode_device(llr, p, "MSA", 5, backend="resident",
                               msg_io="bf16", device="cpu")
    with pytest.raises(ValueError, match="resolved"):
        PQ.qc_bp_decode_device(llr, p, "MSA", 5, msg_io="bf16", device="cpu")
    with pytest.raises(ValueError, match="layered"):
        PQ.qc_bp_decode_device(llr, p, "MSA", 5, backend="streamed",
                               device="cpu")
    with pytest.raises(ValueError, match="backend"):
        PQ.qc_bp_decode_device(llr, p, "MSA", 5, backend="pallas",
                               device="cpu")
    pd = JD.dvbs2_qc_params(JD.synthetic_address_table(16200, "1/2"), 16200,
                            "1/2")
    with pytest.raises(NotImplementedError, match="masks"):
        PQ.qc_bp_decode_device(np.zeros(16200, np.float32), pd, "MSA", 1,
                               backend="resident", device="cpu")
    with pytest.raises(ValueError):
        PQ.ieee80211n_params(972, "1/2")


def test_nr_params_decode_like_jax():
    # an NR BG2 code (resident route) decoded by both packages' plain
    # cores, flooding: bit-identical (the layered NR decode is held in
    # test_torch_dvbs2_nrldpc.py; XLA compiles flooding ~3x faster)
    jp, pp = JN.nr_code_params(2, 16), PN.nr_code_params(2, 16)
    _same_params(jp, pp)
    rng = np.random.RandomState(31)
    msg = rng.randint(0, 2, (3, pp["k_bits"])).astype(np.int8)
    cw = np.asarray(JN.nr_encode_device(msg, jp))
    llr = (2.0 * ((1.0 - 2.0 * cw) + 0.7 * rng.randn(*cw.shape)) / 0.49
           ).astype(np.float32)
    dj, oj = JQ.qc_bp_decode_device(llr, jp, "MSA", 4, backend="xla")
    dp, op = PQ.qc_bp_decode_device(llr, pp, "MSA", 4, backend="torch",
                                    device="cpu")
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
