"""commpy_tpu_torch.ops.ldpc against commpy_tpu.ops.ldpc.

Design files, parity-check and generator matrices and encoders must be
identical.  The dense BP core sums a variable node's few messages
through ``torch.matmul`` where the JAX package uses XLA's dot, so its
posteriors may differ in the last bits: they must agree within 1e-3
(the JAX package's own tolerance between its dense and QC decoders),
and decisions may differ only where the posterior is within 1e-3 of
zero.
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from commpy_tpu.ops import ldpc as JL
from commpy_tpu.ops import qcldpc as JQ
from commpy_tpu_torch.ops import ldpc as PL
from commpy_tpu_torch.ops import qcldpc as PQ

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_DESIGNS = os.path.join(REPO, "commpy_tpu", "designs", "ldpc")
FILES = ["gallager/96.3.963.txt", "gallager/96.33.964.txt",
         "wimax/1440.720.txt", "wimax/960.720.a.txt"]


@pytest.mark.parametrize("name", FILES)
def test_design_files_copied_and_parsed_alike(name):
    assert filecmp.cmp(os.path.join(JAX_DESIGNS, name),
                       os.path.join(PL.DESIGNS, name), shallow=False)
    a = JL.get_ldpc_code_params(os.path.join(JAX_DESIGNS, name), True)
    b = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, name), True)
    assert sorted(a) == sorted(b)
    for key in a:
        if hasattr(a[key], "todense"):
            assert (a[key] != b[key]).nnz == 0, key
        else:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_writer_roundtrip(tmp_path):
    H = PQ.expand_base_matrix(PQ.ieee80211n_params(648, "1/2")
                              ["base_matrix"], 27)
    PL.write_ldpc_params(H, str(tmp_path / "ours.txt"))
    JL.write_ldpc_params(H, str(tmp_path / "theirs.txt"))
    assert filecmp.cmp(tmp_path / "ours.txt", tmp_path / "theirs.txt",
                       shallow=False)
    p = PL.get_ldpc_code_params(str(tmp_path / "ours.txt"), True)
    np.testing.assert_array_equal(p["parity_check_matrix"].todense(), H)


@pytest.mark.parametrize("name", ["wimax/1440.720.txt",
                                  "gallager/96.33.964.txt"])
def test_encoders_identical(name):
    a = JL.get_ldpc_code_params(os.path.join(JAX_DESIGNS, name), True)
    b = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, name), True)
    k = b["n_vnodes"] - b["n_cnodes"]
    rng = np.random.RandomState(1)
    msg = rng.randint(0, 2, (3, k)).astype(np.int8)
    G = np.asarray(b["generator_matrix"].todense()) % 2
    want = np.asarray(JL.ldpc_encode_device(msg, G))
    np.testing.assert_array_equal(
        PL.ldpc_encode_device(msg, G, device="cpu").numpy(), want)
    flat = rng.randint(0, 2, 2 * k + 5)
    np.testing.assert_array_equal(
        PL.triang_ldpc_systematic_encode(flat, b, device="cpu"),
        JL.triang_ldpc_systematic_encode(flat, a))


@pytest.mark.parametrize("name,alg", [("wimax/1440.720.txt", "MSA"),
                                      ("gallager/96.33.964.txt", "SPA")])
def test_dense_core_matches_jax_dense(name, alg):
    a = JL.get_ldpc_code_params(os.path.join(JAX_DESIGNS, name))
    b = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, name))
    rng = np.random.RandomState(2)
    llr = (rng.randn(4, b["n_vnodes"]) * 2 + 1.0).astype(np.float32)
    llr[0, :5] = -0.0
    dj, oj = JL.ldpc_bp_decode_device(llr, a, alg, 8, backend="dense")
    dp, op = PL.ldpc_bp_decode_device(llr, b, alg, 8, backend="dense",
                                      device="cpu")
    oj = np.asarray(oj)
    np.testing.assert_allclose(op.numpy(), oj, atol=1e-3, rtol=1e-4)
    disagree = dp.numpy() != np.asarray(dj)
    assert np.all(np.abs(oj[disagree]) < 1e-3)
    # the host API: one block per column
    d1, o1 = PL.ldpc_bp_decode(llr[1], b, alg, 8, device="cpu")
    assert d1.shape == (b["n_vnodes"],) and o1.dtype == float
    with pytest.raises(NameError):
        PL.ldpc_bp_decode_device(llr, b, "BAD", 8, device="cpu")


def test_wimax_qc_lift_decodes_like_jax():
    # the shipped WiMAX 1440.720 design is QC with Z=60: backend='auto'
    # lifts it onto the QC decoder in both packages, with the same base
    # matrix; the port's resident kernel path (its plain version here)
    # folds totals in the Pallas order, the JAX CPU path in the XLA
    # order, so on frames that converge (the zero codeword at Eb/N0
    # 2.5 dB) posteriors agree to 1e-4 and decisions match; in a frame
    # that never converges the last-bit difference can grow
    a = JL.get_ldpc_code_params(os.path.join(JAX_DESIGNS, FILES[2]))
    b = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, FILES[2]))
    qa, qb = JL._maybe_qc_params(a), PL._maybe_qc_params(b)
    assert qb["Z"] == 60
    for key in qa:
        np.testing.assert_array_equal(np.asarray(qa[key]),
                                      np.asarray(qb[key]), err_msg=key)
    assert PQ.select_backend(qb) == "resident"
    rng = np.random.RandomState(2)
    sigma = np.sqrt(1 / (2 * 0.5 * 10 ** 0.25))
    llr = (2 * (1 + sigma * rng.randn(6, 1440)) / sigma ** 2).astype(
        np.float32)
    dj, oj = JL.ldpc_bp_decode_device(llr, a, "MSA", 15)
    dp, op = PL.ldpc_bp_decode_device(llr, b, "MSA", 15, device="cpu")
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_allclose(op.numpy(), np.asarray(oj), rtol=1e-4,
                               atol=1e-4)
    assert not dp.numpy().any()
    # and the plain core on the lift is the XLA core's twin, bit for bit,
    # also on frames that do not converge
    llr = rng.randn(6, 1440).astype(np.float32) * 2
    dt, ot = PQ.qc_bp_decode_device(llr, qb, "MSA", 15, backend="torch",
                                    device="cpu")
    dx, ox = JQ.qc_bp_decode_device(llr, qa, "MSA", 15, backend="xla")
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dx))
    np.testing.assert_array_equal(ot.numpy(), np.asarray(ox))


def test_gallager_design_is_not_qc():
    b = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, FILES[1]))
    assert PQ.detect_qc_structure(b, 8) is None
    assert PL._maybe_qc_params(b) is None
