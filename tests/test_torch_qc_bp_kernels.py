"""The plain versions of the QC-LDPC kernels against the JAX package.

``qc_bp_resident_plain`` (K4's plain version) is held against
``commpy_tpu/kernels/qc_bp.py:qc_bp_pallas`` and ``qc_bp_streamed_plain``
(K5's) against ``qc_bp_pallas_streamed``, both in Pallas interpret mode
on the CPU, at n = 648, B = 4, 5 iterations, MSA: bit for bit in
decisions and posteriors.  The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py``.  Interpret mode costs several
seconds a call, so there are four such calls in all.
"""
import numpy as np
import pytest
import torch

from commpy_tpu.kernels import qc_bp as JK
from commpy_tpu.ops import qcldpc as JQ
from commpy_tpu_torch.kernels import qc_bp as K
from commpy_tpu_torch.ops import qcldpc as PQ

torch.set_num_threads(1)


def spa_llr(seed, B=4):
    """LLRs ``randn * 1.5 + 0.5`` for 3 SPA sweeps: posteriors stay under
    ~7, below tanh's float32 saturation in JAX (x ~ 8.0) and PyTorch
    (x ~ 9.0)."""
    rng = np.random.RandomState(seed)
    return (rng.randn(B, 648) * 1.5 + 0.5).astype(np.float32)


def _case(seed):
    """648-code LLRs: lane 0 clean, lane 1 noisy with seven -0.0 LLRs,
    lanes 2-3 noisy (they converge at different iterations)."""
    p = PQ.ieee80211n_params(648, "1/2")
    rng = np.random.RandomState(seed)
    msg = rng.randint(0, 2, (4, p["k_bits"])).astype(np.int8)
    cw = PQ.qc_encode_device(msg, p, device="cpu").numpy()
    llr = 2.0 * ((1.0 - 2.0 * cw) + 0.8 * rng.randn(4, 648)) / 0.64
    llr[0] = (1.0 - 2.0 * cw[0]) * 20
    llr[1, :7] = -0.0
    llr = np.clip(llr, -500, 500).astype(np.float32)
    return llr, cw, (p["Z"], p["Nb"], PQ.qc_rows(p))


@pytest.mark.parametrize("kernel,kw", [
    ("resident", dict(schedule="flooding")),
    ("resident", dict(schedule="layered", msa_scale=0.75)),
    ("streamed", dict(msg_io="f32")),
    ("streamed", dict(msg_io="bf16")),
], ids=["resident-flooding", "resident-layered-0.75", "streamed-f32",
        "streamed-bf16"])
def test_plain_matches_pallas_interpret(kernel, kw):
    llr, cw, meta = _case(5)
    if kernel == "resident":
        dj, oj = JK.qc_bp_pallas(llr, "MSA", 5, meta, **kw)
        dp, op = K.qc_bp_resident_plain(torch.as_tensor(llr), "MSA", 5, meta,
                                        **kw)
    else:
        dj, oj = JK.qc_bp_pallas_streamed(llr, "MSA", 5, meta, **kw)
        dp, op = K.qc_bp_streamed_plain(torch.as_tensor(llr), "MSA", 5, meta,
                                        **kw)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(np.signbit(op.numpy()),
                                  np.signbit(np.asarray(oj)))
    assert (dp.numpy()[0] == cw[0]).all()  # the clean lane
    # lanes with work to do: some converge, not all at once
    assert 0 < (dp.numpy() != cw).sum()


@pytest.mark.parametrize("alg", ["MSA", "SPA"])
def test_layered_plain_matches_xla_layered(alg):
    # the layered plain version follows the same float operations as the
    # XLA layered core: MSA bit for bit, SPA (log1p difference against
    # 2*atanh, framework tanh) to 1e-4 with identical decisions, on LLRs
    # that keep tanh below its float32 saturation (test_torch_qcldpc.py)
    llr, _, meta = _case(8)
    iters = 6
    if alg == "SPA":
        llr, iters = spa_llr(8), 3
    jp = JQ.ieee80211n_params(648, "1/2")
    dj, oj = JQ.qc_bp_decode_device(llr, jp, alg, iters, backend="xla",
                                    schedule="layered")
    for fn in (K.qc_bp_streamed_plain,
               lambda x, *a: K.qc_bp_resident_plain(x, *a, "layered")):
        dp, op = fn(torch.as_tensor(llr), alg, iters, meta)
        np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
        if alg == "MSA":
            np.testing.assert_array_equal(op.numpy(), np.asarray(oj))
        else:
            np.testing.assert_allclose(op.numpy(), np.asarray(oj),
                                       rtol=1e-4, atol=1e-4)


def test_streamed_negative_zero_is_per_frame():
    """The known divergence: a frame frozen while others still sweep.

    Lane 0 is a codeword written in LLRs of +-0.0, so its syndrome passes
    at init.  The XLA layered core (like the Pallas streamed kernel)
    keeps adding that lane's +0.0 deltas while lane 1 decodes, which
    turns its -0.0 totals into +0.0; its latched decisions stay the
    codeword.  The port never touches a converged frame: its posterior
    keeps the -0.0 and its decisions, signbit(posterior), are exactly the
    XLA core's latched ones."""
    llr, cw, meta = _case(9)
    llr[0] = np.where(cw[0] == 1, -0.0, 0.0)
    jp = JQ.ieee80211n_params(648, "1/2")
    dj, oj = JQ.qc_bp_decode_device(llr[:2], jp, "MSA", 4, backend="xla",
                                    schedule="layered")
    dj, oj = np.asarray(dj), np.asarray(oj)
    dp, op = K.qc_bp_streamed_plain(torch.as_tensor(llr[:2]), "MSA", 4, meta)
    np.testing.assert_array_equal(dp.numpy(), dj)
    np.testing.assert_array_equal(dp.numpy()[0], cw[0])
    np.testing.assert_array_equal(np.signbit(op.numpy()[0]), cw[0] == 1)
    # the XLA core's running totals lost the zeros' signs on that lane
    assert not np.signbit(oj[0]).any() and cw[0].any()
    np.testing.assert_array_equal(op.numpy(), oj)  # -0.0 == +0.0


def test_wrappers_run_plain_on_cpu_and_count_only_launches():
    llr, _, meta = _case(10)
    x = torch.as_tensor(llr)
    before = (K.qc_bp_resident.launches, K.qc_bp_streamed.launches)
    for wrapper, plain in ((K.qc_bp_resident, K.qc_bp_resident_plain),
                           (K.qc_bp_streamed, K.qc_bp_streamed_plain)):
        got, want = wrapper(x, "MSA", 3, meta), plain(x, "MSA", 3, meta)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert (K.qc_bp_resident.launches, K.qc_bp_streamed.launches) == before
    with pytest.raises(ValueError, match="float32"):
        K.qc_bp_resident(x.double(), "MSA", 3, meta)
    with pytest.raises(ValueError, match="SPA"):
        K.qc_bp_streamed(x, "BAD", 3, meta)
    with pytest.raises(ValueError, match="names no block"):
        K.qc_bp_streamed(x, "MSA", 3, meta, pos_masks=((0, 40, (1,)),))


def test_pos_masks_remove_edge_positions():
    # a masked position contributes no message and no syndrome term: with
    # every position of one block masked, the block is as if absent
    p = PQ.ieee80211n_params(648, "1/2")
    llr, _, meta = _case(11)
    rows = meta[2]
    masked = ((3, len(rows[3]) - 1, tuple(range(p["Z"]))),)
    cut = (meta[0], meta[1], tuple(r[:-1] if i == 3 else r
                                   for i, r in enumerate(rows)))
    x = torch.as_tensor(llr)
    dm, om = K.qc_bp_streamed_plain(x, "MSA", 4, meta, pos_masks=masked)
    dc, oc = K.qc_bp_streamed_plain(x, "MSA", 4, cut)
    assert torch.equal(dm, dc)
    assert torch.equal(om, oc)
