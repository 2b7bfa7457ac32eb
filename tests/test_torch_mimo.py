"""The port's measures, channels and MIMO detectors against the JAX package.

The same NumPy inputs, made from a seed, go through both packages on the
CPU (the port with ``device="cpu"``).  Tolerances: ML symbols, K-best hard
symbols and survivor indices (random draws and exact ties), ``_leaf_bits``
and ``bec``/``bsc`` on the same uniform draws are identical; the Cholesky
triangularization's ``r`` and ``yt`` and the leaf metrics within rtol
1e-5 (atol 1e-5); K-best, best-first and ``max_log_approx_device`` LLRs
and the Kronecker channel products within rtol 1e-4, with the +-inf
positions equal; the host searches (``best_first_detector``,
``max_log_approx``, float64 on both sides) within 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from commpy_tpu.ops import channel as JC
from commpy_tpu.ops import mimo as JMI
from commpy_tpu.ops import modem as JM
from commpy_tpu.utils import measures as JU
from commpy_tpu_torch.ops import channel as PC
from commpy_tpu_torch.ops import mimo as PMI
from commpy_tpu_torch.utils import measures as PU
from commpy_tpu_torch.utils import small_matmul

torch.set_num_threads(1)

QPSK = JM.qam_constellation(4).astype(np.complex64)
QAM16 = JM.qam_constellation(16).astype(np.complex64)

# the JAX detectors under jit: one compile a shape instead of one a
# primitive, the same arithmetic
J_KBEST = jax.jit(JMI.kbest_device, static_argnums=(3, 5, 6),
                  static_argnames=("selection", "llr_clip"))
J_BEST_FIRST = jax.jit(JMI.best_first_device,
                       static_argnames=("beam", "bits_per_symbol"))
J_SEARCH = jax.jit(JMI._beam_search_batched, static_argnums=(3,))


def _crandn(rng, *shape):
    return (rng.randn(*shape) + 1j * rng.randn(*shape)).astype(np.complex64)


def _mimo_draws(seed, B, nr, nt, const, noise=0.3):
    """Symbols x [B, nt] with their indices, h [B, nr, nt], y = h x + n."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, len(const), (B, nt))
    x = const[idx]
    h = _crandn(rng, B, nr, nt) * np.float32(np.sqrt(0.5))
    y = (np.einsum("brt,bt->br", h, x) + _crandn(rng, B, nr) * noise).astype(
        np.complex64)
    return x, idx, h, y


def _close_with_infs(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(np.sign(got), np.sign(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=rtol)


# ------------------------------------------------------------------ measures

def test_measures_match_jax():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2, (3, 40))
    b = rng.randint(0, 2, (3, 40))
    for axis in (None, -1):
        np.testing.assert_array_equal(
            PU.hamming_dist(a, b, axis, device="cpu").numpy(),
            np.asarray(JU.hamming_dist(a, b, axis)))
    u = rng.randn(3, 17).astype(np.float32)
    v = rng.randn(3, 17).astype(np.float32)
    for axis in (None, 1):
        np.testing.assert_allclose(
            PU.euclid_dist(u, v, axis, device="cpu").numpy(),
            np.asarray(JU.euclid_dist(u, v, axis)), rtol=1e-6)
    c = _crandn(rng, 2, 9)
    for x in (u, c):
        np.testing.assert_array_equal(PU.upsample(x, 3, device="cpu").numpy(),
                                      np.asarray(JU.upsample(x, 3)))
        for axis in (None, -1):
            np.testing.assert_allclose(
                PU.signal_power(x, axis, device="cpu").numpy(),
                np.asarray(JU.signal_power(x, axis)), rtol=1e-6)


# ------------------------------------------------------------------ channels

@pytest.mark.parametrize("is_complex", [True, False])
def test_siso_apply_matches_jax_propagate(is_complex):
    key = jax.random.PRNGKey(3)
    rng = np.random.RandomState(1)
    msg = _crandn(rng, 4, 32)
    fading = (0.6, 0.64)
    want = JC.siso_propagate(key, msg, 0.4, fading, is_complex)
    # the JAX function's own draws, replayed into the port's arithmetic
    kg, kn = jax.random.split(key)
    if is_complex:
        g, n = JC._crandn(kg, msg.shape), JC._crandn(kn, msg.shape)
    else:
        g, n = (jax.random.normal(k, msg.shape) for k in (kg, kn))
    got = PC.siso_apply(msg, np.asarray(g), np.asarray(n), 0.4, fading,
                        is_complex, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def _exp_corr(n, rho):
    i = np.arange(n)
    return rho ** np.abs(i[:, None] - i[None, :])


@pytest.mark.parametrize("is_complex", [True, False])
def test_mimo_apply_matches_jax_propagate(is_complex):
    nr, nt = 3, 2
    mean = np.full((nr, nt), 0.3 + 0.1j)
    fp = (mean, _exp_corr(nt, 0.5), _exp_corr(nr, 0.7))
    jf = JC.kronecker_sqrt_factors(fp)
    pf = PC.kronecker_sqrt_factors(fp)
    for a, b in zip(pf, jf):
        np.testing.assert_array_equal(a, b)
    key = jax.random.PRNGKey(5)
    msg = _crandn(np.random.RandomState(2), 2, 6, nt)
    want = JC.mimo_propagate(key, msg, 0.2, *jf, is_complex=is_complex)
    kg, kn = jax.random.split(key)
    dims = msg.shape[:-1] + (nr, nt)
    if is_complex:
        h_iid = JC._crandn(kg, dims) * jnp.sqrt(0.5)
        noise = JC._crandn(kn, msg.shape[:-1] + (nr,)) * (0.2 * 0.5)
    else:
        h_iid = jax.random.normal(kg, dims)
        noise = jax.random.normal(kn, msg.shape[:-1] + (nr,)) * 0.2
    got = PC.mimo_apply(msg, np.asarray(h_iid), np.asarray(noise), *pf,
                        device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_propagate_draws_from_the_generator():
    gen = torch.Generator().manual_seed(7)
    msg = torch.ones(2000, dtype=torch.complex64)
    out, gains, noise = PC.siso_propagate(gen, msg, 2.0, (0.0, 1.0),
                                          device="cpu")
    assert out.shape == gains.shape == noise.shape == msg.shape
    # Rayleigh gains of unit power, complex noise of variance ns^2/2
    assert abs(float((gains.abs() ** 2).mean()) - 1.0) < 0.1
    assert abs(float((noise.abs() ** 2).mean()) - 2.0) < 0.2
    gen.manual_seed(7)
    again = PC.siso_propagate(gen, msg, 2.0, (0.0, 1.0), device="cpu")[0]
    np.testing.assert_array_equal(again.numpy(), out.numpy())
    f = PC.kronecker_sqrt_factors((np.zeros((2, 2)), np.eye(2), np.eye(2)))
    y, h, n = PC.mimo_propagate(gen, torch.ones(500, 2), 0.1, *f,
                                device="cpu")
    assert y.shape == (500, 2) and h.shape == (500, 2, 2)
    assert abs(float((h.abs() ** 2).mean()) - 1.0) < 0.1
    bits = torch.randint(0, 2, (4000,), generator=gen)
    erased = PC.bec(gen, bits, 0.25, device="cpu")
    assert abs(float((erased == -1).float().mean()) - 0.25) < 0.03
    flipped = PC.bsc(gen, bits, 0.1, device="cpu")
    assert abs(float((flipped != bits).float().mean()) - 0.1) < 0.02


def test_bec_bsc_match_jax_on_the_same_draws():
    key = jax.random.PRNGKey(9)
    bits = np.random.RandomState(3).randint(0, 2, (5, 64)).astype(np.int32)
    u = np.asarray(jax.random.uniform(key, bits.shape))
    np.testing.assert_array_equal(
        PC.bec_apply(bits, u, 0.3, device="cpu").numpy(),
        np.asarray(JC.bec(key, bits, 0.3)))
    np.testing.assert_array_equal(
        PC.bsc_apply(bits, u, 0.2, device="cpu").numpy(),
        np.asarray(JC.bsc(key, bits, 0.2)))


def test_small_matmul_matches_numpy():
    rng = np.random.RandomState(4)
    for k in (1, 3, 8, 9, 20):
        a = _crandn(rng, 5, 3, k)
        b = _crandn(rng, k, 6)
        np.testing.assert_allclose(
            small_matmul(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
            a @ b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="contraction"):
        small_matmul(torch.zeros(2, 3), torch.zeros(2, 3))


# --------------------------------------------------------------- ML and K-best

@pytest.mark.parametrize("nt,const", [(2, QAM16), (3, QPSK)],
                         ids=["2x2-16qam", "3x3-qpsk"])
def test_mimo_ml_matches_jax(nt, const):
    _, _, h, y = _mimo_draws(10 + nt, 64, nt, nt, const)
    want = np.asarray(JMI.mimo_ml_device(y, h, const))
    got = PMI.mimo_ml_device(y, h, const, device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        PMI.mimo_ml(y[0], h[0], const, device="cpu"),
        np.asarray(JMI.mimo_ml(y[0], h[0], const)))


def test_chol_qr_matches_jax():
    # The JAX package's CPU code contracts some of these complex
    # multiply-adds into fused multiply-adds (its H^H y and the Cholesky
    # updates) and the port does not, so the two differ by float32
    # rounding, which the triangularization amplifies by up to the
    # channel's condition number: rtol 1e-5, atol 1e-5 * cond(h).
    for nt in (2, 4):
        _, _, h, y = _mimo_draws(20 + nt, 64, nt, nt, QAM16)
        cond = np.linalg.cond(h)[:, None]
        rj, ytj = JMI._chol_qr_batched(jnp.asarray(h), jnp.asarray(y))
        rp, ytp = PMI._chol_qr_batched(torch.as_tensor(h), torch.as_tensor(y))
        for got, want in ((rp.numpy(), np.asarray(rj)),
                          (ytp.numpy(), np.asarray(ytj))):
            err = np.abs(got - want).reshape(len(h), -1)
            bound = 1e-5 * (cond + np.abs(want).reshape(len(h), -1))
            assert (err <= bound).all(), (err / bound).max()


def _search_both(y, h, const, widths, bias=None, eager=False):
    # under jit XLA fuses the search's multiply-adds across operations,
    # which breaks some exact ties of y = 0 by rounding: exact ties are
    # held against the JAX search as it runs op by op
    want = (JMI._beam_search_batched if eager else J_SEARCH)(
        jnp.asarray(y), jnp.asarray(h), jnp.asarray(const), widths,
        level_bias=None if bias is None else jnp.asarray(bias))
    got = PMI._beam_search_batched(
        torch.as_tensor(y), torch.as_tensor(h), const, widths,
        level_bias=None if bias is None else torch.as_tensor(bias))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("nt,const,K", [(2, QAM16, 8), (4, QPSK, 8),
                                        (4, QAM16, 16)],
                         ids=["2x2-16qam-k8", "4x4-qpsk-k8", "4x4-16qam-k16"])
def test_kbest_search_matches_jax(nt, const, K):
    _, _, h, y = _mimo_draws(30 + nt + K, 64, nt, nt, const)
    (Xj, dj, Ij), (Xp, dp, Ip) = _search_both(y, h, const, (K,) * nt)
    np.testing.assert_array_equal(Ip, Ij)  # every survivor, in order
    np.testing.assert_array_equal(Xp, Xj)
    np.testing.assert_allclose(dp, dj, rtol=1e-5, atol=1e-5)
    hard = PMI.kbest_device(y, h, const, K, device="cpu").numpy()
    np.testing.assert_array_equal(
        hard, np.asarray(J_KBEST(y, h, const, K)))
    # 'approx' is the exact selection off the TPU, in both packages
    np.testing.assert_array_equal(
        PMI.kbest_device(y, h, const, K, selection="approx",
                         device="cpu").numpy(), hard)


def _same_survivors(Ij, dj, Ip, dp, rtol=1e-5):
    """The rows whose searches kept the same set of leaves; their metrics
    must agree within ``rtol``.  (A near tie that straddles a level's cut
    makes the two searches keep different subtrees; within a row whose
    leaves agree, leaves whose metrics agree within rounding may swap
    places.)"""
    same = np.array([set(map(tuple, Ij[b].T)) == set(map(tuple, Ip[b].T))
                     for b in range(len(dj))])
    np.testing.assert_allclose(dp[same], dj[same], rtol=rtol, atol=rtol)
    return same


@pytest.mark.parametrize("case", ["y-zero", "noiseless"])
def test_kbest_exact_ties_match_jax(case):
    # y = 0 ties every symbol with its negation at each level, exactly:
    # the stable sort must keep the lower index first, as top_k does.
    # Noiseless y = h x (test_device_links.py::test_kbest_mimo_noiseless)
    # gives pairs of leaves whose metrics differ by float32 rounding only,
    # where the two packages' roundings differ (the JAX package's CPU code
    # fuses multiply-adds): the hard symbols must still be identical and
    # the survivors the same up to the order within such pairs.
    nt = 4
    x, idx, h, y = _mimo_draws(41, 48, nt, nt, QAM16, noise=0.0)
    if case == "y-zero":
        y = np.zeros_like(y)
    (Xj, dj, Ij), (Xp, dp, Ip) = _search_both(y, h, QAM16, (16,) * nt,
                                              eager=True)
    if case == "y-zero":
        assert (dp[:, :-1] == dp[:, 1:]).any()  # there are exact ties
        np.testing.assert_array_equal(Ip, Ij)
        np.testing.assert_allclose(dp, dj, rtol=1e-5, atol=1e-5)
    rows = _same_survivors(Ij, dj, Ip, dp)
    if case == "noiseless":
        # the best leaf is the transmitted vector
        np.testing.assert_array_equal(Ip[:, :, 0], idx)
    hard = PMI.kbest_device(y, h, QAM16, 16, device="cpu").numpy()
    np.testing.assert_array_equal(
        hard, np.asarray(JMI.kbest_device(y, h, QAM16, 16)))
    # LLRs where both searches kept the same leaves
    llr_p = PMI.kbest_device(y, h, QAM16, 16, 0.1, "soft", 4, device="cpu")
    llr_j = JMI.kbest_device(y, h, QAM16, 16, 0.1, "soft", 4)
    _close_with_infs(llr_p.numpy()[rows], np.asarray(llr_j)[rows], 1e-4)


def test_leaf_bits_and_max_log_llrs_match_jax():
    rng = np.random.RandomState(5)
    idx = rng.randint(0, 16, (6, 3, 10))
    np.testing.assert_array_equal(
        PMI._leaf_bits(torch.as_tensor(idx), 4).numpy(),
        np.asarray(JMI._leaf_bits(jnp.asarray(idx, jnp.int32), 4)))
    mets = rng.rand(6, 10).astype(np.float32)
    idx[0] = 5  # every leaf agrees: +-inf LLRs
    _close_with_infs(
        PMI._max_log_llrs_batched(torch.as_tensor(idx), torch.as_tensor(mets),
                                  4, 0.3).numpy(),
        JMI._max_log_llrs_batched(jnp.asarray(idx, jnp.int32),
                                  jnp.asarray(mets), 4, 0.3), 1e-5)


@pytest.mark.parametrize("extra", [{}, {"llr_clip": 50.0}, {"prior": True}],
                         ids=["plain", "clip", "a-priori"])
def test_kbest_soft_matches_jax(extra):
    nt = 4
    _, _, h, y = _mimo_draws(51, 64, nt, nt, QAM16, noise=0.4)
    kw = {k: v for k, v in extra.items() if k != "prior"}
    if extra.get("prior"):
        la = np.random.RandomState(52).randn(64, nt * 4).astype(np.float32)
        kw["a_priori"] = la * 3
    want = J_KBEST(y, h, QAM16, 16, 0.32, "soft", 4, **kw)
    got = PMI.kbest_device(y, h, QAM16, 16, 0.32, "soft", 4, device="cpu",
                           **kw)
    _close_with_infs(got.numpy(), want, 1e-4)
    if "llr_clip" in kw:
        assert np.isfinite(got.numpy()).all()
        assert np.abs(got.numpy()).max() == 50.0
    else:
        assert np.isinf(got.numpy()).any()


def test_kbest_reference_wrapper_and_errors():
    _, _, h, y = _mimo_draws(61, 1, 4, 4, QAM16)
    np.testing.assert_array_equal(
        PMI.kbest(y[0], h[0], QAM16, 16, device="cpu"),
        np.asarray(JMI.kbest(y[0], h[0], QAM16, 16)))
    _close_with_infs(PMI.kbest(y[0], h[0], QAM16, 16, 0.3, "soft",
                               device="cpu"),
                     JMI.kbest(y[0], h[0], QAM16, 16, 0.3, "soft"), 1e-4)
    with pytest.raises(ValueError, match="more columns"):
        PMI.kbest(np.zeros(2), np.zeros((2, 3)), np.array([1.0, -1.0]), 4,
                  device="cpu")
    with pytest.raises(ValueError, match="output_type"):
        PMI.kbest(np.zeros(3), np.eye(3), np.array([1.0, -1.0]), 4,
                  output_type="bad", device="cpu")
    with pytest.raises(ValueError, match="selection"):
        PMI.kbest_device(y, h, QAM16, 4, selection="fast", device="cpu")
    with pytest.raises(ValueError, match="a_priori"):
        PMI.kbest_device(y, h, QAM16, 4, a_priori=np.zeros((1, 16)),
                         device="cpu")


# ----------------------------------------------------------------- best-first

def test_best_first_device_matches_jax():
    nt = 4
    _, _, h, y = _mimo_draws(71, 64, nt, nt, QAM16, noise=0.4)
    for beam in (16, (4, 8, 16, 32)):
        want = J_BEST_FIRST(y, h, QAM16, beam=beam)
        got = PMI.best_first_device(y, h, QAM16, beam=beam, device="cpu")
        _close_with_infs(got.numpy(), want, 1e-4)
        # the counter clip at map_met + llr_max leaves every value finite
        assert np.isfinite(got.numpy()).all()


def _demode(const, bps):
    def demode(pts):
        d = np.abs(np.asarray(pts)[:, None] - const[None, :])
        idx = np.argmin(d, axis=-1)
        return ((idx[:, None] >> np.arange(bps - 1, -1, -1)) & 1).ravel()
    return demode


def test_host_searches_match_jax_in_float64():
    rng = np.random.RandomState(81)
    const = QAM16.astype(np.complex128)
    demode = _demode(const, 4)
    for _ in range(3):
        h = (rng.randn(4, 4) + 1j * rng.randn(4, 4)) * np.sqrt(0.5)
        y = h @ const[rng.randint(0, 16, 4)] + (
            rng.randn(4) + 1j * rng.randn(4)) * 0.3
        want = JMI.best_first_detector(y, h, const, (1, 3, 5), 0.3, demode,
                                       500)
        got = PMI.best_first_detector(y, h, const, (1, 3, 5), 0.3, demode,
                                      500)
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        pts = const[rng.randint(0, 16, (4, 12))]
        np.testing.assert_allclose(
            PMI.max_log_approx(y, h, 0.3, pts, demode),
            JMI.max_log_approx(y, h, 0.3, pts, demode), rtol=1e-12,
            atol=1e-12)


def test_max_log_approx_device_and_counter_llrs_match_jax():
    rng = np.random.RandomState(91)
    _, _, h, y = _mimo_draws(92, 1, 3, 3, QAM16)
    pts = QAM16[rng.randint(0, 16, (3, 12))]
    pts[:, 1] = pts[:, 0]
    _close_with_infs(
        PMI.max_log_approx_device(y[0], h[0], 0.3, pts, QAM16, 4,
                                  device="cpu").numpy(),
        JMI.max_log_approx_device(jnp.asarray(y[0]), jnp.asarray(h[0]), 0.3,
                                  pts, QAM16, 4), 1e-4)
    mets = rng.rand(12).astype(np.float32)
    _close_with_infs(
        PMI._counter_hyp_llrs(torch.as_tensor(pts), torch.as_tensor(mets),
                              QAM16, 4, 500.0).numpy(),
        JMI._counter_hyp_llrs(jnp.asarray(pts), jnp.asarray(mets),
                              jnp.asarray(QAM16), 4, 500.0), 1e-5)


def test_beam_search_single_matches_jax_and_batched():
    nt = 4
    _, _, h, y = _mimo_draws(93, 4, nt, nt, QAM16)
    r, yt = PMI._chol_qr_batched(torch.as_tensor(h), torch.as_tensor(y))
    Xb, db, _ = PMI._beam_search_batched(torch.as_tensor(y),
                                         torch.as_tensor(h), QAM16, (8,) * nt)
    for i in range(4):
        Xs, ds = PMI._beam_search_single(
            torch.as_tensor(y[i]), torch.as_tensor(h[i]), QAM16, (8,) * nt,
            qr=(r[i], yt[i]))
        Xj, dj = JMI._beam_search_single(
            jnp.asarray(y[i]), jnp.asarray(h[i]), jnp.asarray(QAM16),
            (8,) * nt, qr=(jnp.asarray(r[i].numpy()),
                           jnp.asarray(yt[i].numpy())))
        np.testing.assert_array_equal(Xs.numpy(), np.asarray(Xj))
        np.testing.assert_allclose(ds.numpy(), np.asarray(dj), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(Xs.numpy(), Xb[i].numpy())
        np.testing.assert_allclose(ds.numpy(), db[i].numpy(), rtol=2e-5,
                                   atol=2e-5)
    # without a given triangularization: torch.linalg.qr's, same leaves
    Xq, _ = PMI._beam_search_single(torch.as_tensor(y[0]),
                                    torch.as_tensor(h[0]), QAM16, (8,) * nt)
    np.testing.assert_array_equal(Xq.numpy()[:, 0], Xb[0].numpy()[:, 0])


def test_bit_lvl_repr_matches_jax():
    rng = np.random.RandomState(6)
    H = rng.randn(3, 2) + 1j * rng.randn(3, 2)
    w = np.array([2, 1, 2j, 1j])
    np.testing.assert_allclose(PMI.bit_lvl_repr(H, w),
                               JMI.bit_lvl_repr(H, w), rtol=1e-6)
    with pytest.raises(ValueError, match="even"):
        PMI.bit_lvl_repr(H, np.array([1, 2, 3]))


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    z = np.zeros((1, 2), np.complex64)
    hz = np.ones((1, 2, 2), np.complex64)
    calls = [lambda: PMI.kbest_device(z, hz, QPSK, 4),
             lambda: PMI.best_first_device(z, hz, QPSK),
             lambda: PMI.mimo_ml_device(z, hz, QPSK),
             lambda: PC.mimo_apply(z, hz, z, np.zeros((2, 2)), np.eye(2),
                                   np.eye(2)),
             lambda: PU.signal_power(z)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
