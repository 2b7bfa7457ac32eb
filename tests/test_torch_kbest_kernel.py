"""K8, the K-best detector's kernel (``kernels/kbest.py``), and its route.

K8 runs only on the card: the tests marked ``card`` hold it to the plain
search (``ops/mimo.py:_kbest_plain``) there with ``torch.equal``, on LLRs
and on hard symbols (``python -m pytest tests/test_torch_kbest_kernel.py
--noconftest -m card``; this file imports no JAX), as ``chip_smoke.py``
Path N does on the benchmark's link.  Here its plan, its route and its
wrapper's checks are tested.
"""
import numpy as np
import pytest
import torch

from commpy_tpu_torch.kernels import kbest as K8
from commpy_tpu_torch.ops import mimo as PMI
from commpy_tpu_torch.ops import modem as M

torch.set_num_threads(1)
F32 = np.float32
QPSK = M.qam_constellation(4).astype(np.complex64)
QAM16 = M.qam_constellation(16).astype(np.complex64)
CONSTS = {"qpsk": QPSK, "16qam": QAM16}


def _crandn(rng, *shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
            ).astype(np.complex64)


def _draws(seed, B, nt, const, noise=0.3, case="noisy"):
    """h [B, nt, nt] CN(0, 1), y = h x + n (``case``: 'noisy'; 'noiseless'
    y = h x; 'y-zero', which ties every symbol with its negation)."""
    rng = np.random.default_rng(seed)
    x = const[rng.integers(0, len(const), (B, nt))]
    h = _crandn(rng, B, nt, nt) * F32(np.sqrt(0.5))
    y = np.einsum("brt,bt->br", h, x)
    if case == "noisy":
        y = y + _crandn(rng, B, nt) * F32(noise)
    elif case == "y-zero":
        y = np.zeros_like(y)
    return y.astype(np.complex64), h


def _priors(kind, seed, B, nb):
    if kind == "absent":
        return None
    if kind == "zero":
        return np.zeros((B, nb), F32)
    return (np.random.default_rng(seed).standard_normal((B, nb)) * 3
            ).astype(F32)


# ------------------------------------------------------------------ the plan

@pytest.mark.parametrize("nt, m, K, bps, lanes", [
    (4, 16, 16, 4, 16),  # the benchmark's cell, Paths D, E and N
    (2, 16, 8, 4, 8),  # Path F
    (4, 4, 8, 2, 8), (2, 4, 4, 2, 4), (4, 16, 1, 4, 1), (2, 16, 12, 4, 16),
    (4, 16, 32, 4, 32)])
def test_kbest_plan_takes_the_repos_shapes(nt, m, K, bps, lanes):
    for soft, nv in ((False, 0.0), (True, F32(0.3)), (True, 0.3)):
        plan = K8.kbest_plan(nt, m, K, bps, soft, nv)
        assert plan == {"reason": None, "lanes": lanes}


@pytest.mark.parametrize("nt, m, K, bps, why", [
    (3, 16, 16, 4, "nt"), (8, 16, 16, 4, "nt"), (4, 64, 16, 6, "points"),
    (4, 8, 8, 3, "points"), (4, 16, 16, 3, "bits"), (4, 16, 0, 4, "survivors"),
    (4, 16, 33, 4, "survivors")])
def test_kbest_plan_refuses_with_a_reason(nt, m, K, bps, why):
    plan = K8.kbest_plan(nt, m, K, bps)
    assert set(plan) == {"reason"} and why in plan["reason"]


@pytest.mark.parametrize("nv", [torch.tensor(0.3), np.full(1, 0.3, F32)],
                         ids=["tensor", "array"])
def test_kbest_plan_refuses_a_soft_noise_variance_off_the_host(nv):
    plan = K8.kbest_plan(4, 16, 16, 4, True, nv)
    assert set(plan) == {"reason"} and "host scalar" in plan["reason"]
    # hard output reads no noise variance
    assert K8.kbest_plan(4, 16, 16, 4, False, nv)["reason"] is None


# ----------------------------------------------------------------- the route

@pytest.mark.parametrize("kw", [
    {}, {"noise_var": F32(0.3), "output_type": "soft"},
    {"noise_var": 0.3, "output_type": "soft", "llr_clip": 50.0,
     "a_priori": np.ones((24, 16), F32)}],
    ids=["hard", "soft", "soft-priors-clip"])
def test_a_cpu_tensor_never_reaches_k8(kw, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("K8 was called on the CPU")

    y, h = _draws(1, 24, 4, QAM16)
    K8.kbest.launches = 0
    monkeypatch.setattr(K8, "kbest", refuse)
    got = PMI.kbest_device(y, h, QAM16, 16, device="cpu", **kw)
    args = {"noise_var": 0.0, "output_type": "hard", "a_priori": None,
            "llr_clip": None, **kw}
    la = args["a_priori"]
    want = PMI._kbest_plain(
        torch.as_tensor(y), torch.as_tensor(h), QAM16, 16, args["noise_var"],
        args["output_type"], 4,
        None if la is None else torch.as_tensor(la), args["llr_clip"])
    assert torch.equal(got, want)
    monkeypatch.undo()
    assert K8.kbest.launches == 0


def _valid(B=8, nt=4, m=16):
    r = torch.zeros((B, nt, nt), dtype=torch.complex64)
    yt = torch.zeros((B, nt), dtype=torch.complex64)
    la = torch.zeros((B, nt * (m.bit_length() - 1)), dtype=torch.float32)
    return r, yt, la


@pytest.mark.parametrize("case, match", [
    ("r-complex128", "complex64"), ("yt-float", "complex64"),
    ("r-not-square", r"r \[B, nt, nt\]"), ("yt-short", r"yt \[B, nt\]"),
    ("r-transposed", "contiguous"), ("priors-strided", "contiguous"),
    ("priors-float64", "float32 a_priori"), ("priors-shape", "float32 a_priori"),
    ("priors-hard", "soft output"), ("noise-tensor", "host scalar"),
    ("nt-3", "nt in"), ("on-cpu", "CUDA")])
def test_the_wrapper_raises_on_what_k8_does_not_take(case, match):
    r, yt, la = _valid()
    soft, nv = True, 0.3
    if case == "r-complex128":
        r = r.to(torch.complex128)
    elif case == "yt-float":
        yt = yt.real.contiguous()
    elif case == "r-not-square":
        r = r[:, :, :3].contiguous()
    elif case == "yt-short":
        yt = yt[:, :3].contiguous()
    elif case == "r-transposed":
        r = r.transpose(1, 2)
    elif case == "priors-strided":
        la = torch.zeros((8, 32))[:, ::2]
    elif case == "priors-float64":
        la = la.double()
    elif case == "priors-shape":
        la = la[:, :8].contiguous()
    elif case == "priors-hard":
        soft = False
    elif case == "noise-tensor":
        nv = torch.tensor(0.3)
    elif case == "nt-3":
        r, yt, la = _valid(nt=3)
    K8.kbest.launches = 0
    with pytest.raises(ValueError, match=match):
        K8.kbest(r, yt, QAM16, 16, soft, la, nv, 50.0)
    assert K8.kbest.launches == 0


# ------------------------------------------------------------ K8 on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _both(dev, y, h, pts, K, soft, la=None, nv=F32(0.3), clip=None):
    """K8 by ``kbest_device``'s route and the plain search, on the card."""
    bps = len(pts).bit_length() - 1
    yd, hd = torch.as_tensor(y, device=dev), torch.as_tensor(h, device=dev)
    lad = None if la is None else torch.as_tensor(la, device=dev)
    kind = "soft" if soft else "hard"
    before = K8.kbest.launches
    got = PMI.kbest_device(yd, hd, pts, K, nv, kind, bps, a_priori=lad,
                           llr_clip=clip, device=dev)
    assert K8.kbest.launches == before + 1
    want = PMI._kbest_plain(yd, hd, pts, K, nv, kind, bps, lad, clip)
    return got, want


@pytest.mark.card
@pytest.mark.parametrize("clip", [None, 50.0])
@pytest.mark.parametrize("prior", ["absent", "zero", "random"])
@pytest.mark.parametrize("K", [1, 4, 8, 12, 16, 32])
@pytest.mark.parametrize("const", ["qpsk", "16qam"])
@pytest.mark.parametrize("nt", [2, 4])
def test_k8_soft_equals_the_plain_search_on_the_card(nt, const, K, prior,
                                                     clip):
    """B = 4099 is no multiple of the 2 to 32 vectors a warp holds; K 1,
    12 and 32 run no shuffle rounds, keep fewer survivors than lanes at
    the last level, and fill a warp with one vector."""
    dev = _card()
    pts = CONSTS[const]
    B = 4099
    y, h = _draws(1000 * nt + K, B, nt, pts)
    la = _priors(prior, 11 * K + nt, B, nt * (len(pts).bit_length() - 1))
    got, want = _both(dev, y, h, pts, K, True, la, clip=clip)
    assert torch.equal(got, want)
    if clip is not None:
        assert bool(torch.isfinite(got).all())


@pytest.mark.card
@pytest.mark.parametrize("K", [1, 4, 8, 12, 16, 32])
@pytest.mark.parametrize("const", ["qpsk", "16qam"])
@pytest.mark.parametrize("nt", [2, 4])
def test_k8_hard_equals_the_plain_search_on_the_card(nt, const, K):
    dev = _card()
    pts = CONSTS[const]
    y, h = _draws(2000 * nt + K, 4099, nt, pts)
    got, want = _both(dev, y, h, pts, K, False)
    assert torch.equal(got, want)


@pytest.mark.card
@pytest.mark.parametrize("soft", [False, True])
@pytest.mark.parametrize("case", ["y-zero", "noiseless"])
def test_k8_breaks_ties_as_the_plain_search_on_the_card(case, soft):
    dev = _card()
    y, h = _draws(41, 48, 4, QAM16, case=case)
    got, want = _both(dev, y, h, QAM16, 16, soft, nv=0.1)
    assert torch.equal(got, want)


@pytest.mark.card
def test_a_noise_variance_tensor_on_the_card_takes_the_plain_search():
    dev = _card()
    y, h = _draws(43, 96, 4, QAM16)
    yd, hd = torch.as_tensor(y, device=dev), torch.as_tensor(h, device=dev)
    nv = torch.tensor(0.3, device=dev)
    K8.kbest.launches = 0
    got = PMI.kbest_device(yd, hd, QAM16, 16, nv, "soft", 4, device=dev)
    assert K8.kbest.launches == 0
    want = PMI._kbest_plain(yd, hd, QAM16, 16, nv, "soft", 4)
    assert torch.equal(got, want)
