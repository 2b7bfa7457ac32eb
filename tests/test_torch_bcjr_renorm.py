"""K3's renormalisation (``renorm_every``) on its plain version.

``renorm_every=0``, the default, is the Pallas kernel's arithmetic: its
max-log and linear outputs (whose float operations round alike on every
host) are held to digests of the outputs the plain version gave before
the flag existed.  With ``renorm_every`` N > 0 each recursion subtracts
each lane's state-metric maximum every N steps; at small T, where an
unrenormalised metric stays small, ``e`` and the carries (up to their
constant offset) equal the unrenormalised ones within ``1e-5 (1 + |x|)``.
The sequence-parallel stream's K3 route, which renormalises, is held to
the JAX package's ``_bcjr_masked`` (not the port's copy) within
``1e-5 (1 + |x|)`` at T = 1152.  The CUDA kernel is held to this plain
version, bit for bit at every N, by ``chip_smoke.py`` on the card.
"""
import hashlib

import numpy as np
import pytest
import torch

from commpy_tpu.ops import turbo as JT
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu_torch.kernels import bcjr as BK
from commpy_tpu_torch.ops import turbo as PT
from commpy_tpu_torch.ops.interleave import RandInterlv
from commpy_tpu_torch.ops.stream import STREAM_RENORM_EVERY, _map_pass
from commpy_tpu_torch.ops.trellis import Trellis

torch.set_num_threads(1)

CODES = {2: ([1], [[1, 3]], 3), 4: ([2], [[1, 7]], 5),
         8: ([3], [[1, 15]], 13), 16: ([4], [[1, 0o37]], 0o21)}
VARIANTS = ("plain", "masked", "boundary")
# sha256 (first 16 hex digits) of the plain version's outputs at T=37,
# R=5, as it computed them before renorm_every existed
BEFORE = {
    (2, "maxlog", "plain"): "3cfa4be248920c55",
    (2, "maxlog", "masked"): "6eb933dbe2eca8cc",
    (2, "maxlog", "boundary"): "3b72cee2bf0326f1",
    (2, "linear", "plain"): "d975a251773e4b9e",
    (2, "linear", "masked"): "8626ab0d83e867be",
    (2, "linear", "boundary"): "86f87c3bd5c4183d",
    (4, "maxlog", "plain"): "9b9d2ffc50e64bd9",
    (4, "maxlog", "masked"): "22dbd73444221e73",
    (4, "maxlog", "boundary"): "f7660279e8173fb9",
    (4, "linear", "plain"): "5d95463b621d8a4b",
    (4, "linear", "masked"): "540102aa40e3f3a5",
    (4, "linear", "boundary"): "46596e54e2fff174",
    (8, "maxlog", "plain"): "03855549ca3a9ab7",
    (8, "maxlog", "masked"): "548306ce124625cd",
    (8, "maxlog", "boundary"): "36909ffac0481827",
    (8, "linear", "plain"): "9727426891aebd3f",
    (8, "linear", "masked"): "dedc30b16f3589b1",
    (8, "linear", "boundary"): "7809745a17a829c0",
    (16, "maxlog", "plain"): "968aa6be65ffce8e",
    (16, "maxlog", "masked"): "039c0e7424d49e3e",
    (16, "maxlog", "boundary"): "34a3a44036757bfe",
    (16, "linear", "plain"): "00f06cae852f7479",
    (16, "linear", "masked"): "69dbfa546eaf3b84",
    (16, "linear", "boundary"): "ac8117a1a8326bdc",
}


def _trellis(S):
    g, c, fb = CODES[S]
    return Trellis(np.array(g), np.array(c), fb, "rsc")


def _inputs(S, T, R, variant, seed):
    """Streams of w-stream size (randn * 4) and priors (randn * 8); the
    masked variant a random fifth of its steps invalid and a random
    ``first``, the boundary variant random start metrics."""
    rng = np.random.RandomState(seed)
    syn, pan = (torch.as_tensor(rng.randn(T, R).astype(np.float32) * 4)
                for _ in range(2))
    li = torch.as_tensor(rng.randn(T, R).astype(np.float32) * 8)
    kw = {}
    if variant == "masked":
        kw = {"valid": torch.as_tensor(rng.rand(T, R) < 0.8),
              "first": torch.as_tensor(rng.rand(R) < 0.5)}
    elif variant == "boundary":
        kw = {"boundary": tuple(torch.as_tensor(
            rng.randn(S, R).astype(np.float32) * 3) for _ in range(2))}
    return syn, pan, li, kw


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _mode_kw(mode):
    return {"max_log": mode == "maxlog",
            "lse": "linear" if mode == "linear" else None}


@pytest.mark.parametrize("S", sorted(CODES))
@pytest.mark.parametrize("mode", ["maxlog", "linear"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_renorm_zero_is_the_output_before_the_flag(S, mode, variant):
    syn, pan, li, kw = _inputs(S, 37, 5, variant, 100 * S + 37)
    tr = _trellis(S)
    out = _tuple(BK.bcjr_appdiff_plain(syn, pan, li, tr, renorm_every=0,
                                       **kw, **_mode_kw(mode)))
    h = hashlib.sha256()
    for o in out:
        h.update(o.contiguous().numpy().tobytes())
    assert h.hexdigest()[:16] == BEFORE[(S, mode, variant)]
    # the default and the wrapper's CPU route are the same computation
    for other in (BK.bcjr_appdiff_plain(syn, pan, li, tr, **kw,
                                        **_mode_kw(mode)),
                  BK.bcjr_appdiff(syn, pan, li, tr, renorm_every=0, **kw,
                                  **_mode_kw(mode))):
        for a, b in zip(out, _tuple(other)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("S", sorted(CODES))
@pytest.mark.parametrize("N", [1, 4, 8])
def test_renorm_keeps_e_and_the_carries(S, N):
    """At T = 11 and 24 (odd, and below and above N) and every variant
    and lse mode, renormalising changes e, and the carries up to their
    offset, by no more than float32 rounds the unrenormalised metrics:
    1e-5 (1 + |x|) + 4 eps Gamma, Gamma a lane's sum of the branch
    magnitudes |w1| + |w2| + |li| and its start metrics' largest
    magnitudes (the law of ``tests/test_torch_stream.py``)."""
    tr = _trellis(S)
    eps = float(np.finfo(np.float32).eps)
    for T in (11, 24):
        for j, variant in enumerate(VARIANTS):
            for mode in ("exact", "maxlog", "linear"):
                syn, pan, li, kw = _inputs(S, T, 45, variant,
                                           1000 * S + 10 * T + j)
                gamma = (syn.abs() + pan.abs() + li.abs()).sum(0)
                if variant == "boundary":
                    gamma = gamma + sum(b.abs().amax(0)
                                        for b in kw["boundary"])
                ref = _tuple(BK.bcjr_appdiff_plain(syn, pan, li, tr, **kw,
                                                   **_mode_kw(mode)))
                got = _tuple(BK.bcjr_appdiff_plain(
                    syn, pan, li, tr, renorm_every=N, **kw,
                    **_mode_kw(mode)))
                for i, (g, w) in enumerate(zip(got, ref)):
                    if i:  # carries [S, R]: up to each lane's offset
                        g, w = g - g.amax(0), w - w.amax(0)
                    assert torch.isfinite(g).all()
                    over = (g - w).abs() - (1e-5 * (1 + w.abs())
                                            + 4 * eps * gamma)
                    assert float(over.max()) <= 0, (T, variant, mode, i)


def test_renorm_every_is_checked():
    syn, pan, li, _ = _inputs(4, 5, 3, "plain", 0)
    for bad in (-1, 1.5, True):
        with pytest.raises(ValueError, match="renorm_every"):
            BK.bcjr_appdiff_plain(syn, pan, li, _trellis(4),
                                  renorm_every=bad)


@pytest.mark.parametrize("mode", ["valid", "boundary"])
def test_stream_route_matches_jax_bcjr_masked(mode):
    """One MAP pass of T = 1152 through the stream's K3 route (its plain
    version, renormalising every STREAM_RENORM_EVERY steps) against the
    JAX package's ``_bcjr_masked`` on the same inputs: e within
    1e-5 (1 + |want|), no sign flip past that, and the carries (up to
    their constant offset) within the same."""
    T = 1152
    tr = _trellis(4)
    rng = np.random.RandomState(T + 7)
    p = RandInterlv(T, 0).p_array
    msg = torch.as_tensor(rng.randint(0, 2, (1, T)).astype(np.int8))
    x = 2.0 * torch.stack(PT.turbo_encode_device(msg, tr, tr, p,
                                                 device="cpu")
                          ).float()[:, 0] - 1
    nv = np.float32(0.5)
    inv = float(np.float32(1) / nv)
    y = (x + torch.as_tensor(rng.randn(3, T).astype(np.float32))
         * float(np.sqrt(nv)))
    li = torch.as_tensor(rng.randn(T).astype(np.float32) * 4)
    jkw = {}
    if mode == "valid":  # a middle shard: no exact start, dead halos
        valid = torch.ones(T, dtype=torch.bool)
        valid[:64] = valid[T - 64:] = False
        kw = {"valid": valid}
        first = torch.tensor([False])
    else:
        valid = torch.ones(T, dtype=torch.bool)
        a0, bT = (torch.as_tensor(rng.randn(4).astype(np.float32) * 2)
                  for _ in range(2))
        a0, bT = a0 - a0.max(), bT - bT.max()
        kw = {"boundary": (a0, bT)}
        first = torch.tensor([True])
        jkw = {"alpha_init": a0.numpy()[None], "beta_init": bT.numpy()[None],
               "return_carries": True}
    got = _tuple(_map_pass("kernel", y[0], y[1], li, nv, inv, tr, False,
                           first, **kw))
    out = JT._bcjr_masked(y[0].numpy()[None], y[1].numpy()[None],
                          li.numpy()[None], nv,
                          JTrellis(np.array([2]), np.array([[1, 7]]), 5,
                                   "rsc"),
                          valid.numpy()[None], first.numpy(), False, **jkw)
    apps = np.asarray(out[0] if jkw else out)[0]
    want = [apps[:, 1] - apps[:, 0]] + [np.asarray(c)[0] for c in
                                         (out[1:] if jkw else ())]
    e, w = got[0].numpy(), want[0]
    tol = 1e-5 * (1 + np.abs(w))
    assert (np.abs(e - w) <= tol).all(), float((np.abs(e - w) / tol).max())
    assert ((e > 0) != (w > 0))[np.abs(w) > tol].sum() == 0
    assert STREAM_RENORM_EVERY > 0
    for g, c in zip(got[1:], want[1:]):
        g, c = g.numpy() - g.numpy().max(), c - c.max()
        assert (np.abs(g - c) <= 1e-5 * (1 + np.abs(c))).all()
