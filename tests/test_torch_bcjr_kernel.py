"""K3's plain version against the JAX package's Pallas BCJR kernel.

``bcjr_appdiff_plain`` (the plain version of the CUDA kernel in
``commpy_tpu_torch/kernels/csrc/bcjr.cu``) is held against
``commpy_tpu/kernels/bcjr.py:bcjr_appdiff_pallas`` in Pallas interpret mode
on the CPU, on the same NumPy inputs.  Max-log and linear-log-MAP are held
bit for bit; log-MAP to ``1e-4 (1 + |jax|)`` (the two frameworks' CPU
``exp``/``log1p`` differ in the last bit; the JAX package holds its own
two BCJR cores to rtol 2e-4, atol 2e-3).  The CUDA kernel is held against
this plain version, bit for bit, by ``chip_smoke.py`` on the card.
Interpret mode costs about a second a call, so the calls are few and
small (T <= 64, R <= 256).
"""
import copy

import numpy as np
import pytest
import torch

from commpy_tpu.kernels.bcjr import bcjr_appdiff_pallas
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu_torch.kernels import bcjr as BK
from commpy_tpu_torch.ops.trellis import Trellis

torch.set_num_threads(1)

RSC4 = (np.array([2]), np.array([[1, 7]]), 5, "rsc")
RSC8 = (np.array([3]), np.array([[1, 15]]), 13, "rsc")
NV = np.float32(0.5)


def _streams(T, R, seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(T, R).astype(np.float32) * 2 for _ in range(3))


def _both(code, syn, pan, li, **kw):
    """(JAX Pallas interpret, port plain) outputs as tuples of arrays."""
    def to_t(v):
        if isinstance(v, tuple):
            return tuple(torch.as_tensor(x) for x in v)
        return torch.as_tensor(v) if isinstance(v, np.ndarray) else v

    want = bcjr_appdiff_pallas(syn / NV, pan / NV, li, JTrellis(*code), **kw)
    got = BK.bcjr_appdiff_plain(torch.as_tensor(syn / NV),
                                torch.as_tensor(pan / NV),
                                torch.as_tensor(li), Trellis(*code),
                                **{k: to_t(v) for k, v in kw.items()})
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _check(want, got, exact):
    for w, g in zip(want, got):
        assert g.shape == w.shape and g.dtype == np.float32
        if exact:
            rel = np.abs(g - w) / (1 + np.abs(w))
            assert rel.max() <= 1e-4, rel.max()
            assert ((g > 0) == (w > 0)).mean() > 0.999
        else:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", ["maxlog", "linear", "exact"])
def test_plain_matches_pallas_odd_T_padded_lanes(mode):
    # odd T and R = 100 (the Pallas wrapper pads the lanes to 1024)
    syn, pan, li = _streams(33, 100, 3)
    kw = {"maxlog": {"max_log": True}, "linear": {"lse": "linear"},
          "exact": {}}[mode]
    want, got = _both(RSC4, syn, pan, li, **kw)
    _check(want, got, mode == "exact")


@pytest.mark.parametrize("max_log", [True, False], ids=["max-log", "log-MAP"])
def test_plain_masked_matches_pallas(max_log):
    syn, pan, li = _streams(40, 256, 4)
    valid = np.ones((40, 256), np.float32)
    valid[:4] = 0.0
    valid[-5:] = 0.0
    valid[10, :7] = 0.0
    first = np.zeros((256,), bool)
    first[:128] = True
    want, got = _both(RSC4, syn, pan, li, max_log=max_log, valid=valid,
                      first=first)
    _check(want, got, not max_log)


@pytest.mark.parametrize("max_log", [True, False], ids=["max-log", "log-MAP"])
def test_plain_boundary_carries_match_pallas(max_log):
    syn, pan, li = _streams(48, 128, 5)
    rng = np.random.RandomState(6)
    a0, bT = (rng.randn(4, 128).astype(np.float32) for _ in range(2))
    want, got = _both(RSC4, syn, pan, li, max_log=max_log, boundary=(a0, bT),
                      posterior=True)
    assert len(got) == 3 and got[1].shape == (4, 128)
    _check(want, got, not max_log)


def test_plain_bf16_io_combined_matches_pallas():
    syn, pan, li = _streams(40, 128, 7)
    want, got = _both(RSC4, syn, pan, li, max_log=True, io_dtype="bf16",
                      combined=True)
    _check(want, got, False)


def test_plain_s8_matches_pallas():
    syn, pan, li = _streams(64, 128, 8)
    want, got = _both(RSC8, syn, pan, li, max_log=True)
    _check(want, got, False)


def test_relabelled_states_change_no_max_log_value():
    # a bijective trellis that is not shift-structured: the 8-state code
    # with states 1-7 relabelled.  Max-log is exact whatever order the
    # states are reduced in, so e must not move by one bit.
    t = Trellis(*RSC8)
    r = copy.copy(t)
    perm = np.r_[0, 1 + np.random.RandomState(0).permutation(7)]
    r.next_state_table = np.empty_like(t.next_state_table)
    r.output_table = np.empty_like(t.output_table)
    r.next_state_table[perm] = perm[t.next_state_table]
    r.output_table[perm] = t.output_table
    r._build_inverse_tables()
    syn, pan, li = (torch.as_tensor(x) for x in _streams(30, 50, 9))
    a = BK.bcjr_appdiff_plain(syn, pan, li, t, max_log=True)
    b = BK.bcjr_appdiff_plain(syn, pan, li, r, max_log=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_wrapper_on_cpu_runs_the_plain_version():
    syn, pan, li = (torch.as_tensor(x) for x in _streams(17, 40, 10))
    valid = torch.rand(17, 40, generator=torch.Generator().manual_seed(0)) > 0.2
    BK.bcjr_appdiff.launches = 0
    for kw in ({}, {"valid": valid}, {"lse": "linear", "io_dtype": "bf16"}):
        a = BK.bcjr_appdiff(syn, pan, li, Trellis(*RSC4), **kw)
        b = BK.bcjr_appdiff_plain(syn, pan, li, Trellis(*RSC4), **kw)
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert BK.bcjr_appdiff.launches == 0


def test_plain_degenerate_shapes():
    tr = Trellis(*RSC4)
    a0 = torch.randn(4, 5)
    bT = torch.randn(4, 5)
    e, af, bf = BK.bcjr_appdiff_plain(*(torch.zeros(0, 5) for _ in range(3)),
                                      tr, boundary=(a0, bT))
    assert e.shape == (0, 5)
    np.testing.assert_array_equal(af.numpy(), a0.numpy())
    np.testing.assert_array_equal(bf.numpy(), bT.numpy())
    one = BK.bcjr_appdiff_plain(*(torch.ones(1, 3) for _ in range(3)), tr)
    assert one.shape == (1, 3) and torch.isfinite(one).all()


def test_wrapper_guards():
    x = torch.zeros(4, 8)
    with pytest.raises(NotImplementedError, match="binary-input"):
        BK.bcjr_appdiff(x, x, x, Trellis(np.array([1, 1]),
                                         np.array([[1, 2, 0], [0, 1, 3]])))
    cases = [
        (dict(valid=torch.ones(4, 8), boundary=(torch.zeros(4, 8),) * 2),
         "mutually exclusive"),
        (dict(io_dtype="f16"), "io_dtype"),
        (dict(lse="cubic"), "lse"),
        (dict(valid=torch.ones(3, 8)), r"valid must be \[4, 8\]"),
        (dict(boundary=(torch.zeros(2, 8),) * 2), r"a0 must be \[4, 8\]"),
    ]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            BK.bcjr_appdiff(x, x, x, Trellis(*RSC4), **kw)
    with pytest.raises(ValueError, match="share one"):
        BK.bcjr_appdiff(x, torch.zeros(4, 7), x, Trellis(*RSC4))
