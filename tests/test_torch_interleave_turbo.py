"""The port's interleavers, turbo encoders and turbo decoders against the
JAX package.

The same NumPy inputs, made from a seed, go through both packages on the
CPU.  Interleavers and encoders must be bit-identical.  The port's
XLA-order cores (``backend='torch'``) are held to the JAX package's
``backend='xla'``: LLRs within ``1e-4 (1 + |jax|)`` and equal decisions.
The port's K3 route (``backend='auto'``, on a CPU tensor the kernel's
plain version) is held to the JAX package's Pallas route in interpret
mode: equal decisions.  The turbo link's ``transceive`` on shared bits
and noise is held to the JAX stages composed by hand.
"""
import numpy as np
import pytest
import torch

from commpy_tpu import channelcoding as JCC
from commpy_tpu.ops import interleave as JI
from commpy_tpu.ops import turbo as JT
from commpy_tpu.ops.trellis import Trellis as JTrellis
from commpy_tpu_torch import convert
from commpy_tpu_torch.kernels import bcjr as BK
from commpy_tpu_torch.models import make_turbo_awgn_link
from commpy_tpu_torch.ops import interleave as PI
from commpy_tpu_torch.ops import turbo as PT
from commpy_tpu_torch.ops.trellis import Trellis
from commpy_tpu_torch.parallel import montecarlo_ber

torch.set_num_threads(1)

RSC4 = (np.array([2]), np.array([[1, 7]]), 5, "rsc")
RSC8 = (np.array([3]), np.array([[1, 15]]), 13, "rsc")
RSC32 = (np.array([5]), np.array([[1, 0o67]]), 0o45, "rsc")


def _rel_close(got, want, tol=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    rel = np.abs(got - want) / (1 + np.abs(want))
    assert rel.max() <= tol, rel.max()


def _frames(code, L, B, sigma2, seed, p_array=None):
    """Bits, and the noisy BPSK streams of their turbo codewords (float32
    NumPy, from the JAX encoder)."""
    rng = np.random.RandomState(seed)
    p = (np.asarray(p_array) if p_array is not None
         else JCC.RandInterlv(L, seed).p_array)
    msg = rng.randint(0, 2, (B, L))
    jt = JTrellis(*code)
    streams = JT.turbo_encode_device(msg, jt, jt, p)
    y = [(2.0 * np.asarray(x) - 1 + rng.randn(B, L) * np.sqrt(sigma2))
         .astype(np.float32) for x in streams]
    return msg, y, p


# ---------------------------------------------------------------- interleavers

@pytest.mark.parametrize("L,seed", [(96, 3), (6144, 0), (1000, 12345)])
def test_rand_interlv_is_mt19937_identical(L, seed):
    p_port = PI.RandInterlv(L, seed)
    p_jax = JI.RandInterlv(L, seed)
    np.testing.assert_array_equal(p_port.p_array, p_jax.p_array)
    x = np.random.RandomState(seed).randint(0, 9, L)
    np.testing.assert_array_equal(p_port.interlv(x), p_jax.interlv(x))
    np.testing.assert_array_equal(p_port.deinterlv(p_port.interlv(x)), x)
    np.testing.assert_array_equal(PI.inverse_permutation(p_port.p_array),
                                  JI.inverse_permutation(p_jax.p_array))


def test_block_interleaver_matches_jax():
    p = PI.block_interleaver(6, 5)
    np.testing.assert_array_equal(p, JI.block_interleaver(6, 5))
    x = np.random.RandomState(0).randn(3, 30).astype(np.float32)
    got = PI.interleave(x, p, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(JI.interleave(x, p)))
    back = PI.deinterleave(got, p, device="cpu")
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(JI.deinterleave(
                                      JI.interleave(x, p), p)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("I,M", [(12, 17), (3, 2), (1, 0)])
def test_forney_interleaver_matches_jax(I, M):
    x = np.random.RandomState(I).randint(1, 100, (2, 500)).astype(np.int32)
    got = PI.conv_interleave(x, I, M, device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JI.conv_interleave(x, I, M)))
    back = PI.conv_deinterleave(got, I, M, fill=-1, device="cpu")
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JI.conv_deinterleave(
            JI.conv_interleave(x, I, M), I, M, fill=-1)))
    d = PI.conv_interleaver_delay(I, M)
    assert d == JI.conv_interleaver_delay(I, M)
    np.testing.assert_array_equal(back.numpy()[:, d:], x[:, :500 - d])
    with pytest.raises(ValueError, match="branches"):
        PI.conv_interleave(x, 0, M, device="cpu")


# -------------------------------------------------------------------- encoders

@pytest.mark.parametrize("code", [RSC4, RSC8], ids=["S4", "S8"])
def test_turbo_encode_matches_jax_with_long_tail(code):
    L = 96
    msg = np.random.RandomState(5).randint(0, 2, L)
    il_p, il_j = PI.RandInterlv(L, 3), JI.RandInterlv(L, 3)
    got = PT.turbo_encode(msg, Trellis(*code), Trellis(*code), il_p,
                          device="cpu")
    want = JT.turbo_encode(msg, JTrellis(*code), JTrellis(*code), il_j)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    # the second parity stream keeps the reference's long tail
    assert len(got[2]) > len(got[1])


@pytest.mark.parametrize("code", [RSC4, RSC8], ids=["S4", "S8"])
def test_turbo_encode_device_matches_jax(code):
    L = 200
    p = JI.RandInterlv(L, 1).p_array
    msg = np.random.RandomState(6).randint(0, 2, (2, 3, L))
    got = PT.turbo_encode_device(msg, Trellis(*code), Trellis(*code), p,
                                 device="cpu")
    want = JT.turbo_encode_device(msg, JTrellis(*code), JTrellis(*code), p)
    for g, w in zip(got, want):
        assert g.dtype == torch.int8 and g.shape == (2, 3, L)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------- XLA-order BCJR cores

@pytest.mark.parametrize("max_log", [False, True], ids=["log-MAP", "max-log"])
def test_log_bcjr_matches_jax(max_log):
    msg, (sy, py, _), _ = _frames(RSC4, 64, 3, 0.6, 2)
    li = (np.random.RandomState(7).randn(3, 64) * 0.5).astype(np.float32)
    jl, jd = JT._log_bcjr(sy, py, li, np.float32(0.6), JTrellis(*RSC4),
                          max_log=max_log)
    pl_, pd = PT._log_bcjr(*(torch.as_tensor(x) for x in (sy, py, li)),
                           np.float32(0.6), Trellis(*RSC4), max_log=max_log)
    _rel_close(pl_.numpy(), jl)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def test_map_decode_device_and_squeeze_match_jax():
    msg, (sy, py, _), _ = _frames(RSC8, 48, 2, 0.5, 3)
    li = np.zeros_like(sy)
    jl, jd = JT.map_decode_device(sy, py, JTrellis(*RSC8), 0.5, li)
    pl_, pd = PT.map_decode_device(sy, py, Trellis(*RSC8), 0.5, li,
                                   device="cpu")
    _rel_close(pl_.numpy(), jl)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    one_l, one_d = PT.map_decode_device(sy[1], py[1], Trellis(*RSC8), 0.5,
                                        li[1], device="cpu")
    assert one_l.shape == (48,)
    np.testing.assert_array_equal(one_d.numpy(), pd.numpy()[1])
    ref_l, ref_d = PT.map_decode(sy[0], py[0], Trellis(*RSC8), 0.5, li[0],
                                 device="cpu")
    assert isinstance(ref_l, np.ndarray) and ref_d.dtype.kind == "i"
    np.testing.assert_array_equal(ref_d, pd.numpy()[0])


def test_log_bcjr_windowed_matches_jax():
    # L = 300 is not a multiple of the 128-symbol chunk
    msg, (sy, py, _), _ = _frames(RSC4, 300, 2, 0.5, 4)
    li = (np.random.RandomState(8).randn(2, 300) * 0.3).astype(np.float32)
    jl, jd = JT._log_bcjr_windowed(sy, py, li, np.float32(0.5),
                                   JTrellis(*RSC4), chunk=128, warmup=24)
    pl_, pd = PT._log_bcjr_windowed(*(torch.as_tensor(x)
                                      for x in (sy, py, li)),
                                    np.float32(0.5), Trellis(*RSC4),
                                    chunk=128, warmup=24)
    _rel_close(pl_.numpy(), jl)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


def test_bcjr_masked_with_carries_matches_jax():
    rng = np.random.RandomState(9)
    R, Wn, S = 6, 40, 4
    sy, pa, li = (rng.randn(R, Wn).astype(np.float32) for _ in range(3))
    valid = np.ones((R, Wn), bool)
    valid[:, :3] = False
    valid[2, -4:] = False
    first = np.array([True, False] * 3)
    a0 = rng.randn(R, S).astype(np.float32)
    bT = rng.randn(R, S).astype(np.float32)
    japps, jaf, jbf = JT._bcjr_masked(
        sy, pa, li, np.float32(0.5), JTrellis(*RSC4), valid, first, False,
        alpha_init=a0, beta_init=bT, return_carries=True)
    papps, paf, pbf = PT._bcjr_masked(
        *(torch.as_tensor(x) for x in (sy, pa, li)), np.float32(0.5),
        Trellis(*RSC4), torch.as_tensor(valid), torch.as_tensor(first), False,
        alpha_init=a0, beta_init=bT, return_carries=True)
    for got, want in ((papps, japps), (paf, jaf), (pbf, jbf)):
        _rel_close(got.numpy(), want)
    # the first-flag start, no carries
    japps = JT._bcjr_masked(sy, pa, li, np.float32(0.5), JTrellis(*RSC4),
                            valid, first, True)
    papps = PT._bcjr_masked(*(torch.as_tensor(x) for x in (sy, pa, li)),
                            np.float32(0.5), Trellis(*RSC4),
                            torch.as_tensor(valid), torch.as_tensor(first),
                            True)
    _rel_close(papps.numpy(), japps)


def test_parallel_bcjr_matches_jax():
    msg, (sy, py, _), _ = _frames(RSC4, 40, 2, 0.6, 10)
    li = (np.random.RandomState(11).randn(2, 40) * 0.5).astype(np.float32)
    jl, jd = JT._log_bcjr_parallel(sy, py, li, np.float32(0.6),
                                   JTrellis(*RSC4))
    pl_, pd = PT._log_bcjr_parallel(*(torch.as_tensor(x)
                                      for x in (sy, py, li)),
                                    np.float32(0.6), Trellis(*RSC4))
    _rel_close(pl_.numpy(), jl)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


# -------------------------------------------------------------- turbo decoding

_DECODES = {
    "whole-frame": {},
    "windowed": {"window": (32, 8)},
    "nii": {"window": (32, 0), "window_init": "nii"},
    "max-log": {"algorithm": "max-log"},
    "max-log-ext-0.7": {"algorithm": "max-log", "ext_scale": 0.7},
    "parallel": {"parallel": True},
}


@pytest.mark.parametrize("kw", list(_DECODES.values()), ids=list(_DECODES))
def test_turbo_decode_torch_matches_jax_xla(kw):
    msg, (sy, p1, p2), p = _frames(RSC4, 128, 3, 0.7, 12)
    args = (sy, p1, p2)
    want = np.asarray(JT.turbo_decode_device(
        *args, JTrellis(*RSC4), 0.7, 3, p, backend="xla", **kw))
    got = PT.turbo_decode_device(*args, Trellis(*RSC4), 0.7, 3, p,
                                 backend="torch", device="cpu", **kw)
    assert got.dtype == torch.int8 and got.shape == (3, 128)
    np.testing.assert_array_equal(got.numpy(), want)


def test_turbo_decode_batched_matches_single_and_squeezes():
    msg, (sy, p1, p2), p = _frames(RSC4, 64, 3, 0.5, 13)
    for backend in ("torch", "auto"):
        batch = PT.turbo_decode_device(sy, p1, p2, Trellis(*RSC4), 0.5, 4, p,
                                       backend=backend, device="cpu")
        for i in range(3):
            one = PT.turbo_decode_device(sy[i], p1[i], p2[i], Trellis(*RSC4),
                                         0.5, 4, p, backend=backend,
                                         device="cpu")
            assert one.shape == (64,)
            np.testing.assert_array_equal(one.numpy(), batch.numpy()[i])
        assert (batch.numpy() == msg).all()
    dec = PT.turbo_decode(sy[0], p1[0], p2[0], Trellis(*RSC4), 0.5, 4,
                          PI.RandInterlv(64, 13), device="cpu")
    assert isinstance(dec, np.ndarray) and dec.dtype.kind == "i"
    np.testing.assert_array_equal(dec, msg[0])


@pytest.mark.parametrize("kw", [{}, {"window": (16, 8)},
                                {"window": (16, 0), "window_init": "nii"}],
                         ids=["whole-frame", "warmup-window", "nii"])
def test_auto_on_cpu_matches_jax_pallas_interpret(kw):
    # the K3 route on a CPU tensor runs the kernel's plain version
    msg, (sy, p1, p2), p = _frames(RSC4, 64, 4, 0.6, 14)
    want = np.asarray(JT.turbo_decode_device(
        sy, p1, p2, JTrellis(*RSC4), 0.6, 2, p, backend="pallas", **kw))
    BK.bcjr_appdiff.launches = 0
    got = PT.turbo_decode_device(sy, p1, p2, Trellis(*RSC4), 0.6, 2, p,
                                 device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert BK.bcjr_appdiff.launches == 0  # no kernel on the CPU


def test_turbo_decode_validation_messages():
    msg, (sy, p1, p2), p = _frames(RSC4, 64, 1, 0.5, 15)
    args = (sy, p1, p2, Trellis(*RSC4), 0.5, 2, p)
    cases = [({"window": (16, 32)}, ValueError, "exceeds chunk"),
             ({"window_init": "bogus"}, ValueError, "window_init must be"),
             ({"window_init": "nii"}, ValueError, "requires window"),
             ({"window": (48, 0), "window_init": "nii"}, ValueError,
              "divide the frame"),
             ({"window": (48, 0), "window_init": "nii", "backend": "torch"},
              ValueError, "divide the frame"),
             ({"backend": "xla"}, ValueError, "backend must be"),
             ({"kernel_io": "f16"}, ValueError, "kernel_io"),
             ({"backend": "cuda"}, ValueError, "needs a CUDA tensor")]
    for kw, exc, match in cases:
        with pytest.raises(exc, match=match):
            PT.turbo_decode_device(*args, device="cpu", **kw)


def test_cuda_bcjr_fits_guards():
    assert PT._cuda_bcjr_fits(Trellis(*RSC4))
    assert PT._cuda_bcjr_fits(Trellis(*RSC8))
    # k = 2: four inputs, not the kernel's binary input
    assert not PT._cuda_bcjr_fits(Trellis(np.array([1, 1]),
                                          np.array([[1, 2, 0], [0, 1, 3]])))


@pytest.mark.parametrize("kw", [{}, {"window": (16, 8)}],
                         ids=["whole-frame", "warmup-window"])
def test_32_state_turbo_code_decodes_like_jax(kw):
    # 32 states is past K3's MAX_STATES: 'auto' takes the torch route on
    # either device, decodes to the JAX package's bits, and 'cuda' raises
    # with the limit
    pt = Trellis(*RSC32)
    assert pt.number_states == 32 and not PT._cuda_bcjr_fits(pt)
    for device_type in ("cpu", "cuda"):
        assert PT.turbo_route(pt, "auto", device_type) == "torch"
        assert PT.turbo_route(Trellis(*RSC4), "auto", device_type) == "kernel"
    with pytest.raises(NotImplementedError, match="at most 16"):
        PT.turbo_route(pt, "cuda", "cuda")
    with pytest.raises(ValueError, match="S <= 16"):
        BK.bcjr_plan(64, 32, 96)
    msg, (sy, p1, p2), p = _frames(RSC32, 64, 3, 0.6, 17)
    want = np.asarray(JT.turbo_decode_device(
        sy, p1, p2, JTrellis(*RSC32), 0.6, 3, p, **kw))
    BK.bcjr_appdiff.launches = 0
    got = PT.turbo_decode_device(sy, p1, p2, pt, 0.6, 3, p, device="cpu",
                                 **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != msg).mean() < 0.05
    assert BK.bcjr_appdiff.launches == 0


# ------------------------------------------------------------------- the link

def test_turbo_link_transceive_matches_jax_stages():
    L, F = 128, 4
    p = JCC.RandInterlv(L, 0).p_array
    link = make_turbo_awgn_link(trellis=Trellis(*RSC4), frame_bits=L,
                                p_array=p, n_iterations=4, device="cpu")
    rng = np.random.RandomState(16)
    bits = rng.randint(0, 2, (F, L)).astype(np.int8)
    noise = rng.randn(F, L, 3).astype(np.float32)
    ns = float(link.noise_std_fn(8.0))
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns)
    # the JAX link's stages (models/device_links.py:make_turbo_awgn_link)
    jt = JTrellis(*RSC4)
    s, q1, q2 = JT.turbo_encode_device(bits, jt, jt, p)
    tx = 2.0 * np.stack([s, q1, q2], -1).astype(np.float32) - 1.0
    y = tx + noise * np.float32(ns)
    want = np.asarray(JT.turbo_decode_device(
        y[..., 0], y[..., 1], y[..., 2], jt, np.float32(ns) ** 2, 4, p))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() == bits).all()
    assert link.n_symbols == 3 * L and link.extras["rate"] == 1 / 3


def test_turbo_link_high_vs_low_snr_through_montecarlo():
    L = 256
    link = make_turbo_awgn_link(trellis=Trellis(*RSC4), frame_bits=L,
                                p_array=PI.RandInterlv(L, 0).p_array,
                                window=(64, 0), window_init="nii",
                                device="cpu")
    res = montecarlo_ber(link.link_step, [35.0, -5.0], link.noise_std_fn, L,
                         seed=3, frames_per_round=4, max_rounds=1,
                         err_min=10 ** 9, device="cpu")
    assert res.bit_errors[0] == 0 < res.bit_errors[1]


def test_turbo_params_from_arrays_round_trips():
    jt = JTrellis(*RSC8)
    d = convert.trellis_tables(jt)
    d["p_array"] = JCC.RandInterlv(64, 2).p_array
    trellis, p = convert.turbo_params_from_arrays(d)
    np.testing.assert_array_equal(p, d["p_array"])
    for key in convert.TABLE_KEYS:
        np.testing.assert_array_equal(getattr(trellis, key),
                                      np.asarray(getattr(jt, key)))
    # the carried code decodes like the JAX one
    msg, (sy, p1, p2), _ = _frames(RSC8, 64, 2, 0.6, 17, p)
    got = PT.turbo_decode_device(sy, p1, p2, trellis, 0.6, 3, p,
                                 backend="torch", device="cpu")
    want = JT.turbo_decode_device(sy, p1, p2, jt, 0.6, 3, p, backend="xla")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bad = dict(d, p_array=np.r_[d["p_array"][1:], d["p_array"][1]])
    with pytest.raises(ValueError, match="permutation"):
        convert.turbo_params_from_arrays(bad)


def test_turbo_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    x = np.zeros((2, 16), np.float32)
    p = np.arange(16)
    calls = [
        lambda: PT.turbo_decode_device(x, x, x, Trellis(*RSC4), 0.5, 1, p),
        lambda: PT.turbo_encode_device(np.zeros((2, 16), np.int8),
                                       Trellis(*RSC4), Trellis(*RSC4), p),
        lambda: PT.map_decode_device(x, x, Trellis(*RSC4), 0.5, x),
        lambda: PI.interleave(x, p),
        lambda: PI.conv_interleave(x, 2, 1),
        lambda: make_turbo_awgn_link(trellis=Trellis(*RSC4), frame_bits=16,
                                     p_array=p),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
