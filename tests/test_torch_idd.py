"""The port's IDD loops and IDD K-best LDPC MIMO link against the JAX
package.

The loops: the deterministic stubs of ``tests/test_idd_parity.py`` (a
detector that mixes y, h, the noise variance and the prior; a decoder
that couples bits across vectors, so a wrong order or extrinsic
subtraction diverges at once), rewritten in torch, go through the port's
``idd_decoder_device`` and the JAX package's, at n_it 1, 2 and 4; the
NumPy stubs go through both packages' host closures
``links.idd_decoder``.  This holds the loop without the upstream
``commpy``.  Decisions must be identical; the float32 total LLRs agree
within rtol = atol = 1e-5 (the stubs' tanh and products rounded by XLA
and by PyTorch), the host closures exactly, and the float64 device loop
equals the host closure within 1e-12.

The link: the same NumPy bits, noise and channel go through the JAX ops
composed by hand (encode, map, channel, K-best with priors and the clip,
the JAX IDD loop around BP) and through the port's ``transceive``, on the
small WiMAX (960, 720) code; decisions must be identical.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import commpy_tpu.links as JLK
from commpy_tpu.models.idd import idd_decoder_device as jax_idd
from commpy_tpu.ops import ldpc as JL
from commpy_tpu.ops import mimo as JMI
from commpy_tpu.ops import modem as JM
from commpy_tpu_torch import links as PLK
from commpy_tpu_torch.models import (idd_decoder_device,
                                     make_idd_kbest_ldpc_mimo_link)
from commpy_tpu_torch.ops import ldpc as PL

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, NR, NT, BPS = 5, 3, 2, 2
BPV = NT * BPS


@pytest.fixture(scope="module")
def stubs():
    rng = np.random.RandomState(42)
    y = (rng.randn(V, NR) + 1j * rng.randn(V, NR)).astype(np.complex128)
    h = rng.randn(V, NR, NT) + 1j * rng.randn(V, NR, NT)
    a0 = rng.randn(V * BPV)
    W = rng.randn(BPV, 2 * NR)
    D = np.eye(V * BPV) * 1.1 + 0.2 * np.roll(np.eye(V * BPV), 1, axis=1)
    return y, h, 0.3, a0, W, D


def _numpy_stubs(W, D):
    def det(yv, hv, constellation, nv, a_priori):
        return (W[:, :BPV] @ np.tanh(a_priori)) * 0.5 + \
            (W @ np.concatenate([np.real(yv), np.imag(yv)])) / (1 + nv)

    def dec(llrs):
        return D @ np.tanh(llrs) + llrs

    return det, dec


def _torch_stubs(W, D, dtype):
    Wt, Dt = torch.as_tensor(W, dtype=dtype), torch.as_tensor(D, dtype=dtype)

    def det(yb, hb, nv, a_priori):
        yr = torch.cat([yb.real, yb.imag], dim=-1)
        return (torch.tanh(a_priori) @ Wt[:, :BPV].T) * 0.5 + \
            (yr @ Wt.T) / (1 + nv)

    def dec(llrs):
        return Dt @ torch.tanh(llrs) + llrs

    return det, dec


def _jax_stubs(W, D):
    Wj, Dj = jnp.asarray(W), jnp.asarray(D)

    def det(yb, hb, nv, a_priori):
        yr = jnp.concatenate([jnp.real(yb), jnp.imag(yb)], axis=-1)
        return (jnp.tanh(a_priori) @ Wj[:, :BPV].T) * 0.5 + \
            (yr @ Wj.T) / (1 + nv)

    def dec(llrs):
        return Dj @ jnp.tanh(llrs) + llrs

    return det, dec


@pytest.mark.parametrize("n_it", [1, 2, 4])
def test_idd_loops_match_the_jax_loops(stubs, n_it):
    y, h, nv, a0, W, D = stubs
    # host closures: the same NumPy float64 arithmetic, bit for bit
    det_np, dec_np = _numpy_stubs(W, D)
    hard = (lambda llrs: (llrs < 0).astype(np.int64))
    ident = (lambda llrs: llrs)
    want_host = JLK.idd_decoder(det_np, dec_np, ident, n_it)(
        y, h, None, nv, a0.copy(), BPV)
    got_host = PLK.idd_decoder(det_np, dec_np, ident, n_it)(
        y, h, None, nv, a0.copy(), BPV)
    np.testing.assert_array_equal(got_host, want_host)
    np.testing.assert_array_equal(
        PLK.idd_decoder(det_np, dec_np, hard, n_it)(y, h, None, nv,
                                                    a0.copy(), BPV),
        JLK.idd_decoder(det_np, dec_np, hard, n_it)(y, h, None, nv,
                                                    a0.copy(), BPV))
    # device loops in float32: the JAX package's and the port's
    det_j, dec_j = _jax_stubs(W, D)
    args_j = (jnp.asarray(y), jnp.asarray(h), nv, jnp.asarray(a0))
    tot_j = np.asarray(jax_idd(det_j, dec_j, lambda l: l, n_it)(*args_j))
    bits_j = np.asarray(jax_idd(det_j, dec_j,
                                lambda l: (l < 0).astype(jnp.int8),
                                n_it)(*args_j))
    det_t, dec_t = _torch_stubs(W, D, torch.float32)
    args_t = (torch.as_tensor(y.astype(np.complex64)),
              torch.as_tensor(h.astype(np.complex64)), nv,
              torch.as_tensor(a0, dtype=torch.float32))
    tot_t = idd_decoder_device(det_t, dec_t, lambda l: l, n_it)(*args_t)
    bits_t = idd_decoder_device(det_t, dec_t,
                                lambda l: (l < 0).to(torch.int8),
                                n_it)(*args_t)
    np.testing.assert_array_equal(bits_t.numpy(), bits_j)
    np.testing.assert_allclose(tot_t.numpy(), tot_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(bits_t.numpy(), hard(want_host))
    # the device loop in float64 is the host closure's arithmetic
    det_64, dec_64 = _torch_stubs(W, D, torch.float64)
    tot_64 = idd_decoder_device(det_64, dec_64, lambda l: l, n_it)(
        torch.as_tensor(y), torch.as_tensor(h), nv, torch.as_tensor(a0))
    np.testing.assert_allclose(tot_64.numpy(), want_host, rtol=1e-12,
                               atol=1e-12)


# ------------------------------------------------------------------ the link

@pytest.fixture(scope="module")
def wimax960():
    a = JL.get_ldpc_code_params(os.path.join(
        REPO, "commpy_tpu", "designs", "ldpc", "wimax", "960.720.a.txt"), True)
    b = PL.get_ldpc_code_params(os.path.join(PL.DESIGNS, "wimax",
                                             "960.720.a.txt"), True)
    return a, b


def _jax_idd_link(a, bits, noise, h, ns, n_it, damping, clip):
    F = bits.shape[0]
    n_v, n_vec = a["n_vnodes"], a["n_vnodes"] // 16
    G = np.asarray(a["generator_matrix"].todense()) % 2
    const = JM.qam_constellation(16).astype(np.complex64)
    x = JM.modulate(JL.ldpc_encode_device(bits, G), const, 4).reshape(
        F, n_vec, 4)
    y = (jnp.einsum("fvrt,fvt->fvr", jnp.asarray(h), x)
         + jnp.asarray(noise) * (jnp.float32(ns) * 0.5))
    yf, hf = y.reshape(-1, 4), jnp.asarray(h).reshape(-1, 4, 4)
    nv = jnp.float32(ns) ** 2

    def detector(yv, hv, noise_var, a_priori):
        return JMI.kbest_device(yv, hv, const, 16, noise_var, "soft", 4,
                                a_priori=a_priori, llr_clip=clip)

    def decoder(llrs):
        _, post = JL.ldpc_bp_decode_device(llrs.reshape(F, n_v), a, "MSA",
                                           15)
        post = post.reshape(-1)
        return post if damping == 1.0 else llrs + damping * (post - llrs)

    def decision(llrs):
        dec, _ = JL.ldpc_bp_decode_device(llrs.reshape(F, n_v), a, "MSA", 15)
        return dec[..., :n_v - a["n_cnodes"]]

    run = jax.jit(lambda yf, hf, a0: jax_idd(detector, decoder, decision,
                                             n_it)(yf, hf, nv, a0))
    a0 = detector(yf, hf, nv, jnp.zeros((yf.shape[0], 16), jnp.float32))
    return np.asarray(run(yf, hf, a0.reshape(-1)))


@pytest.mark.parametrize("n_it,damping", [(1, 1.0), (2, 0.5)])
def test_idd_link_transceive_matches_jax_ops(wimax960, n_it, damping):
    a, b = wimax960
    link = make_idd_kbest_ldpc_mimo_link(ldpc_params=b, n_it=n_it,
                                         damping=damping, device="cpu")
    assert link.frame_bits == 720 and link.extras["noise_shape"] == (60, 4)
    F = 2
    rng = np.random.RandomState(9)
    bits = rng.randint(0, 2, (F, 720)).astype(np.int8)
    noise = (rng.randn(F, 60, 4) + 1j * rng.randn(F, 60, 4)).astype(
        np.complex64)
    h = ((rng.randn(F, 60, 4, 4) + 1j * rng.randn(F, 60, 4, 4))
         * np.sqrt(0.5)).astype(np.complex64)
    ns = float(np.float32(link.noise_std_fn(20.0)))
    want = _jax_idd_link(a, bits, noise, h, ns, n_it, damping, 50.0)
    got = link.transceive(torch.as_tensor(bits), torch.as_tensor(noise), ns,
                          torch.as_tensor(h))
    np.testing.assert_array_equal(got.numpy(), want)
    # the first pass's LLRs are clipped before any extrinsic subtraction
    a0 = link.receive(torch.as_tensor(bits), torch.as_tensor(noise), ns,
                      torch.as_tensor(h))[3]
    assert torch.isfinite(a0).all() and a0.abs().max() <= 50.0
    assert (want != bits).mean() < 0.05
    assert b["_qc_lift"] is not None  # the QC route: K4 on the card


def test_idd_link_high_vs_low_snr_and_needs_a_gpu(wimax960):
    b = wimax960[1]
    link = make_idd_kbest_ldpc_mimo_link(ldpc_params=b, device="cpu")
    gen = torch.Generator().manual_seed(1)
    assert int(link.link_step(gen, 2, float(link.noise_std_fn(40.0)))) == 0
    assert int(link.link_step(gen, 2, float(link.noise_std_fn(8.0)))) > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_idd_kbest_ldpc_mimo_link(ldpc_params=b)
