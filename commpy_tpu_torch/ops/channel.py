"""Fading / AWGN / erasure channel models.

Counterpart of ``commpy_tpu/ops/channel.py`` (reference
commpy/channels.py).  Each sampled channel takes a ``torch.Generator`` in
place of the JAX key and is split in two: ``*_propagate`` draws, and
``*_apply`` is the deterministic rest, which takes the draws as tensors.
Conventions match the reference:

* complex noise = (N(0,1) + jN(0,1)) * noise_std * 0.5   (channels.py:52-55)
* noise_std = sqrt((isComplex+1) * nb_tx * Es / (rate * 10^(SNR/10)))
  (channels.py:74)
* SISO gains = LOS + N * sqrt(0.5 * NLOS)                (channels.py:213-217)
* MIMO Kronecker: sqrtm(Rr) @ H_iid @ sqrtm(Rt) + mean   (channels.py:377-379)

All functions accept arbitrary leading batch axes on ``msg``.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.linalg import sqrtm as _host_sqrtm

from ..utils.device import on_device
from ..utils.linalg import small_matmul

__all__ = [
    "snr_to_noise_std",
    "siso_propagate",
    "siso_apply",
    "mimo_propagate",
    "mimo_apply",
    "kronecker_sqrt_factors",
    "bec",
    "bec_apply",
    "bsc",
    "bsc_apply",
    "awgn",
    "crandn",
]


def snr_to_noise_std(snr_db, *, code_rate=1.0, Es=1.0, is_complex=True,
                     nb_tx=1):
    """Noise std from SNR in dB (reference channels.py:57-74), on the host."""
    snr_lin = 10.0 ** (np.asarray(snr_db, np.float64) / 10.0)
    return np.sqrt((int(is_complex) + 1) * nb_tx * Es / (code_rate * snr_lin))


def crandn(generator, shape, device) -> torch.Tensor:
    """Complex normals ``re + 1j*im`` with unit-variance parts, complex64."""
    z = torch.randn((2,) + tuple(shape), generator=generator, device=device)
    return torch.complex(z[0], z[1])


def _f32(x) -> float:
    return float(np.float32(x))


def siso_apply(msg, g, n, noise_std, fading_param=(1.0, 0.0),
               is_complex=True, device="cuda"):
    """The deterministic part of :func:`siso_propagate`: ``g`` and ``n``
    are its standard normal draws (complex when ``is_complex``), each
    shaped like ``msg``.  Returns ``(output, gains, noise)``."""
    msg = on_device(msg, device)
    g, n = on_device(g, msg.device), on_device(n, msg.device)
    los, nlos = fading_param
    if is_complex:
        gains = los + g * _f32(np.sqrt(np.float32(0.5 * nlos)))
        noise = n * _f32(np.float32(noise_std) * np.float32(0.5))
    else:
        gains = los + g * _f32(np.sqrt(np.float32(nlos)))
        noise = n * _f32(noise_std)
    return gains * msg + noise, gains, noise


def siso_propagate(generator, msg, noise_std, fading_param=(1.0, 0.0),
                   is_complex=True, device="cuda"):
    """Flat-fading SISO channel.

    ``fading_param`` is (LOS mean, NLOS variance): (1, 0) is no fading,
    (0, 1) Rayleigh; the energy invariant ``|p0|^2 + p1 = 1`` (reference
    channels.py:230-231) is the caller's contract.  ``generator`` lives on
    ``device``.  Returns ``(output, gains, noise)``, each ``[..., n]``.
    """
    msg = on_device(msg, device)
    if is_complex:
        g = crandn(generator, msg.shape, msg.device)
        n = crandn(generator, msg.shape, msg.device)
    else:
        g = torch.randn(msg.shape, generator=generator, device=msg.device)
        n = torch.randn(msg.shape, generator=generator, device=msg.device)
    return siso_apply(msg, g, n, noise_std, fading_param, is_complex,
                      msg.device)


def kronecker_sqrt_factors(fading_param):
    """Host precompute of (mean, sqrtm(Rt), sqrtm(Rr)) for
    :func:`mimo_propagate` from the reference triple (mean, Rt, Rr)
    (channels.py:242-339), with SciPy."""
    mean, rt, rr = fading_param
    srt = np.asarray(_host_sqrtm(np.asarray(rt)))
    srr = np.asarray(_host_sqrtm(np.asarray(rr)))
    return np.asarray(mean), srt, srr


def mimo_apply(msg, h_iid, noise, mean, sqrt_rt, sqrt_rr, device="cuda"):
    """The deterministic part of :func:`mimo_propagate`: correlate the
    i.i.d. channel ``h_iid [..., nb_vect, nb_rx, nb_tx]`` (already scaled)
    as ``sqrt_rr @ h_iid @ sqrt_rt^T + mean``, apply it to ``msg`` and add
    ``noise [..., nb_vect, nb_rx]`` (already scaled).  The products are
    float32 elementwise sums over the antennas.  Returns ``(output,
    gains, noise)``."""
    msg = on_device(msg, device)
    h_iid = on_device(h_iid, msg.device)
    noise = on_device(noise, msg.device)
    dt = h_iid.dtype
    srr = torch.as_tensor(np.asarray(sqrt_rr), device=msg.device).to(dt)
    srt = torch.as_tensor(np.asarray(sqrt_rt), device=msg.device).to(dt)
    mu = np.asarray(mean)
    mu = torch.as_tensor(mu if dt.is_complex else mu.real,
                         device=msg.device).to(dt)
    # reference einsum('ij,ajk,lk->ail', sqrtm(Rr), H, sqrtm(Rt))
    gains = small_matmul(small_matmul(srr, h_iid), srt.transpose(0, 1)) + mu
    unnoisy = small_matmul(gains, msg.to(dt).unsqueeze(-1))[..., 0]
    return unnoisy + noise, gains, noise


def mimo_propagate(generator, msg, noise_std, mean, sqrt_rt, sqrt_rr,
                   is_complex=True, device="cuda"):
    """Kronecker-model flat MIMO channel.

    ``msg [..., nb_vect, nb_tx]`` symbol vectors; ``mean [nb_rx, nb_tx]``,
    ``sqrt_rt``, ``sqrt_rr`` from :func:`kronecker_sqrt_factors`.
    Returns ``(output [..., nb_vect, nb_rx], gains [..., nb_vect, nb_rx,
    nb_tx], noise [..., nb_vect, nb_rx])``.
    """
    msg = on_device(msg, device)
    nb_rx, nb_tx = np.shape(mean)
    lead = tuple(msg.shape[:-1])
    dev = msg.device
    if is_complex:
        h_iid = crandn(generator, lead + (nb_rx, nb_tx), dev) * _f32(
            np.sqrt(np.float32(0.5)))
        noise = crandn(generator, lead + (nb_rx,), dev) * _f32(
            np.float32(noise_std) * np.float32(0.5))
    else:
        h_iid = torch.randn(lead + (nb_rx, nb_tx), generator=generator,
                            device=dev)
        noise = torch.randn(lead + (nb_rx,), generator=generator,
                            device=dev) * _f32(noise_std)
    return mimo_apply(msg, h_iid, noise, mean, sqrt_rt, sqrt_rr, dev)


def bec_apply(input_bits, u, p_e, device="cuda") -> torch.Tensor:
    """Erase (set to -1) the bits whose uniform draw ``u`` is <= p_e."""
    bits = on_device(input_bits, device)
    u = on_device(u, bits.device)
    return torch.where(u <= p_e, torch.full_like(bits, -1), bits)


def bec(generator, input_bits, p_e, device="cuda") -> torch.Tensor:
    """Binary erasure channel: erased positions become -1
    (channels.py:630)."""
    bits = on_device(input_bits, device)
    u = torch.rand(bits.shape, generator=generator, device=bits.device)
    return bec_apply(bits, u, p_e, bits.device)


def bsc_apply(input_bits, u, p_t, device="cuda") -> torch.Tensor:
    """Flip the bits whose uniform draw ``u`` is <= p_t."""
    bits = on_device(input_bits, device)
    u = on_device(u, bits.device)
    return torch.where(u <= p_t, 1 - bits, bits)


def bsc(generator, input_bits, p_t, device="cuda") -> torch.Tensor:
    """Binary symmetric channel: flips with probability p_t
    (channels.py:652)."""
    bits = on_device(input_bits, device)
    u = torch.rand(bits.shape, generator=generator, device=bits.device)
    return bsc_apply(bits, u, p_t, bits.device)


def awgn(input_signal: torch.Tensor, snr_dB, rate=1.0,
         generator: torch.Generator | None = None,
         device="cuda") -> torch.Tensor:
    """Legacy AWGN helper measuring the average input energy
    (reference channels.py:675); the signal is moved to ``device``, where
    ``generator`` must live."""
    x = on_device(input_signal, device)
    avg_energy = torch.sum(x.abs() * x.abs()) / x.numel()
    snr_linear = 10 ** (snr_dB / 10.0)
    noise_variance = avg_energy / (2 * rate * snr_linear)
    real_dtype = x.real.dtype if x.is_complex() else x.dtype
    if x.is_complex():
        re = torch.randn(x.shape, generator=generator, device=x.device,
                         dtype=real_dtype)
        im = torch.randn(x.shape, generator=generator, device=x.device,
                         dtype=real_dtype)
        noise = torch.sqrt(noise_variance) * torch.complex(re, im)
    else:
        noise = torch.sqrt(2 * noise_variance) * torch.randn(
            x.shape, generator=generator, device=x.device, dtype=real_dtype)
    return x + noise
