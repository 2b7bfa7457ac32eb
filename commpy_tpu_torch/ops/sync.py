"""Synchronization: CFO estimation/correction and Schmidl-Cox timing.

Counterpart of ``commpy_tpu/ops/sync.py`` (beyond the reference, which
models the offset only, commpy/impairments.py:20-42).  Every estimator
is a batched correlation of elementwise products and moving sums
(cumulative-sum differences) over the trailing time axis, with any
leading batch axes.

A normalized CFO ``eps`` is in subcarrier spacings (delta_f = eps * Fs /
nfft); estimators return ``eps``.  Phases are formed in float32 in the
JAX package's order, so estimates and derotations agree with it to
float32 rounding.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant, on_device
from ..utils.linalg import small_matmul

__all__ = [
    "cfo_correct",
    "cfo_estimate_cp",
    "integer_cfo_estimate",
    "schmidl_cox_preamble",
    "schmidl_cox_metric",
    "schmidl_cox_estimate",
]

_TWO_PI = float(np.float32(2 * np.pi))


def cfo_correct(waveform, eps, nfft: int, start: int = 0,
                device="cuda") -> torch.Tensor:
    """Derotate a waveform by a normalized CFO ``eps`` (subcarrier units).

    Inverse of ``add_frequency_offset(w, Fs, eps*Fs/nfft)``; ``eps`` is a
    scalar or a tensor with the leading batch axes (per-frame estimates).
    ``start`` is the sample index of the first element.
    """
    w = on_device(waveform, device)
    n = torch.arange(start, start + w.shape[-1], device=w.device,
                     dtype=torch.float32)
    if isinstance(eps, torch.Tensor) and eps.ndim:
        rate = _TWO_PI * on_device(eps, w.device).to(torch.float32)[..., None]
    else:
        rate = float(np.float32(2 * np.pi * float(eps)))
    theta = rate * n / nfft
    return w * torch.polar(torch.ones_like(theta), -theta)


def cfo_estimate_cp(waveform, nfft: int, cp_length: int, n_symbols: int,
                    device="cuda") -> torch.Tensor:
    """CP-correlation (van de Beek) fractional CFO estimate.

    Each OFDM symbol's cyclic prefix repeats ``nfft`` samples later; a CFO
    rotates the repeat by ``2*pi*eps``.  The angle of the sum of
    ``conj(y[t]) * y[t+nfft]`` over every CP sample of ``n_symbols``
    symbols estimates ``eps`` on (-0.5, 0.5) subcarriers.

    ``waveform``: ``[..., T]``, symbols of ``cp_length + nfft`` samples back
    to back from sample 0.  Returns ``eps`` with the leading axes.
    """
    w = on_device(waveform, device)
    sym = cp_length + nfft
    t_np = (np.arange(n_symbols)[:, None] * sym
            + np.arange(cp_length)[None, :]).ravel()
    t = device_constant(t_np, w.device)
    corr = torch.sum(torch.conj(w[..., t]) * w[..., t + nfft], dim=-1)
    return torch.angle(corr) / _TWO_PI


def integer_cfo_estimate(rx_block, ref_freq, max_shift: int = 8,
                         spacing: int = 1, device="cuda") -> torch.Tensor:
    """Integer (whole-bin) CFO from one known symbol, after fractional
    correction.

    Given the ``nfft`` time samples of a known symbol (CP stripped) and
    its bin loading ``ref_freq``, the shift is the argmax of a circular
    cross-correlation of products of bins ``spacing`` apart (a multipath
    channel's per-bin phase ramp cancels).  Use ``spacing=2`` for a
    :func:`schmidl_cox_preamble`.  Returns the integer shift (positive =
    received spectrum shifted up) with the leading batch axes.
    """
    w = on_device(rx_block, device)
    rxf = torch.fft.fft(w, dim=-1)
    ref = np.asarray(ref_freq, np.complex64)
    d_rx = rxf * torch.conj(torch.roll(rxf, -spacing, dims=-1))
    shifts = np.arange(-max_shift, max_shift + 1)
    d_refs = np.stack([
        (r := np.roll(ref, s)) * np.conj(np.roll(r, -spacing))
        for s in shifts
    ])  # [S, nfft]
    a = device_constant(np.ascontiguousarray(np.conj(d_refs).T), w.device)
    metric = torch.abs(small_matmul(d_rx[..., None, :], a)[..., 0, :])
    return device_constant(shifts, w.device)[torch.argmax(metric, dim=-1)]


def schmidl_cox_preamble(nfft: int, seed: int = 0) -> np.ndarray:
    """A two-identical-halves time preamble (QPSK on even subcarriers).

    Loading only even FFT bins makes ``x[t] = x[t + nfft/2]``, the
    structure the Schmidl-Cox metric detects.  Returns ``[nfft]``
    complex64 with unit average energy, made on the host from ``seed``
    (the JAX package's draws).
    """
    rng = np.random.RandomState(seed)
    bins = np.zeros(nfft, np.complex64)
    even = np.arange(2, nfft, 2)  # skip DC
    qpsk = (rng.randint(0, 2, even.size) * 2 - 1
            + 1j * (rng.randint(0, 2, even.size) * 2 - 1)) / np.sqrt(2)
    bins[even] = qpsk
    x = np.fft.ifft(bins)
    x = x / np.sqrt(np.mean(np.abs(x) ** 2))
    return x.astype(np.complex64)


def _moving_sum(x: torch.Tensor, length: int) -> torch.Tensor:
    """Trailing-axis moving sum of ``length`` (cumsum difference)."""
    c = torch.cumsum(x, dim=-1)
    c = torch.cat([torch.zeros_like(c[..., :1]), c], dim=-1)
    return c[..., length:] - c[..., :-length]


def schmidl_cox_metric(waveform, nfft: int, device="cuda"):
    """Schmidl-Cox timing metric M(d) and half-lag correlation P(d).

    ``P(d) = sum_{m<L} conj(r[d+m]) r[d+m+L]``, ``R(d) = sum |r[d+m+L]|^2``
    with ``L = nfft/2``; ``M = |P|^2 / R^2`` plateaus at 1 across the
    preamble.  Returns ``(M, P)``, each ``[..., T - nfft + 1]``.
    """
    w = on_device(waveform, device)
    L = nfft // 2
    p = _moving_sum(torch.conj(w[..., :-L]) * w[..., L:], L)
    r = _moving_sum(torch.abs(w[..., L:]) ** 2, L)
    m = torch.abs(p) ** 2 / torch.clamp_min(r, 1e-12) ** 2
    return m, p


def schmidl_cox_estimate(waveform, nfft: int, device="cuda"):
    """Joint timing and fractional CFO from a Schmidl-Cox preamble.

    ``d_hat`` is the argmax of M (within the plateau: downstream OFDM
    demodulation tolerates any in-CP start); ``eps = angle(P(d_hat)) /
    pi``, on (-1, 1) subcarriers.  Returns ``(d_hat, eps, M)`` with the
    leading batch axes.
    """
    m, p = schmidl_cox_metric(waveform, nfft, device)
    d_hat = torch.argmax(m, dim=-1)
    p_at = torch.take_along_dim(p, d_hat[..., None], dim=-1)[..., 0]
    eps = torch.angle(p_at) / float(np.float32(np.pi))
    return d_hat, eps, m
