"""Pulse-shaping FIR tap generators (reference commpy/filters.py:23-186).

Counterpart of ``commpy_tpu/ops/filters.py``: the same closed forms with
masked singularities, computed on the host in float64, so the taps are
bit-identical to the JAX package's (the exact-float singularity
predicates included).  The taps are configuration-time constants that
:mod:`commpy_tpu_torch.ops.fir` convolves on the device.

All four generators return ``(time_idx, taps)`` as the reference does.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rcosfilter", "rrcosfilter", "gaussianfilter", "rectfilter"]


def _time_axis(N: int, Fs: float):
    T_delta = 1.0 / float(Fs)
    time_idx = (np.arange(N) - N / 2) * T_delta
    return time_idx


def rcosfilter(N: int, alpha: float, Ts: float, Fs: float):
    """Raised-cosine FIR taps (reference filters.py:23-68)."""
    t = _time_axis(N, Fs)
    with np.errstate(divide="ignore", invalid="ignore"):
        sinc_part = np.sin(np.pi * t / Ts) / (np.pi * t / Ts)
        cos_part = np.cos(np.pi * alpha * t / Ts) / (
            1 - ((2 * alpha * t) / Ts) ** 2
        )
        h = sinc_part * cos_part
    h = np.where(t == 0.0, 1.0, h)
    if alpha != 0:
        # exact float comparison on purpose: the reference's singularity
        # predicate (filters.py:60-64)
        sing = (t == Ts / (2 * alpha)) | (t == -Ts / (2 * alpha))
        with np.errstate(divide="ignore", invalid="ignore"):
            h_sing = (np.pi / 4) * (np.sin(np.pi * t / Ts) / (np.pi * t / Ts))
        h = np.where(sing, h_sing, h)
    return t, h


def rrcosfilter(N: int, alpha: float, Ts: float, Fs: float):
    """Root-raised-cosine FIR taps (reference filters.py:70-119)."""
    t = _time_axis(N, Fs)
    with np.errstate(divide="ignore", invalid="ignore"):
        h = (
            np.sin(np.pi * t * (1 - alpha) / Ts)
            + 4 * alpha * (t / Ts) * np.cos(np.pi * t * (1 + alpha) / Ts)
        ) / (np.pi * t * (1 - (4 * alpha * t / Ts) ** 2) / Ts)
    h = np.where(t == 0.0, 1.0 - alpha + (4 * alpha / np.pi), h)
    if alpha != 0:
        sing = (t == Ts / (4 * alpha)) | (t == -Ts / (4 * alpha))
        h_sing = (alpha / np.sqrt(2)) * (
            (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
            + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha))
        )
        h = np.where(sing, h_sing, h)
    return t, h


def gaussianfilter(N: int, alpha: float, Ts: float, Fs: float):
    """Gaussian FIR taps (reference filters.py:121-154)."""
    t = _time_axis(N, Fs)
    h = (np.sqrt(np.pi) / alpha) * np.exp(-((np.pi * t / alpha) ** 2))
    return t, h


def rectfilter(N: int, Ts: float, Fs: float):
    """Rectangular FIR taps (reference filters.py:156-186)."""
    t = _time_axis(N, Fs)
    return t, np.ones(N)
