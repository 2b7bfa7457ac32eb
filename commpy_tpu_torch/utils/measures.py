"""Distance / power / resampling helpers.

Counterpart of ``commpy_tpu/utils/measures.py`` (reference
commpy/utilities.py:112-205).  Every function takes arbitrary leading
batch axes, reduces over ``axis`` (all axes when None) and moves its
input to ``device``.
"""
from __future__ import annotations

import torch

from .device import on_device

__all__ = ["hamming_dist", "euclid_dist", "upsample", "signal_power"]


def _sum(x: torch.Tensor, axis, dtype=None) -> torch.Tensor:
    return x.sum(dtype=dtype) if axis is None else x.sum(axis, dtype=dtype)


def hamming_dist(a, b, axis=None, device="cuda") -> torch.Tensor:
    """Hamming distance between 0/1 arrays (reference utilities.py:112),
    int32."""
    a = on_device(a, device).to(torch.int32)
    b = on_device(b, device).to(torch.int32)
    return _sum(torch.bitwise_xor(a, b), axis, torch.int32)


def euclid_dist(a, b, axis=None, device="cuda") -> torch.Tensor:
    """Squared Euclidean distance (reference utilities.py:135)."""
    d = on_device(a, device) - on_device(b, device)
    return _sum(d * d, axis)


def upsample(x, n: int, device="cuda") -> torch.Tensor:
    """Zero-insertion upsampling along the last axis, in the input's
    dtype."""
    x = on_device(x, device)
    y = torch.zeros(x.shape[:-1] + (x.shape[-1] * n,), dtype=x.dtype,
                    device=x.device)
    y[..., ::n] = x
    return y


def signal_power(signal, axis=None, device="cuda") -> torch.Tensor:
    """Mean of ``|s|^2`` (reference utilities.py:185)."""
    p = on_device(signal, device).abs() ** 2
    return p.mean() if axis is None else p.mean(axis)
