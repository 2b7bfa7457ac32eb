"""Interleavers as permutation gathers.

Counterpart of ``commpy_tpu/ops/interleave.py``.  ``interlv`` is a gather
``x[p]`` and ``deinterlv`` the inverse scatter (reference
commpy/channelcoding/interleavers.py:13-77); on the device both
directions are gathers through a permutation computed on the host.
``RandInterlv`` draws its permutation from NumPy's Mersenne Twister
(``mtrand.RandomState(seed).permutation``), exactly as the reference and
the JAX package do, so the patterns are bit-identical.
"""
from __future__ import annotations

import numpy as np
import torch
from numpy.random import mtrand

from ..utils.device import device_constant, on_device

__all__ = [
    "RandInterlv",
    "interleave",
    "deinterleave",
    "inverse_permutation",
    "block_interleaver",
    "conv_interleave",
    "conv_deinterleave",
    "conv_interleaver_delay",
]


def inverse_permutation(p_array) -> np.ndarray:
    p = np.asarray(p_array)
    inv = np.empty_like(p)
    inv[p] = np.arange(p.size)
    return inv


def interleave(x, p_array, device="cuda") -> torch.Tensor:
    """Gather along the last axis: ``out[..., i] = x[..., p[i]]``, on
    ``device``."""
    x = on_device(x, device)
    return x[..., device_constant(np.asarray(p_array, np.int64), x.device)]


def deinterleave(x, p_array, device="cuda") -> torch.Tensor:
    """Inverse of :func:`interleave` (gather by the inverse permutation)."""
    return interleave(x, inverse_permutation(p_array), device)


class _Interleaver:
    def interlv(self, in_array):
        in_array = np.asarray(in_array)
        return in_array[self.p_array]

    def deinterlv(self, in_array):
        in_array = np.asarray(in_array)
        out = np.zeros(len(in_array), in_array.dtype)
        out[self.p_array] = in_array
        return out


class RandInterlv(_Interleaver):
    """Random interleaver seeded exactly like the reference (MT19937)."""

    def __init__(self, length, seed):
        rand_gen = mtrand.RandomState(seed)
        self.p_array = rand_gen.permutation(np.arange(length))


# ---------------------------------------------------------------------------
# Block and convolutional (Forney) interleavers: beyond the reference
# (CommPy ships only RandInterlv); DVB-T runs RS(204,188) behind a Forney
# interleaver with I=12, M=17.
# ---------------------------------------------------------------------------

def block_interleaver(rows: int, cols: int) -> np.ndarray:
    """Permutation writing row-wise and reading column-wise.

    Use with :func:`interleave` / :func:`deinterleave`; a burst of b
    consecutive interleaved symbols lands at least ``cols`` apart after
    deinterleaving (for b <= rows).
    """
    return np.arange(rows * cols).reshape(rows, cols).T.reshape(-1)


def conv_interleaver_delay(I: int, M: int) -> int:
    """End-to-end delay of the (I, M) Forney interleaver pair."""
    return I * (I - 1) * M


def _conv_indices(n: int, I: int, M: int, deinter: bool):
    if I < 1 or M < 0:
        raise ValueError(f"need I >= 1 branches and M >= 0, got ({I}, {M})")
    i = np.arange(n)
    branch = i % I
    delay = (I - 1 - branch if deinter else branch) * M * I
    src = i - delay
    valid = src >= 0
    return np.where(valid, src, 0), valid


def _conv_gather(x, I, M, fill, deinter, device):
    x = on_device(x, device)
    src, valid = _conv_indices(x.shape[-1], I, M, deinter)
    out = x[..., device_constant(src, x.device)]
    return torch.where(device_constant(valid, x.device), out,
                       torch.tensor(fill, dtype=x.dtype, device=x.device))


def conv_interleave(x, I: int, M: int, fill=0, device="cuda"):
    """Forney convolutional interleaver along the last axis.

    Branch ``i mod I`` delays by ``(i mod I) * M`` branch symbols
    (``* I`` absolute).  On a finite frame, positions that read before the
    frame start yield ``fill``.  ``conv_deinterleave(conv_interleave(x))``
    reproduces ``x`` delayed by :func:`conv_interleaver_delay`.
    """
    return _conv_gather(x, I, M, fill, False, device)


def conv_deinterleave(x, I: int, M: int, fill=0, device="cuda"):
    """Inverse branch delays of :func:`conv_interleave` (same I, M)."""
    return _conv_gather(x, I, M, fill, True, device)
