"""Reference-compatible utilities module (commpy.utilities API).

Counterpart of ``commpy_tpu/utilities.py``: NumPy in, NumPy arrays and
Python numbers out, so CommPy users can switch imports unchanged
(reference commpy/utilities.py:30-205).  Each function computes on
``device`` (keyword-only, default ``"cuda"``).
"""
from __future__ import annotations

import numpy as np
import torch

from .utils import measures as _ms
from .utils.bits import unpack_bits
from .utils.device import on_device

__all__ = [
    "dec2bitarray",
    "decimal2bitarray",
    "bitarray2dec",
    "hamming_dist",
    "euclid_dist",
    "upsample",
    "signal_power",
]


def _unpack(x, bit_width, device):
    ints = on_device(np.asarray(x, np.int64), device)
    return unpack_bits(ints, int(bit_width)).cpu().numpy()


def dec2bitarray(in_number, bit_width, *, device="cuda"):
    """Integer or array-like of integers to MSB-first bit array (int8)."""
    if isinstance(in_number, (np.integer, int)):
        return _unpack(int(in_number), bit_width, device)
    return _unpack(list(in_number), bit_width, device).reshape(-1)


def decimal2bitarray(number, bit_width, *, device="cuda"):
    """Single-integer variant of :func:`dec2bitarray`."""
    return _unpack(int(number), bit_width, device)


def bitarray2dec(in_bitarray, *, device="cuda"):
    """MSB-first bit array to integer."""
    bits = on_device(np.asarray(in_bitarray, np.int64).ravel(), device)
    if bits.numel() == 0:
        return 0
    weights = 1 << torch.arange(bits.numel() - 1, -1, -1, device=bits.device,
                                dtype=torch.int64)
    return int((bits * weights).sum())


def hamming_dist(in_bitarray_1, in_bitarray_2, *, device="cuda"):
    return int(_ms.hamming_dist(np.asarray(in_bitarray_1),
                                np.asarray(in_bitarray_2), device=device))


def euclid_dist(in_array1, in_array2, *, device="cuda"):
    return float(_ms.euclid_dist(np.asarray(in_array1),
                                 np.asarray(in_array2), device=device))


def upsample(x, n, *, device="cuda"):
    """Zero-insertion upsample; always complex (utilities.py:157-181)."""
    x = np.asarray(x).astype(complex)
    return _ms.upsample(x, int(n), device=device).cpu().numpy()


def signal_power(signal, *, device="cuda"):
    return float(_ms.signal_power(np.asarray(signal), device=device))
