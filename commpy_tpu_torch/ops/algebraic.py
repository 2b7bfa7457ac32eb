"""Cyclic code generator-polynomial search.

Counterpart of ``commpy_tpu/ops/algebraic.py``, host NumPy as reference
commpy/channelcoding/algcode.py:11-64: find m with n | 2^m - 1, build the
cyclotomic cosets, take their minimal polynomials, and multiply every
subset whose degrees sum to n - k.
"""
from __future__ import annotations

import numpy as np

from .galois import GF
from ..utils.bits import np_pack_bits, np_unpack_bits

__all__ = ["cyclic_code_genpoly"]


def cyclic_code_genpoly(n, k):
    """All generator polynomials (as ints) of an (n, k) cyclic code."""
    if n % 2 == 0:
        raise ValueError("n cannot be an even number")

    for m in range(1, 18):
        if (2 ** m - 1) % n == 0:
            break

    full = GF(np.arange(1, 2 ** m), m)
    cosets = full.cosets()

    leaders = np.array([c.elements[0] for c in cosets])
    degrees = np.array([len(c.elements) for c in cosets])

    minpols = GF(leaders, m).minpolys()
    poly_list = []
    for i in range(1, 2 ** len(minpols)):
        picks = np_unpack_bits(i, len(minpols)) == 1
        if int(degrees[picks].sum()) != n - k:
            continue
        gpoly = 1
        for poly in minpols[picks]:
            a = np_unpack_bits(int(gpoly), 2 ** m)
            b = np_unpack_bits(int(poly), 2 ** m)
            gpoly = int(np_pack_bits(np.convolve(a, b) % 2))
        poly_list.append(gpoly)
    return np.array(poly_list, int)
