"""GF(2^m) arithmetic and polynomial helpers.

Counterpart of ``commpy_tpu/ops/galois.py``: host-side NumPy with the API
and behaviour of reference commpy/channelcoding/gfields.py (element sets,
power <-> tuple form, orders, cyclotomic cosets, minimal polynomials).
Configuration-time algebra for cyclic code design, so it stays on the
host.
"""
from __future__ import annotations

from math import gcd

import numpy as np

from ..utils.bits import np_pack_bits, np_unpack_bits

__all__ = ["GF", "polydivide", "polymultiply", "poly_to_string"]

# Primitive polynomials for GF(2^m), m = 0..16 (gfields.py:49-51).
_PRIMPOLYS = np.array(
    [0, 3, 7, 11, 19, 37, 67, 137, 285, 529, 1033, 2053, 4179, 8219, 17475,
     32771, 69643]
)


class GF:
    """Set of elements of the binary Galois field GF(2^m)."""

    def __init__(self, x, m):
        self.m = m
        self.prim_poly = int(_PRIMPOLYS[m])
        if isinstance(x, (int, np.integer)) and 0 <= x < 2 ** m:
            self.elements = np.array([x])
        elif isinstance(x, np.ndarray) and len(x) >= 1:
            self.elements = x.astype(int)

    def __add__(self, other):
        if len(self.elements) != len(other.elements):
            raise ValueError(
                "The arguments should have the same number of elements"
            )
        return GF(self.elements ^ other.elements, self.m)

    def __mul__(self, other):
        if len(other.elements) != len(self.elements):
            raise ValueError("Two sets of elements cannot be multiplied")
        prod = np.array(
            [
                polymultiply(int(a), int(b), self.m, self.prim_poly)
                for a, b in zip(self.elements, other.elements)
            ]
        )
        return GF(prod, self.m)

    def power_to_tuple(self):
        """alpha^i -> tuple (polynomial) representation."""
        y = np.zeros(len(self.elements))
        for idx, i in enumerate(self.elements):
            if 2 ** i < 2 ** self.m:
                y[idx] = 2 ** i
            else:
                y[idx] = polydivide(2 ** int(i), self.prim_poly)
        return GF(y.astype(int), self.m)

    def tuple_to_power(self):
        """tuple (polynomial) -> exponent representation."""
        y = np.zeros(len(self.elements))
        mask = 2 ** self.m - 1
        for idx, el in enumerate(self.elements):
            if el != 0:
                state, power = 1, 0
                while state != el:
                    msb = (state & 2 ** (self.m - 1)) >> (self.m - 1)
                    state = ((state << 1) & mask) ^ (
                        -msb & (self.prim_poly & mask)
                    )
                    power += 1
                y[idx] = power
        return GF(y.astype(int), self.m)

    def order(self):
        """Multiplicative order of each element."""
        orders = np.zeros(len(self.elements))
        powers = self.tuple_to_power().elements
        n = 2 ** self.m - 1
        for idx, p in enumerate(powers):
            orders[idx] = n / gcd(int(p), n)
        return orders

    def cosets(self):
        """Cyclotomic cosets of the field (gfields.py:115-138)."""
        coset_list = []
        x = self.tuple_to_power().elements
        mark = np.zeros(len(x))
        n = 2 ** self.m - 1
        count = 1
        for idx in range(len(x)):
            if mark[idx] == 0:
                a = x[idx]
                mark[idx] = count
                i = 1
                while (a * 2 ** i) % n != a:
                    target = a * 2 ** i % n
                    for idx2 in range(len(x)):
                        if mark[idx2] == 0 and x[idx2] == target:
                            mark[idx2] = count
                    i += 1
                count += 1
        for c in range(1, count):
            coset_list.append(GF(self.elements[mark == c], self.m))
        return coset_list

    def minpolys(self):
        """Minimal polynomial (as int) of each element (gfields.py:140-162)."""
        minpols = []
        full = GF(np.arange(2 ** self.m), self.m)
        full_cosets = full.cosets()
        for x in self.elements:
            for coset in full_cosets:
                if x not in coset.elements:
                    continue
                # product of (z - root) over the coset, coefficients in GF
                t = np.array([1, coset.elements[0]])[::-1]
                for root in coset.elements[1:]:
                    t2 = np.concatenate(
                        (np.zeros(len(t) - 1), np.array([1, root]),
                         np.zeros(len(t) - 1))
                    )
                    prod_poly = np.array([])
                    for nn in range(len(t2) - len(t) + 1):
                        acc = 0
                        for kk in range(len(t)):
                            acc ^= polymultiply(
                                int(t[kk]), int(t2[nn + kk]), self.m,
                                self.prim_poly,
                            )
                        prod_poly = np.concatenate((prod_poly, [acc]))
                    t = prod_poly[::-1]
                minpols.append(int(np_pack_bits(t[::-1].astype(int))))
                break
        return np.array(minpols, int)


def polydivide(x, y):
    """Remainder of GF(2) polynomial division (gfields.py:165-175)."""
    r = y
    while len(bin(r)) >= len(bin(y)):
        shift = len(bin(x)) - len(bin(y))
        d = y << shift if shift > 0 else y
        x = x ^ d
        r = x
    return r


def polymultiply(x, y, m, prim_poly):
    """GF(2^m) multiplication via convolution mod primitive poly."""
    xa = np_unpack_bits(x, m)
    ya = np_unpack_bits(y, m)
    prod = int(np_pack_bits(np.convolve(xa, ya) % 2))
    return polydivide(prod, prim_poly)


def poly_to_string(x):
    """Human-readable GF(2) polynomial."""
    i = 0
    out = ""
    x = int(x)
    while x != 0:
        if x % 2 == 1:
            out += "x^" + str(i) + " + "
        x >>= 1
        i += 1
    return out[:-2]
