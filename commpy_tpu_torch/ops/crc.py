"""Cyclic redundancy checks: batched GF(2) products on the device.

Counterpart of ``commpy_tpu/ops/crc.py`` (the reference has no CRC).  A
CRC with a zero register preset is GF(2)-linear in the message:
``crc(m) = m @ T mod 2`` for a constant ``[k, r]`` bit matrix ``T``.
With a preset (``init``) and an output inversion (``xorout``) it is
affine: ``crc(m) = (m @ T + c0) mod 2`` with ``c0 = crc(0**k)``.
Attaching or checking a CRC over a ``[B, k]`` bit batch is one float32
product (exact: counts below 2^24) and a parity fold; the bitwise
shift register runs on the host only, as the golden
(:func:`crc_remainder`).  :func:`crc_tables` builds ``T`` in one
O(k * r) pass: row i holds ``x^(k-1-i+r) mod g``, each row the previous
one times x.

Bit conventions: messages are MSB-first bit arrays; parity is appended
MSB-first (3GPP).  :func:`crc32_bytes` maps the reflected ISO-HDLC
CRC-32 (zlib, the 802.11 FCS) onto the same machinery.

**CRC24C differs from the JAX package on purpose.**  Here it is
0xB2B117 (D^24 + D^23 + D^21 + D^20 + D^17 + D^15 + D^13 + D^12 + D^8 +
D^4 + D^2 + D + 1), the gCRC24C of 3GPP TS 38.212 section 5.1, whose
catalog check (CRC-24/NR-C) for ``b"123456789"`` is 0xF48279.
``commpy_tpu/ops/crc.py`` uses 0x8F6E37, which is no published CRC and
gives 0xBE7F82 there.  crc6, crc11, crc16, crc24a, crc24b and crc32 are
the JAX package's, bit for bit.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import device_constant, on_device, resolve_device

__all__ = [
    "CrcSpec",
    "CRC_POLYNOMIALS",
    "crc_remainder",
    "crc_encode_table",
    "crc_check_table",
    "crc_tables",
    "crc_attach",
    "crc_check",
    "make_crc_attach",
    "make_crc_check",
    "crc32_bytes",
]

#: Generator polynomials, MSB-first including the leading term.
#: crc6/crc11/crc16/crc24a/crc24b/crc24c are the 3GPP TS 38.212 section
#: 5.1 set (0x21, 0x621, 0x1021, 0x864CFB, 0x800063, 0xB2B117; zero
#: preset, parity appended MSB-first); crc32 is the IEEE 802.3 polynomial
#: 0x04C11DB7, non-reflected (see :func:`crc32_bytes` for the reflected
#: ISO-HDLC variant of the 802.11 FCS).
CRC_POLYNOMIALS = {
    "crc6": (1, 1, 0, 0, 0, 0, 1),                    # x^6+x^5+1
    "crc11": (1, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0, 1),    # x^11+x^10+x^9+x^5+1
    # CCITT/XMODEM: x^16 + x^12 + x^5 + 1
    "crc16": (1, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1),
}


def _poly_bits(value: int, width: int) -> tuple:
    """MSB-first coefficient tuple (incl. leading 1) from a hex poly."""
    return (1,) + tuple((value >> (width - 1 - i)) & 1 for i in range(width))


CRC_POLYNOMIALS["crc24a"] = _poly_bits(0x864CFB, 24)
CRC_POLYNOMIALS["crc24b"] = _poly_bits(0x800063, 24)
CRC_POLYNOMIALS["crc24c"] = _poly_bits(0xB2B117, 24)
CRC_POLYNOMIALS["crc32"] = _poly_bits(0x04C11DB7, 32)


@dataclass(frozen=True)
class CrcSpec:
    """A cyclic redundancy check: ``poly`` is MSB-first incl. leading 1.

    ``init`` presets the shift register (MSB-first integer, e.g. 0xFFFF
    for CRC-16/CCITT-FALSE); ``xorout`` is XORed into the final
    remainder.  Zero/zero (the 3GPP convention) keeps the check linear.
    """

    poly: tuple
    init: int = 0
    xorout: int = 0

    @classmethod
    def named(cls, name):
        return cls(poly=CRC_POLYNOMIALS[name])

    @property
    def length(self):
        return len(self.poly) - 1


def _spec(crc) -> CrcSpec:
    if isinstance(crc, str):
        return CrcSpec.named(crc)
    if isinstance(crc, (tuple, list)):  # a raw MSB-first poly
        return CrcSpec(poly=tuple(int(c) for c in crc))
    return crc


def _bits_msb(value: int, width: int) -> np.ndarray:
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)],
                    np.int64)


def crc_remainder(bits, crc) -> np.ndarray:
    """Bitwise shift-register CRC (host golden). Returns r bits MSB-first."""
    crc = _spec(crc)
    r = _bits_msb(crc.init, crc.length)
    taps = np.asarray(crc.poly[1:], np.int64)
    for b in np.asarray(bits, np.int64).ravel():
        fb = (b & 1) ^ r[0]
        r = np.concatenate([r[1:], [0]])
        if fb:
            r ^= taps
    return r ^ _bits_msb(crc.xorout, crc.length)


@functools.lru_cache(maxsize=64)
def _tables_cached(crc: CrcSpec, k: int):
    r = crc.length
    mask = (1 << r) - 1
    taps = int("".join(str(int(c)) for c in crc.poly[1:]), 2)

    def times_x(v):
        return ((v << 1) & mask) ^ (taps if v >> (r - 1) & 1 else 0)

    # linear part: message bit i rides x^(k-1-i), its CRC is
    # x^(k-1-i+r) mod g; x^r mod g is the taps
    rows = np.zeros(k, np.int64)
    v = taps
    for i in range(k - 1, -1, -1):
        rows[i] = v
        v = times_x(v)
    # affine part: the register's preset clocked through k zero bits
    c = crc.init
    for _ in range(k):
        c = times_x(c)
    shifts = np.arange(r - 1, -1, -1)
    T = (rows[:, None] >> shifts) & 1
    c0 = (np.int64(c ^ crc.xorout) >> shifts) & 1
    T.setflags(write=False)
    c0.setflags(write=False)
    return T, c0


def crc_tables(crc, k):
    """Affine device form: ``crc(m) = (m @ T + c0) mod 2``.

    Returns ``(T, c0)`` with ``T`` ``[k, r]`` and ``c0`` ``[r]`` (int64,
    read-only, cached per spec and k).  ``c0`` folds ``init`` and
    ``xorout``: it is the CRC of the all-zero message, and row i of ``T``
    is ``crc(e_i) ^ c0``.
    """
    return _tables_cached(_spec(crc), int(k))


def crc_encode_table(crc, k):
    """[k, r] GF(2) matrix T with crc(m) = m @ T mod 2 (linear specs only:
    init = xorout = 0; affine specs use :func:`crc_tables`)."""
    crc = _spec(crc)
    if crc.init or crc.xorout:
        raise ValueError(
            "crc_encode_table is linear-only (init=0, xorout=0); use "
            "crc_tables for affine specs"
        )
    return crc_tables(crc, k)[0]


def crc_check_table(crc, k_total):
    """[k_total, r] matrix H with (payload||crc) @ H mod 2 == 0 iff valid
    (linear specs only, as :func:`crc_encode_table`)."""
    crc = _spec(crc)
    k = k_total - crc.length
    return np.concatenate(
        [crc_encode_table(crc, k), np.eye(crc.length, dtype=np.int64)], axis=0
    )


def _affine(crc, k, check):
    T, c0 = crc_tables(crc, k)
    if check:
        T = np.concatenate([T, np.eye(len(c0), dtype=np.int64)], axis=0)
    return T.astype(np.float32), c0.astype(np.float32)


def make_crc_attach(crc, k, device="cuda"):
    """``attach(bits [..., k]) -> [..., k + r]`` on ``device``, the tables
    copied there once."""
    dev = resolve_device(device)
    T, c0 = (device_constant(a, dev) for a in _affine(_spec(crc), k, False))

    def attach(bits):
        bits = on_device(bits, dev)
        parity = torch.remainder(bits.to(torch.float32) @ T + c0, 2.0)
        return torch.cat([bits, parity.to(bits.dtype)], dim=-1)

    return attach


def make_crc_check(crc, k_total, device="cuda"):
    """``check(bits [..., k_total]) -> bool [...]`` on ``device``."""
    crc = _spec(crc)
    dev = resolve_device(device)
    H, c0 = (device_constant(a, dev)
             for a in _affine(crc, k_total - crc.length, True))

    def check(bits):
        bits = on_device(bits, dev)
        syn = torch.remainder(bits.to(torch.float32) @ H + c0, 2.0)
        return torch.all(syn == 0, dim=-1)

    return check


def crc_attach(bits, crc, device="cuda"):
    """Append CRC parity to a ``[..., k]`` bit batch on ``device`` (one
    product)."""
    bits = on_device(bits, device)
    return make_crc_attach(crc, bits.shape[-1], bits.device)(bits)


def crc_check(bits, crc, device="cuda"):
    """Validity of ``[..., k+r]`` (payload||parity) batches -> bool[...]."""
    bits = on_device(bits, device)
    return make_crc_check(crc, bits.shape[-1], bits.device)(bits)


def crc32_bytes(data: bytes) -> int:
    """Reflected ISO-HDLC CRC-32 (zlib / 802.11 FCS) over bytes.

    Feeds each input byte LSB-first through the non-reflected 0x04C11DB7
    register with init = xorout = 0xFFFFFFFF, then bit-reverses the
    remainder.  Equals ``binascii.crc32(data)``.
    """
    bits = np.unpackbits(
        np.frombuffer(data, np.uint8).reshape(-1, 1), axis=1, bitorder="little"
    ).ravel()
    spec = CrcSpec(
        poly=CRC_POLYNOMIALS["crc32"], init=0xFFFFFFFF, xorout=0xFFFFFFFF
    )
    rem = crc_remainder(bits, spec)
    return int("".join(str(b) for b in rem[::-1]), 2)
