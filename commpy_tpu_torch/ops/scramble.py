"""802.11 scramblers: frame-synchronous and self-synchronising LFSR pair.

Counterpart of ``commpy_tpu/ops/scramble.py``.  The scrambler is the
degree-7 LFSR ``S(x) = x^7 + x^4 + 1`` (IEEE 802.11 section 17.3.5.5).
The register is ``x1..x7`` with ``x7`` the oldest bit; the output and
feedback bit is ``x4 ^ x7``; integer seeds pack ``x1`` as the MSB.

* Frame-synchronous: one XOR with the 127-periodic sequence tiled to the
  frame length; its own inverse.
* Self-synchronising: the scrambler feeds its OUTPUT back (a Python loop
  over the trailing axis); the descrambler is the FIR
  ``y[i] = x[i] ^ x[i-4] ^ x[i-7]`` (shifts and XORs).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant, on_device

__all__ = [
    "wifi_scrambler_sequence",
    "scramble",
    "descramble",
    "selfsync_scramble",
    "selfsync_descramble",
    "selfsync_descramble_host",
]


def _seed_state(seed: int) -> np.ndarray:
    if not 0 < seed < 128:
        raise ValueError("seed must be a non-zero 7-bit integer")
    return np.array([(seed >> (6 - i)) & 1 for i in range(7)], np.int8)


def wifi_scrambler_sequence(seed: int = 0x7F, length: int = 127) -> np.ndarray:
    """Frame-synchronous scrambling sequence from a non-zero 7-bit seed."""
    x = _seed_state(seed)
    out = np.empty(length, np.int8)
    for i in range(length):
        fb = x[3] ^ x[6]  # x4 ^ x7
        out[i] = fb
        x[1:] = x[:-1]
        x[0] = fb
    return out


def scramble(bits: torch.Tensor, seed: int = 0x7F,
             device="cuda") -> torch.Tensor:
    """Frame-synchronous scramble of a ``[..., L]`` bit batch (moved to
    ``device``)."""
    bits = on_device(bits, device)
    length = bits.shape[-1]
    seq = wifi_scrambler_sequence(seed, 127)
    tiled = np.tile(seq, -(-length // 127))[:length]
    return bits ^ device_constant(tiled, bits.device).to(bits.dtype)


descramble = scramble  # XOR with the same sequence is an involution


def selfsync_scramble(bits: torch.Tensor, seed: int = 0x7F,
                      device="cuda") -> torch.Tensor:
    """Self-synchronising scramble on ``device``: ``out[i] = in[i] ^ s4 ^
    s7`` where the register holds previous OUTPUT bits."""
    bits = on_device(bits, device)
    x = torch.as_tensor(_seed_state(seed), dtype=bits.dtype,
                        device=bits.device).expand(bits.shape[:-1] + (7,))
    out = torch.empty_like(bits)
    for i in range(bits.shape[-1]):
        o = bits[..., i] ^ x[..., 3] ^ x[..., 6]
        out[..., i] = o
        x = torch.cat([o.unsqueeze(-1), x[..., :-1]], dim=-1)
    return out


def selfsync_descramble(bits: torch.Tensor, seed: int = 0x7F,
                        device="cuda") -> torch.Tensor:
    """Inverse of :func:`selfsync_scramble` on ``device``: the FIR
    ``y = x ^ x>>4 ^ x>>7``."""
    bits = on_device(bits, device)
    pre = torch.as_tensor(_seed_state(seed)[::-1].copy(), dtype=bits.dtype,
                          device=bits.device).expand(bits.shape[:-1] + (7,))
    ext = torch.cat([pre, bits], dim=-1)  # ext[..., 7+i] = bits[..., i]
    return bits ^ ext[..., 3:-4] ^ ext[..., :-7]


def selfsync_descramble_host(bits, seed: int = 0x7F) -> np.ndarray:
    """NumPy golden for :func:`selfsync_descramble` (explicit register
    walk)."""
    bits = np.asarray(bits, np.int8)
    x = _seed_state(seed)
    out = np.empty_like(bits)
    flat_in = bits.reshape(-1, bits.shape[-1])
    flat_out = out.reshape(-1, bits.shape[-1])
    for r in range(flat_in.shape[0]):
        xr = x.copy()
        for i in range(flat_in.shape[1]):
            b = flat_in[r, i]
            flat_out[r, i] = b ^ xr[3] ^ xr[6]
            xr[1:] = xr[:-1]
            xr[0] = b
    return out
