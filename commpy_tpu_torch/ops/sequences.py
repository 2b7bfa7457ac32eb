"""PN (LFSR) and Zadoff-Chu sequences (reference commpy/sequences.py:21-110).

Counterpart of ``commpy_tpu/ops/sequences.py``.  Sequences are made once
per link set-up, so :func:`pnsequence` and :func:`zcsequence` run on the
host; :func:`pnsequence_device` clocks the same LFSR with tensor
operations on a device, one step a loop iteration in the order of the
JAX package's ``lax.scan``, and gives the host path's bits.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import resolve_device

__all__ = ["pnsequence", "zcsequence", "pnsequence_device"]


def pnsequence(pn_order: int, pn_seed, pn_mask, seq_length: int) -> np.ndarray:
    """LFSR PN sequence, host path.

    Output convention of reference sequences.py:68-72: ``sr[-1]`` is
    emitted first; the feedback bit ``sum(sr & mask) % 2`` enters ``sr[0]``.
    """
    if len(pn_seed) != pn_order:
        raise ValueError("pn_seed has not the same length as pn_order")
    if len(pn_mask) != pn_order:
        raise ValueError("pn_mask has not the same length as pn_order")

    sr = np.fromiter(pn_seed, np.int8, pn_order)
    mask = np.fromiter(pn_mask, np.int8, pn_order)
    pnseq = np.empty(seq_length, np.int8)
    for i in range(seq_length):
        pnseq[i] = sr[-1]
        new_bit = np.sum(sr & mask) % 2
        sr[1:] = sr[:-1]
        sr[0] = new_bit
    return pnseq


def pnsequence_device(pn_order: int, pn_seed, pn_mask, seq_length: int,
                      device="cuda") -> torch.Tensor:
    """LFSR PN sequence as int8 ``[seq_length]`` on ``device``."""
    dev = resolve_device(device)
    sr = torch.as_tensor(np.fromiter(pn_seed, np.int8, pn_order), device=dev)
    mask = torch.as_tensor(np.fromiter(pn_mask, np.int8, pn_order),
                           device=dev)
    out = []
    for _ in range(seq_length):
        out.append(sr[-1])
        new_bit = (torch.sum(sr & mask) % 2).to(torch.int8)
        sr = torch.cat([new_bit.reshape(1), sr[:-1]])
    if not out:
        return torch.zeros(0, dtype=torch.int8, device=dev)
    return torch.stack(out)


def zcsequence(u: int, seq_length: int, q: int = 0) -> np.ndarray:
    """Zadoff-Chu sequence (reference sequences.py:76-110), vectorized."""
    for el in (u, seq_length, q):
        if not float(el).is_integer():
            raise ValueError("{} is not an integer".format(el))
    if u <= 0:
        raise ValueError("u is not stricly positive")
    if u >= seq_length:
        raise ValueError("u is not stricly smaller than seq_length")
    if np.gcd(int(u), int(seq_length)) != 1:
        raise ValueError(
            "the greatest common denominator of u and seq_length is not 1"
        )
    cf = seq_length % 2
    n = np.arange(seq_length)
    return np.exp(-1j * np.pi * u * n * (n + cf + 2.0 * q) / seq_length)
