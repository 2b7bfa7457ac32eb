"""Bit packing / unpacking, MSB first.

Counterpart of ``commpy_tpu/utils/bits.py``: ``unpack_bits`` produces a
trailing bit axis (bit ``j`` is ``(x >> (w-1-j)) & 1``), ``pack_bits``
contracts it back.  The ``np_*`` variants build tables on the host.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["unpack_bits", "pack_bits", "np_unpack_bits", "np_pack_bits"]


def unpack_bits(x: torch.Tensor, bit_width: int) -> torch.Tensor:
    """Integers ``[...]`` -> int8 bits ``[..., bit_width]``, MSB first."""
    x = torch.as_tensor(x)
    shifts = torch.arange(bit_width - 1, -1, -1, device=x.device,
                          dtype=x.dtype)
    return ((x.unsqueeze(-1) >> shifts) & 1).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Bits ``[..., w]`` -> int32 ``[...]``, MSB first (inverse of unpack)."""
    bits = torch.as_tensor(bits)
    w = bits.shape[-1]
    weights = 1 << torch.arange(w - 1, -1, -1, device=bits.device,
                                dtype=torch.int32)
    return (bits.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def np_unpack_bits(x, bit_width: int) -> np.ndarray:
    """Host-side :func:`unpack_bits` (NumPy, for table construction)."""
    x = np.asarray(x, dtype=np.int64)
    shifts = np.arange(bit_width - 1, -1, -1)
    return ((x[..., None] >> shifts) & 1).astype(np.int8)


def np_pack_bits(bits) -> np.ndarray:
    """Host-side :func:`pack_bits` (NumPy, for table construction)."""
    bits = np.asarray(bits, dtype=np.int64)
    w = bits.shape[-1]
    weights = 1 << np.arange(w - 1, -1, -1, dtype=np.int64)
    return (bits * weights).sum(axis=-1)
