"""Small matrix products in plain float32 arithmetic.

The MIMO and OFDM paths multiply by matrices of a few rows (antennas,
channel taps).  A library matmul there may take TensorFloat-32 when the
caller has allowed it (``torch.backends.cuda.matmul.allow_tf32``), which
keeps 10 bits of mantissa; these products are written as elementwise
multiplies and sums instead, so they round as float32 whatever the
caller's settings.  A complex product is four real ones,
``re = sum(ar br) - sum(ai bi)`` and ``im = sum(ar bi) + sum(ai br)``,
each summed in index order: the order XLA's CPU dot takes, so the
results agree with the JAX package bit for bit where no other rounding
intervenes.
"""
from __future__ import annotations

import torch

__all__ = ["small_matmul"]

_UNROLL = 8  # contractions up to this length accumulate term by term


def _real_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    K = a.shape[-1]
    if K > _UNROLL:
        return (a.unsqueeze(-1) * b.unsqueeze(-3)).sum(-2)
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, K):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def small_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [..., i, k] @ b [..., k, j]`` (batch axes broadcast), real or
    complex.

    Up to ``_UNROLL`` terms each real sum accumulates in the order k = 0,
    1, ...; longer contractions take one broadcast product and a sum.
    """
    if b.shape[-2] != a.shape[-1]:
        raise ValueError(f"contraction lengths differ: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    if not (a.is_complex() or b.is_complex()):
        return _real_matmul(a, b)
    if not b.is_complex():
        return torch.complex(_real_matmul(a.real, b), _real_matmul(a.imag, b))
    if not a.is_complex():
        return torch.complex(_real_matmul(a, b.real), _real_matmul(a, b.imag))
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    return torch.complex(_real_matmul(ar, br) - _real_matmul(ai, bi),
                         _real_matmul(ar, bi) + _real_matmul(ai, br))
