"""Iterative detection and decoding (IDD) on the device.

Counterpart of ``commpy_tpu/models/idd.py`` (reference
commpy/links.py:345-407): the reference's per-vector loop is one batched
detector call a pass, and the IDD iterations are a Python loop; the
extrinsic information flows detector <-> decoder as in the reference
closure.
"""
from __future__ import annotations

from typing import Callable

import torch

__all__ = ["idd_decoder_device"]


def idd_decoder_device(detector: Callable, decoder: Callable,
                       decision: Callable, n_it: int):
    """Build a batched IDD decode function.

    Parameters
    ----------
    detector : ``(y [V, nr], h [V, nr, nt], noise_var, a_priori [V, bps*nt])
        -> LLRs [V, bps*nt]``, a batched soft detector (e.g. a partial of
        :func:`commpy_tpu_torch.ops.mimo.kbest_device` with soft output).
    decoder : ``(LLRs [n_bits]) -> LLRs [n_bits]``, a soft-in/soft-out
        decoder over the whole frame.
    decision : ``(LLRs [n_bits]) -> bits``, the final hard decision.
    n_it : IDD iterations.

    Returns
    -------
    decode : ``(y, h, noise_var, a_priori) -> bits``
    """

    def decode(y, h, noise_var, a_priori):
        V = y.shape[0]
        bits_per_vec = a_priori.shape[0] // V
        a_dec = a_priori
        a_det = torch.zeros_like(a_priori)
        for _ in range(n_it):
            a_det = decoder(a_dec) - a_dec
            det_out = detector(y, h, noise_var,
                               a_det.reshape(V, bits_per_vec))
            a_dec = det_out.reshape(-1) - a_det
        return decision(a_dec + a_det)

    return decode
