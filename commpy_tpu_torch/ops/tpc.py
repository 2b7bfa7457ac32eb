r"""Turbo product codes: BCH x BCH with Chase-Pyndiah iterative decoding.

Counterpart of ``commpy_tpu/ops/tpc.py`` (the reference has none): the
block turbo code of Pyndiah (1998), an optional mode of IEEE 802.16.  An
(nr,kr) x (nc,kc) product code places data in a [kr, kc] array, extends
every row with the row code's parity and every column with the column
code's; its minimum distance is the product dr * dc.

Decoding alternates row and column half-iterations of the soft-output
Chase element (:func:`~commpy_tpu_torch.ops.bch.make_bch_chase_soft`):
each takes R = channel + alpha_j * extrinsic, decodes every row (resp.
column) at once, the other axis folded into the batch, and emits the
new extrinsic W = soft_out - R.  ``alpha`` is Pyndiah's confidence ramp.
"""
from __future__ import annotations

import functools

import torch

from ..utils.device import on_device, resolve_device
from .bch import make_bch_chase_soft, make_bch_encoder

__all__ = ["tpc_encode", "tpc_decode", "make_tpc_decoder"]

#: Pyndiah's per-half-iteration extrinsic weights (a rising confidence).
_ALPHA = (0.0, 0.2, 0.3, 0.5, 0.7, 0.9, 1.0, 1.0)


def tpc_encode(code_row, code_col, data, device="cuda"):
    """data [B, kr, kc] bits -> product codeword [B, nr, nc] int8 on
    ``device``.

    ``code_row`` encodes along the last axis (rows of length nc),
    ``code_col`` along the second-to-last (columns of length nr).
    """
    dev = resolve_device(device)
    data = on_device(data, dev)
    B, kr, kc = data.shape
    if kr != code_col.k or kc != code_row.k:
        raise ValueError(
            f"data [{kr}, {kc}] must be [{code_col.k}, {code_row.k}]")
    enc_r = make_bch_encoder(code_row, dev)
    enc_c = make_bch_encoder(code_col, dev)
    rows = enc_r(data.reshape(B * kr, kc)).reshape(B, kr, code_row.n)
    cols = enc_c(rows.transpose(1, 2).reshape(B * code_row.n, kr))
    return cols.reshape(B, code_row.n, code_col.n).transpose(1, 2).to(
        torch.int8)


@functools.lru_cache(maxsize=16)
def make_tpc_decoder(code_row, code_col, iterations=4, p=4, beta=0.5,
                     alpha=_ALPHA, device="cuda"):
    """``decode(llr [B, nr, nc]) -> (data [B, kr, kc] int8, hard [B, nr,
    nc] int8)`` on ``device``.

    LLR convention: positive => bit 0.  ``iterations`` full iterations
    are 2x half-iterations of the Chase SISO; ``alpha`` gives the
    extrinsic weight of each half-iteration (its last entry repeats when
    the schedule is shorter than 2*iterations).
    """
    dev = resolve_device(device)
    nr, nc = code_col.n, code_row.n
    siso_r = make_bch_chase_soft(code_row, p=p, beta=beta, device=dev)
    siso_c = make_bch_chase_soft(code_col, p=p, beta=beta, device=dev)

    def decode(llr):
        llr = on_device(llr, dev).to(torch.float32)
        B = llr.shape[0]
        W = torch.zeros_like(llr)
        hard = None
        for h in range(2 * iterations):
            a = alpha[min(h, len(alpha) - 1)]
            R = llr + a * W
            if h % 2 == 0:  # rows
                soft, hrd = siso_r(R.reshape(B * nr, nc))
                soft = soft.reshape(B, nr, nc)
                hard = hrd.reshape(B, nr, nc)
            else:  # columns
                soft, hrd = siso_c(R.transpose(1, 2).reshape(B * nc, nr))
                soft = soft.reshape(B, nc, nr).transpose(1, 2)
                hard = hrd.reshape(B, nc, nr).transpose(1, 2)
            W = soft - R
        data = hard[:, :code_col.k, :code_row.k]
        return data.to(torch.int8), hard.to(torch.int8)

    return decode


def tpc_decode(code_row, code_col, llr, iterations=4, p=4, device="cuda"):
    """Chase-Pyndiah decode on ``device``: llr [B, nr, nc] -> (data, hard
    array)."""
    return make_tpc_decoder(code_row, code_col, iterations=iterations, p=p,
                            device=device)(llr)
