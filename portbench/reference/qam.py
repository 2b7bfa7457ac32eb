"""Gray square QAM, the AWGN channel and the exact-LLR demapper.

The constellation is CommPy's (``modulation.py``, QAMModem): PAM levels
``-sqrt(m)+1 .. sqrt(m)-1`` on each axis, labelled so that the index's
bits, most significant first, are a Gray code.  The demapper is the
exact log-likelihood ratio, bit by bit a log-sum-exp over the points
whose label has that bit set, minus the same over the others
(positive means bit 1).
"""
from __future__ import annotations

import numpy as np
import torch


def gray_qam(m: int) -> np.ndarray:
    """The Gray-labelled square ``m``-QAM points (complex128)."""
    side = int(round(np.sqrt(m)))
    pam = np.arange(-side + 1, side, 2)
    pts = (np.tile(np.hstack((pam, pam[::-1])), side // 2) * 1j
           + pam.repeat(side))
    gray = np.arange(m) ^ (np.arange(m) >> 1)
    out = np.empty_like(pts)
    out[gray] = pts
    return out


class Qam:
    def __init__(self, m: int, device):
        self.m = m
        self.bps = int(np.log2(m))
        pts = gray_qam(m)
        self.es = float(np.mean(np.abs(pts) ** 2))
        self.points = torch.as_tensor(pts.astype(np.complex64), device=device)
        labels = np.arange(m)
        masks = (labels[None, :] >> (self.bps - 1 - np.arange(self.bps))[:, None]) & 1
        self.masks = torch.as_tensor(masks.astype(bool), device=device)
        self.weights = torch.as_tensor(
            1 << np.arange(self.bps - 1, -1, -1), device=device)

    def modulate(self, coded: torch.Tensor) -> torch.Tensor:
        """Bits ``[F, n]`` -> complex64 symbols ``[F, n / bps]``."""
        groups = coded.reshape(coded.shape[0], -1, self.bps).long()
        return self.points[(groups * self.weights).sum(-1)]

    def channel(self, symbols, noise, noise_std: float, dtype):
        """Received ``(re, im)`` in ``dtype``: ``s + n * noise_std / 2``."""
        scale = float(np.float32(noise_std) * np.float32(0.5))
        if dtype == torch.float32:
            y = symbols + noise * scale
            return y.real, y.imag
        return (symbols.real.to(dtype) + noise.real.to(dtype) * scale,
                symbols.imag.to(dtype) + noise.imag.to(dtype) * scale)

    def llr(self, yr, yi, noise_std: float) -> torch.Tensor:
        """Exact LLRs ``[F, n_sym * bps]`` in the dtype of ``yr``."""
        dtype = yr.dtype
        ns = np.float32(noise_std)
        nv = torch.full((), float(ns * ns), dtype=dtype, device=yr.device)
        dr = yr.unsqueeze(-1) - self.points.real.to(dtype)
        di = yi.unsqueeze(-1) - self.points.imag.to(dtype)
        logw = (-(dr * dr + di * di) / nv).unsqueeze(-2)  # [F, n_sym, 1, m]
        neg_inf = torch.full((), -torch.inf, dtype=dtype, device=yr.device)
        one = torch.logsumexp(torch.where(self.masks, logw, neg_inf), dim=-1)
        zero = torch.logsumexp(torch.where(self.masks, neg_inf, logw), dim=-1)
        llr = one - zero  # [F, n_sym, bps]
        return llr.reshape(llr.shape[0], -1)
