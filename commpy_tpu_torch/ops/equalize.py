r"""Linear channel equalization: MMSE and zero-forcing FIR designs, and
training-directed block LMS.

Counterpart of ``commpy_tpu/ops/equalize.py`` (the reference has no
equalizer).  With channel taps ``h`` (length Lh) and receiver taps ``w``
(length Lw), the combined response is the convolution matrix
``H [Lw, Lw+Lh-1]`` (row i = h shifted by i).  The MMSE taps solve

    (H H^H + noise_var I) u = H e_delay,   w = conj(u)

which minimizes E|w * y - x[n-delay]|^2 for unit-power i.i.d. symbols;
zero-forcing is the noise_var -> 0 limit (a tiny diagonal keeps the
solve well posed).  The delay defaults to the combined centre
``(Lw + Lh - 1) // 2``.

The complex solve runs as the real block system ``[[A, -B], [B, A]]`` in
float32, the form the JAX package solves, so both round alike; the
system is tiny (Lw is a few tens).  Taps are applied with the FFT
convolution of :mod:`commpy_tpu_torch.ops.fir`.
"""
from __future__ import annotations

import torch

from ..utils.device import on_device
from .fir import fir_filter

__all__ = ["mmse_fir_taps", "zf_fir_taps", "equalize", "equalizer_delay",
           "lms_equalize"]


def equalizer_delay(n_taps, channel_len):
    """Default decision delay of the designed equalizer."""
    return (n_taps + channel_len - 1) // 2


def _conv_matrix(h, n_taps):
    """[..., Lw, Lw+Lh-1] convolution (filtering) matrix of h."""
    Lh = h.shape[-1]
    H = h.new_zeros(h.shape[:-1] + (n_taps, Lh + n_taps - 1))
    for i in range(n_taps):
        H[..., i, i:i + Lh] = h
    return H


def _solve_complex(A, b):
    """Batched solve of complex ``A x = b`` through the real block system."""
    Ar, Ai = A.real, A.imag
    top = torch.cat([Ar, -Ai], dim=-1)
    bot = torch.cat([Ai, Ar], dim=-1)
    blk = torch.cat([top, bot], dim=-2)
    rhs = torch.cat([b.real, b.imag], dim=-1)
    x = torch.linalg.solve(blk, rhs.unsqueeze(-1))[..., 0]
    n = A.shape[-1]
    return torch.complex(x[..., :n], x[..., n:])


def mmse_fir_taps(h, noise_var, n_taps, delay=None, device="cuda"):
    """MMSE linear-equalizer taps for channel ``h`` [..., Lh] on ``device``.

    ``noise_var``: complex noise variance relative to unit symbol power
    (a number or a tensor broadcasting against the batch).  Returns
    complex64 taps [..., n_taps]; apply them with :func:`equalize`.
    """
    h = on_device(h, device).to(torch.complex64)
    Lh = h.shape[-1]
    if delay is None:
        delay = equalizer_delay(n_taps, Lh)
    if not 0 <= delay < n_taps + Lh - 1:
        raise ValueError(f"delay {delay} outside combined response "
                         f"[0, {n_taps + Lh - 2}]")
    H = _conv_matrix(h, n_taps)
    R = H @ H.transpose(-1, -2).conj()  # E[y y^H] for unit x
    if isinstance(noise_var, torch.Tensor) and noise_var.ndim:
        noise_var = noise_var[..., None, None]
    R = R + noise_var * torch.eye(n_taps, dtype=H.dtype, device=H.device)
    p = H[..., :, delay]  # E[y x*[n-delay]]
    # Wiener: z = u^H y with u = R^{-1} p; the convolution taps are
    # w = conj(u)
    return _solve_complex(R, p).conj_physical()


def zf_fir_taps(h, n_taps, delay=None, eps=1e-6, device="cuda"):
    """Zero-forcing taps (MMSE with a tiny regularizer)."""
    return mmse_fir_taps(h, eps, n_taps, delay=delay, device=device)


def equalize(y, w, delay, n_out=None, device="cuda"):
    """Apply equalizer taps and align the decision delay.

    y [..., n] received samples, w [t] taps; returns the equalized
    estimate of x[0:n_out] (n_out defaults to n).  One tap set for the
    whole batch, as in the JAX package: map over the batch
    (``torch.vmap``) for per-batch taps.
    """
    y = on_device(y, device)
    w = on_device(w, y.device)
    if w.ndim > 1:
        raise ValueError(
            "per-batch tap sets: vmap equalize over the leading axes")
    z = fir_filter(y, w, mode="full", device=y.device)
    n_out = y.shape[-1] if n_out is None else n_out
    short = delay + n_out - z.shape[-1]
    if short > 0:  # few-tap equalizers: keep the output length exact
        z = torch.cat([z, z.new_zeros(z.shape[:-1] + (short,))], dim=-1)
    return z[..., delay:delay + n_out]


def lms_equalize(y, train, n_taps, mu, delay, block=32, device="cuda"):
    """Adaptive block-LMS equalization with training symbols.

    y [..., n] received samples; train [..., n] known transmitted symbols
    (the desired output at sample i is ``train[i - delay]``); ``mu`` step
    size; ``block`` samples per tap update: each block is filtered with
    the current taps, then one accumulated-gradient update
    ``w += mu * sum(conj(x_vec) * e)``.  A Python loop over the blocks,
    in the order of the JAX package's scan.

    Returns ``(z, w, mse)``: the equalized stream [..., n], the final
    taps [..., n_taps] and the per-block mean-square error [n_blocks]
    (averaged over the batch).
    """
    y = on_device(y, device).to(torch.complex64)
    train = on_device(train, y.device).to(torch.complex64)
    lead = y.shape[:-1]
    n = y.shape[-1]
    nb = n // block
    n_use = nb * block
    # windows[..., i, k] = y[i - k] (zeros before the stream start)
    ypad = torch.cat([y.new_zeros(lead + (n_taps - 1,)), y], dim=-1)
    windows = torch.stack(
        [ypad[..., n_taps - 1 - k:n_taps - 1 - k + n_use]
         for k in range(n_taps)], dim=-1)  # [..., n_use, n_taps]
    tpad = torch.cat([train.new_zeros(lead + (delay,)), train], dim=-1)
    Xb = windows.reshape(lead + (nb, block, n_taps))
    Db = tpad[..., :n_use].reshape(lead + (nb, block))
    w = y.new_zeros(lead + (n_taps,))
    zs, mse = [], []
    for i in range(nb):
        X, d = Xb[..., i, :, :], Db[..., i, :]
        z = torch.sum(X * w[..., None, :], dim=-1)  # [..., block]
        e = d - z
        grad = torch.sum(X.conj() * e[..., None], dim=-2)
        w = w + mu * grad
        mse.append(torch.mean(torch.abs(e) ** 2))
        zs.append(z)
    z = torch.cat(zs, dim=-1) if zs else y[..., :0]
    if n_use < n:
        z = torch.cat([z, y[..., n_use:]], dim=-1)
    mse = torch.stack(mse) if mse else y.real.new_zeros(0)
    return z, w, mse
