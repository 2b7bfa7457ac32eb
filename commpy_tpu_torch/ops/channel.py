"""AWGN channel helpers.

Counterpart of the AWGN part of ``commpy_tpu/ops/channel.py``; the
fading, MIMO and erasure channels are not ported yet.  Conventions match
the reference: complex noise is ``(N(0,1) + jN(0,1)) * noise_std * 0.5``
(channels.py:52-55) with ``noise_std`` from :func:`snr_to_noise_std`
(channels.py:74).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import on_device

__all__ = ["snr_to_noise_std", "awgn"]


def snr_to_noise_std(snr_db, *, code_rate=1.0, Es=1.0, is_complex=True,
                     nb_tx=1):
    """Noise std from SNR in dB (reference channels.py:57-74), on the host."""
    snr_lin = 10.0 ** (np.asarray(snr_db, np.float64) / 10.0)
    return np.sqrt((int(is_complex) + 1) * nb_tx * Es / (code_rate * snr_lin))


def awgn(input_signal: torch.Tensor, snr_dB, rate=1.0,
         generator: torch.Generator | None = None,
         device="cuda") -> torch.Tensor:
    """Legacy AWGN helper measuring the average input energy
    (reference channels.py:675); the signal is moved to ``device``, where
    ``generator`` must live."""
    x = on_device(input_signal, device)
    avg_energy = torch.sum(x.abs() * x.abs()) / x.numel()
    snr_linear = 10 ** (snr_dB / 10.0)
    noise_variance = avg_energy / (2 * rate * snr_linear)
    real_dtype = x.real.dtype if x.is_complex() else x.dtype
    if x.is_complex():
        re = torch.randn(x.shape, generator=generator, device=x.device,
                         dtype=real_dtype)
        im = torch.randn(x.shape, generator=generator, device=x.device,
                         dtype=real_dtype)
        noise = torch.sqrt(noise_variance) * torch.complex(re, im)
    else:
        noise = torch.sqrt(2 * noise_variance) * torch.randn(
            x.shape, generator=generator, device=x.device, dtype=real_dtype)
    return x + noise
