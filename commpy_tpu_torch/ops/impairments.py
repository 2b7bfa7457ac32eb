"""RF impairment models (reference commpy/impairments.py:20-42).

Counterpart of ``commpy_tpu/ops/impairments.py``.  The waveform may carry
arbitrary leading batch axes; the offset is applied along the trailing
(time) axis.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import on_device

__all__ = ["add_frequency_offset"]


def add_frequency_offset(waveform, Fs: float, delta_f: float,
                         device="cuda") -> torch.Tensor:
    """Apply the carrier frequency offset ``exp(j*2*pi*(delta_f/Fs)*n)``.

    The phase is ``float32(2*pi*delta_f/Fs) * n`` in float32, the
    product the JAX package forms.
    """
    w = on_device(waveform, device)
    n = torch.arange(w.shape[-1], device=w.device, dtype=torch.float32)
    theta = float(np.float32(2 * np.pi * (delta_f / Fs))) * n
    return w * torch.polar(torch.ones_like(theta), theta)
