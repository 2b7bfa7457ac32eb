"""Reference-compatible impairments module (commpy.impairments API)."""
from __future__ import annotations

import numpy as np

from .ops.impairments import add_frequency_offset as _afo_device

__all__ = ["add_frequency_offset"]


def add_frequency_offset(waveform, Fs, delta_f, *, device="cuda"):
    """Apply a carrier frequency offset on ``device``; NumPy in and out."""
    return _afo_device(np.asarray(waveform), Fs, delta_f,
                       device).cpu().numpy()
