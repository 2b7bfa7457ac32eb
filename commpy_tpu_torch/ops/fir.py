"""FIR filtering and polyphase resampling on the device.

Counterpart of ``commpy_tpu/ops/fir.py``.  The reference only makes
taps (filters.py) and zero-inserts (utilities.py:157); this module is
the convolution engine the taps plug into:

* ``fir_filter``: batched FFT convolution at one FFT size,
  ``nfft = next_pow2(n + t - 1)``; a real signal with real taps runs on
  ``rfft``/``irfft`` in float32, anything complex on ``fft``/``ifft`` in
  complex64, as the JAX package does;
* ``upfirdn``: polyphase upsample -> FIR -> downsample.  The ``up``
  phases of the taps go through one batched FFT over a phase axis and
  the phase outputs interleave; the up-sampled signal is never formed;
* ``sharded_fir_filter``: causal filtering of a waveform split along time
  over the ranks of a mesh, with a (t-1)-sample halo from the left
  neighbour.
"""
from __future__ import annotations

import torch

from ..utils.device import on_device

__all__ = ["fir_filter", "upfirdn", "sharded_fir_filter", "pulse_shape"]


def _next_pow2(n):
    return 1 << (int(n) - 1).bit_length()


def _fft_conv(x, taps, out_len):
    """Full linear convolution of ``x [..., n]`` with ``taps [..., t]``
    (broadcast over the leading axes), first ``out_len`` samples."""
    nfft = _next_pow2(x.shape[-1] + taps.shape[-1] - 1)
    if x.is_complex() or taps.is_complex():
        X = torch.fft.fft(x.to(torch.complex64), nfft, dim=-1)
        H = torch.fft.fft(taps.to(torch.complex64), nfft, dim=-1)
        return torch.fft.ifft(X * H, dim=-1)[..., :out_len]
    X = torch.fft.rfft(x.to(torch.float32), nfft, dim=-1)
    H = torch.fft.rfft(taps.to(torch.float32), nfft, dim=-1)
    return torch.fft.irfft(X * H, nfft, dim=-1)[..., :out_len]


def fir_filter(x, taps, mode="full", device="cuda"):
    """Convolve along the last axis by FFT.

    x : ``[..., n]`` real or complex signal (moved to ``device``)
    taps : ``[t]`` FIR taps
    mode : 'full' (length n+t-1, as np.convolve) or 'same' (length n).
    """
    x = on_device(x, device)
    taps = on_device(taps, x.device)
    n = x.shape[-1]
    t = taps.shape[0]
    y = _fft_conv(x, taps, n + t - 1)
    if mode == "same":
        start = (t - 1) // 2
        return y[..., start:start + n]
    return y


def upfirdn(x, taps, up: int = 1, down: int = 1, device="cuda"):
    """Polyphase upsample-by-``up``, filter, downsample-by-``down``.

    ``scipy.signal.upfirdn`` semantics: output length
    ``ceil(((n-1)*up + t) / down)``.  Zero insertion followed by
    convolution is, phase by phase, a convolution of ``x`` with the
    phase's taps: ``conv(upsample(x), h)[j*up + p] = conv(x, h[p::up])[j]``.
    """
    x = on_device(x, device)
    taps = on_device(taps, x.device)
    t = taps.shape[0]
    n = x.shape[-1]
    if up == 1:
        y = fir_filter(x, taps, "full", device=x.device)
    else:
        pad = (-t) % up
        taps_pad = torch.cat([taps, taps.new_zeros(pad)])
        poly = taps_pad.reshape(-1, up).T  # [up, t_phase]
        t_phase = poly.shape[1]
        # one batched FFT over the phase axis: [..., up, n + t_phase - 1]
        outs = _fft_conv(x.unsqueeze(-2), poly, n + t_phase - 1)
        y = outs.movedim(-2, -1).reshape(
            x.shape[:-1] + (up * (n + t_phase - 1),))
        y = y[..., :(n - 1) * up + t]
    if down > 1:
        y = y[..., ::down]
    return y


def pulse_shape(symbols, taps, sps: int, device="cuda"):
    """Transmit pulse shaping: upsample by ``sps`` and filter (polyphase)."""
    return upfirdn(symbols, taps, up=sps, device=device)


def sharded_fir_filter(x_local, taps, mesh, axis_name: str = "sp"):
    """Causal FIR over a time-sharded waveform with a halo exchange (SPMD).

    x_local : ``[n_local]`` this rank's shard of the waveform, on the
        mesh's device type; n_local >= t - 1.
    Each rank convolves its shard plus the last (t-1) samples of its left
    neighbour, received by a ring shift (zeros on rank 0): the
    overlap-save boundary exchange; nothing gathers the whole signal.

    Returns this rank's shard of ``y[i] = sum_k h[k] x[i-k]``, so the
    shards together are ``fir_filter(x, taps, 'full')[:n]``.
    """
    from ..parallel.mesh import axis_index, check_axis, ppermute

    check_axis(mesh, axis_name)
    x = on_device(x_local, mesh.device_type)
    taps = on_device(taps, x.device)
    t, n = taps.shape[0], x.shape[-1]
    if t - 1 > n:
        raise ValueError(f"{t} taps need shards of at least {t - 1} samples")
    halo = ppermute(x[n - (t - 1):], mesh, 1)
    if axis_index(mesh) == 0:
        halo = torch.zeros_like(halo)
    y = fir_filter(torch.cat([halo, x]), taps, "full", device=x.device)
    # the samples whose window lies wholly inside the extended shard
    return y[t - 1:t - 1 + n]
