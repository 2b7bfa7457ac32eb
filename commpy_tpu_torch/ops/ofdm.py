"""OFDM modulation / demodulation and delay-subspace channel estimation.

Counterpart of ``commpy_tpu/ops/ofdm.py`` (reference
commpy/modulation.py:265-296, integer arithmetic throughout) with the
reference's subcarrier map:

* tx: freq[0] = 0 (DC null); freq[1 : nsc/2+1] = symbols[nsc/2 :];
  freq[-nsc/2 :] = symbols[: nsc/2]; IFFT; cyclic prefix prepended.
* rx: strip CP, FFT, inverse mapping.

One batched (I)FFT over ``[..., n_sym, nfft]``; ``torch.fft`` with its
default ``norm="backward"`` (1/N on the inverse) matches ``jnp.fft``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant, on_device
from ..utils.linalg import small_matmul

__all__ = [
    "ofdm_tx",
    "ofdm_rx",
    "subcarrier_bins",
    "delay_subspace_matrix",
    "make_comb_estimator",
]


def ofdm_tx(x, nfft: int, nsc: int, cp_length: int,
            device="cuda") -> torch.Tensor:
    """OFDM transmit signal generation.

    x : complex ``[..., nsc, n_sym]`` symbols, one OFDM symbol per
        trailing column (reference layout); nsc must be even.

    Returns complex64 ``[..., n_sym * (nfft + cp_length)]``.
    """
    x = on_device(x, device).to(torch.complex64)
    lead = tuple(x.shape[:-2])
    n_sym = x.shape[-1]
    half = nsc // 2

    sym = x.movedim(-1, -2)  # [..., n_sym, nsc]
    freq = torch.zeros(lead + (n_sym, nfft), dtype=torch.complex64,
                       device=x.device)
    freq[..., 1:half + 1] = sym[..., half:]
    freq[..., nfft - half:] = sym[..., :half]

    time = torch.fft.ifft(freq, dim=-1)
    cp = time[..., nfft - cp_length:]
    out = torch.cat((cp, time), dim=-1)  # [..., n_sym, cp+nfft]
    return out.reshape(lead + (n_sym * (nfft + cp_length),))


def ofdm_rx(y, nfft: int, nsc: int, cp_length: int,
            device="cuda") -> torch.Tensor:
    """OFDM receive processing, the inverse of :func:`ofdm_tx`.

    Returns complex ``[..., nsc, n_sym]`` (reference layout).
    """
    y = on_device(y, device)
    lead = tuple(y.shape[:-1])
    n_sym = y.shape[-1] // (nfft + cp_length)
    half = nsc // 2

    blocks = y[..., :n_sym * (nfft + cp_length)].reshape(
        lead + (n_sym, nfft + cp_length))
    time = blocks[..., cp_length:]
    freq = torch.fft.fft(time, dim=-1)
    sym = torch.cat((freq[..., nfft - half:], freq[..., 1:half + 1]),
                    dim=-1)  # [..., n_sym, nsc]
    return sym.movedim(-1, -2)


# ---------------------------------------------------------------------------
# Channel estimation (beyond the reference, whose OFDM stops at the FFT
# mapping)
# ---------------------------------------------------------------------------

def subcarrier_bins(nfft: int, nsc: int) -> np.ndarray:
    """FFT bin index per subcarrier slot of the :func:`ofdm_tx` map.

    Slots ``[0, nsc/2)`` ride the negative-frequency bins
    ``nfft-nsc/2 .. nfft-1``; slots ``[nsc/2, nsc)`` the positive bins
    ``1 .. nsc/2`` (DC is never loaded).
    """
    half = nsc // 2
    return np.concatenate(
        [np.arange(nfft - half, nfft), np.arange(1, half + 1)]
    )


def _dft_columns(nfft: int, bins: np.ndarray, n_taps: int) -> np.ndarray:
    return np.exp(
        -2j * np.pi * bins[:, None] * np.arange(n_taps)[None, :] / nfft
    ).astype(np.complex64)


def delay_subspace_matrix(nfft: int, nsc: int, n_taps: int,
                          reg: float = 1e-4) -> np.ndarray:
    """Smoothing matrix S projecting an LS estimate onto the delay subspace.

    A channel of ``n_taps`` taps lives in the column space of the per-slot
    DFT matrix ``W`` (``H = W g``); ``S = W (W^H W + reg I)^-1 W^H``
    (``[nsc, nsc]``, on the host) removes the LS noise outside it, so
    ``H_ls @ S.T`` divides the estimator noise by ~``nsc / n_taps``.
    """
    w = _dft_columns(nfft, subcarrier_bins(nfft, nsc), n_taps)
    gram = w.conj().T @ w + reg * np.eye(n_taps, dtype=np.complex64)
    return (w @ np.linalg.solve(gram, w.conj().T)).astype(np.complex64)


def make_comb_estimator(nfft: int, nsc: int, pilot_slots, n_taps: int,
                        reg: float = 1e-4, device="cuda"):
    """Comb-pilot channel estimator: pilot-slot LS -> all-slot estimate.

    With the delay-subspace model the full response is least squares in
    the taps: ``h_full = W (W_p^H W_p + reg I)^-1 W_p^H h_p``, one
    ``[nsc, P]`` matrix made on the host.  Exact for any ``n_taps``-tap
    channel when ``P >= n_taps``.

    Returns ``estimate(h_pilot_ls)`` mapping ``[..., P] -> [..., nsc]`` on
    ``device``.
    """
    pilot_slots = np.asarray(pilot_slots, np.int64)
    w_full = _dft_columns(nfft, subcarrier_bins(nfft, nsc), n_taps)
    w_p = w_full[pilot_slots]
    gram = w_p.conj().T @ w_p + reg * np.eye(n_taps, dtype=np.complex64)
    a_t = np.ascontiguousarray(
        (w_full @ np.linalg.solve(gram, w_p.conj().T)).astype(
            np.complex64).T)  # [P, nsc]

    def estimate(h_pilot_ls):
        h = on_device(h_pilot_ls, device).to(torch.complex64)
        a = device_constant(a_t, h.device)
        return small_matmul(h[..., None, :], a)[..., 0, :]

    return estimate
