"""Reference-compatible modulation module (commpy.modulation API).

Counterpart of ``commpy_tpu/modulation.py``: ``Modem`` / ``PSKModem`` /
``QAMModem`` keep the reference class surface (commpy/modulation.py:
39-262), NumPy in and out, and compute with
:mod:`commpy_tpu_torch.ops.modem` on ``device`` (keyword-only, default
``"cuda"``).  OFDM and the MIMO detectors come from their ops modules.
"""
from __future__ import annotations

import numpy as np

from .ops import modem as _m
from .ops.mimo import (
    best_first_detector,
    bit_lvl_repr,
    kbest,
    max_log_approx,
    mimo_ml,
)
from .ops.ofdm import ofdm_rx as _ofdm_rx_device
from .ops.ofdm import ofdm_tx as _ofdm_tx_device
from .utils.device import on_device, resolve_device

__all__ = [
    "Modem",
    "PSKModem",
    "QAMModem",
    "ofdm_tx",
    "ofdm_rx",
    "mimo_ml",
    "kbest",
    "best_first_detector",
    "bit_lvl_repr",
    "max_log_approx",
]


class Modem:
    """Custom-constellation modem (reference modulation.py:39-172)."""

    def __init__(self, constellation, reorder_as_gray=True, *,
                 device="cuda"):
        self.device = resolve_device(device)
        if reorder_as_gray:
            self.constellation = _m.gray_reorder(np.asarray(constellation))
        else:
            self.constellation = constellation

    def modulate(self, input_bits):
        """Map bits to symbols (a batched gather on the device)."""
        bits = np.asarray(input_bits)
        n = (bits.size // self.num_bits_symbol) * self.num_bits_symbol
        return _m.modulate(bits[:n], self._constellation,
                           self.num_bits_symbol, self.device).cpu().numpy()

    def demodulate(self, input_symbols, demod_type, noise_var=0):
        """Hard (min-distance) or soft (exact LLR) demapping."""
        symbols = on_device(np.atleast_1d(np.asarray(input_symbols)),
                            self.device)
        if demod_type == "hard":
            out = _m.demodulate_hard(symbols, self._constellation,
                                     self.num_bits_symbol)
            return out.cpu().numpy().astype(np.int8)
        elif demod_type == "soft":
            out = _m.demodulate_soft(symbols, self._constellation,
                                     self.num_bits_symbol, noise_var)
            return out.cpu().numpy().astype(float)
        raise ValueError('demod_type must be "hard" or "soft"')

    def plot_constellation(self):
        import matplotlib.pyplot as plt

        plt.scatter(self.constellation.real, self.constellation.imag)
        for symb in self.constellation:
            plt.text(symb.real + 0.2, symb.imag, self.demodulate(symb, "hard"))
        plt.title("Constellation")
        plt.grid()
        plt.show()

    @property
    def constellation(self):
        return self._constellation

    @constellation.setter
    def constellation(self, value):
        num_bits_symbol = np.log2(len(value))
        if num_bits_symbol != int(num_bits_symbol):
            raise ValueError("Constellation length must be a power of 2.")
        self._constellation = np.array(value)
        self.Es = float(np.mean(np.abs(self._constellation) ** 2))
        self.m = self._constellation.size
        self.num_bits_symbol = int(num_bits_symbol)


class PSKModem(Modem):
    """m-PSK modem (reference modulation.py:175-211)."""

    def __init__(self, m, *, device="cuda"):
        num_bits_symbol = np.log2(m)
        if num_bits_symbol != int(num_bits_symbol):
            raise ValueError("Constellation length must be a power of 2.")
        super().__init__(
            np.exp(1j * np.arange(0, 2 * np.pi, 2 * np.pi / m)),
            device=device)


class QAMModem(Modem):
    """Square m-QAM modem (reference modulation.py:213-262)."""

    def __init__(self, m, *, device="cuda"):
        num_symb_pam = np.sqrt(m)
        if num_symb_pam != int(num_symb_pam):
            raise ValueError("m must lead to a square QAM.")
        num_symb_pam = int(num_symb_pam)
        pam = np.arange(-num_symb_pam + 1, num_symb_pam, 2)
        constellation = (
            np.tile(np.hstack((pam, pam[::-1])), num_symb_pam // 2) * 1j
            + pam.repeat(num_symb_pam)
        )
        super().__init__(constellation, device=device)


def ofdm_tx(x, nfft, nsc, cp_length, *, device="cuda"):
    """OFDM transmit (reference modulation.py:265-282; int-index fixed)."""
    return _ofdm_tx_device(np.asarray(x), int(nfft), int(nsc),
                           int(cp_length), device).cpu().numpy()


def ofdm_rx(y, nfft, nsc, cp_length, *, device="cuda"):
    """OFDM receive (reference modulation.py:285-296; int-index fixed)."""
    return _ofdm_rx_device(np.asarray(y), int(nfft), int(nsc),
                           int(cp_length), device).cpu().numpy()
