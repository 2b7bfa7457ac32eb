"""Reference-compatible channels module (commpy.channels API).

Counterpart of ``commpy_tpu/channels.py``: ``SISOFlatChannel`` and
``MIMOFlatChannel`` keep the reference's stateful surface (``noises``,
``channel_gains``, ``unnoisy_output``, the fading-parameter invariants
and the SNR setters; reference commpy/channels.py:30-627), NumPy in and
out, while the draws and the channel run through
:mod:`commpy_tpu_torch.ops.channel` on ``device`` (keyword-only, default
``"cuda"``).

Each draw takes a fresh ``torch.Generator`` seeded from NumPy's global
RNG, ``np.random.randint(0, 2**31 - 1)``, so ``np.random.seed`` keeps
runs reproducible.  The legacy ``bec``, ``bsc`` and ``awgn`` draw the
same way.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import channel as _ch
from .utils.device import resolve_device

__all__ = ["SISOFlatChannel", "MIMOFlatChannel", "bec", "bsc", "awgn"]


def _fresh_generator(device):
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.randint(0, 2**31 - 1)))
    return gen


def _host(x):
    return x.cpu().numpy()


class _FlatChannel(object):
    def __init__(self, device):
        self.device = resolve_device(device)
        self.noises = None
        self.channel_gains = None
        self.unnoisy_output = None

    def generate_noises(self, dims):
        """Sample and store white Gaussian noise (channels.py:37-55)."""
        assert self.noise_std is not None, (
            "Noise standard deviation must be set before propagation."
        )
        gen = _fresh_generator(self.device)
        dims = tuple(np.atleast_1d(dims))
        if self.isComplex:
            noises = _ch.crandn(gen, dims, self.device) * float(
                self.noise_std * 0.5)
        else:
            noises = torch.randn(dims, generator=gen,
                                 device=self.device) * float(self.noise_std)
        self.noises = _host(noises)

    def set_SNR_dB(self, SNR_dB, code_rate: float = 1.0, Es=1):
        """Set noise std from SNR in dB (channels.py:57-74)."""
        self.noise_std = np.sqrt(
            (self.isComplex + 1) * self.nb_tx * Es
            / (code_rate * 10 ** (SNR_dB / 10))
        )

    def set_SNR_lin(self, SNR_lin, code_rate=1, Es=1):
        """Set noise std from linear SNR (channels.py:76-93)."""
        self.noise_std = np.sqrt(
            (self.isComplex + 1) * self.nb_tx * Es / (code_rate * SNR_lin)
        )

    @property
    def isComplex(self):
        return self._isComplex


class SISOFlatChannel(_FlatChannel):
    """SISO flat-fading channel (reference channels.py:101-239)."""

    @property
    def nb_tx(self):
        return 1

    @property
    def nb_rx(self):
        return 1

    def __init__(self, noise_std=None, fading_param=(1, 0), *,
                 device="cuda"):
        super().__init__(device)
        self.noise_std = noise_std
        self.fading_param = fading_param

    def propagate(self, msg):
        msg = np.asarray(msg)
        if isinstance(msg[0], complex) and not self.isComplex:
            raise TypeError(
                "Trying to propagate a complex message in a real channel."
            )
        assert self.noise_std is not None, (
            "Noise standard deviation must be set before propagation."
        )
        out, gains, noises = _ch.siso_propagate(
            _fresh_generator(self.device), msg, self.noise_std,
            self.fading_param, self.isComplex, self.device)
        self.channel_gains = _host(gains)
        self.noises = _host(noises)
        self.unnoisy_output = self.channel_gains * msg
        return _host(out)

    @property
    def fading_param(self):
        return self._fading_param

    @fading_param.setter
    def fading_param(self, fading_param):
        if fading_param[1] + np.absolute(fading_param[0]) ** 2 != 1:
            raise ValueError(
                "fading_param does not conserve energy: |LOS|^2 + NLOS "
                "power must equal 1 (SISO) / nb_tx*nb_rx (MIMO)"
            )
        self._fading_param = fading_param
        self._isComplex = isinstance(fading_param[0], complex)

    @property
    def k_factor(self):
        return (
            np.absolute(self.fading_param[0]) ** 2
            / np.absolute(self.fading_param[1])
        )


class MIMOFlatChannel(_FlatChannel):
    """Kronecker-model MIMO flat-fading channel (channels.py:242-627)."""

    def __init__(self, nb_tx, nb_rx, noise_std=None, fading_param=None, *,
                 device="cuda"):
        super().__init__(device)
        self.nb_tx = nb_tx
        self.nb_rx = nb_rx
        self.noise_std = noise_std
        if fading_param is None:
            self.fading_param = (
                np.zeros((nb_rx, nb_tx)),
                np.identity(nb_tx),
                np.identity(nb_rx),
            )
        else:
            self.fading_param = fading_param

    def propagate(self, msg):
        msg = np.asarray(msg)
        if isinstance(msg[0], complex) and not self.isComplex:
            raise TypeError(
                "Trying to propagate a complex message in a real channel."
            )
        assert self.noise_std is not None, (
            "Noise standard deviation must be set before propagation."
        )
        nb_vect, mod = divmod(len(msg), self.nb_tx)
        if mod:
            msg = np.hstack((msg, np.zeros(self.nb_tx - mod)))
            nb_vect += 1
        msg = msg.reshape(nb_vect, -1)

        mean, srt, srr = _ch.kronecker_sqrt_factors(self.fading_param)
        out, gains, noises = _ch.mimo_propagate(
            _fresh_generator(self.device), msg, self.noise_std, mean, srt,
            srr, self.isComplex, self.device)
        self.channel_gains = _host(gains)
        self.noises = _host(noises)
        self.unnoisy_output = np.einsum("ijk,ik->ij", self.channel_gains, msg)
        return _host(out)

    def _update_corr_KBSM(self, betat, betar):
        """KBSM-BD-AA correlation correction (channels.py:385-412)."""
        if betar < 0 or betat < 0:
            raise ValueError("KBSM beta factors must be non-negative")

        def kbsm(n_ant, beta):
            # elementwise exp(-beta |m - n|) taper on the antenna grid
            idx = np.arange(n_ant)
            return np.exp(-beta * np.abs(idx[None, :] - idx[:, None]))

        self.fading_param = (
            self.fading_param[0],
            self.fading_param[1] * kbsm(self.nb_tx, betat),
            self.fading_param[2] * kbsm(self.nb_rx, betar),
        )

    def specular_compo(self, thetat, dt, thetar, dr):
        """Specular (LOS) steering matrix (channels.py:414-453)."""
        if dr < 0 or dt < 0:
            raise ValueError("antenna spacings dt/dr must be non-negative")
        n = np.arange(self.nb_rx)[:, None]
        m = np.arange(self.nb_tx)[None, :]
        return np.exp(
            1j * 2 * np.pi * (n * dr * np.cos(thetar) + m * dt * np.cos(thetat))
        )

    @property
    def fading_param(self):
        return self._fading_param

    @fading_param.setter
    def fading_param(self, fading_param):
        NLOS_gain = np.trace(np.kron(fading_param[1].T, fading_param[2]))
        LOS_gain = np.einsum(
            "ij,ij->",
            np.absolute(fading_param[0]),
            np.absolute(fading_param[0]),
        )
        if np.absolute(NLOS_gain + LOS_gain - self.nb_tx * self.nb_rx) > 1e-3:
            raise ValueError(
                "fading_param does not conserve energy: |LOS|^2 + NLOS "
                "power must equal 1 (SISO) / nb_tx*nb_rx (MIMO)"
            )
        self._fading_param = fading_param
        self._isComplex = isinstance(fading_param[0][0, 0], complex)

    @property
    def k_factor(self):
        NLOS_gain = np.trace(
            np.kron(self.fading_param[1].T, self.fading_param[2])
        )
        LOS_gain = np.einsum(
            "ij,ij->",
            np.absolute(self.fading_param[0]),
            np.absolute(self.fading_param[0]),
        )
        return LOS_gain / NLOS_gain

    def uncorr_rayleigh_fading(self, dtype):
        """Uncorrelated Rayleigh fading (channels.py:477-485)."""
        self.fading_param = (
            np.zeros((self.nb_rx, self.nb_tx), dtype),
            np.identity(self.nb_tx),
            np.identity(self.nb_rx),
        )

    def expo_corr_rayleigh_fading(self, t, r, betat=0, betar=0):
        """Loyka exponential-correlation Rayleigh (channels.py:487-540)."""
        if abs(t) - 1 > 1e-4:
            raise ValueError("|t| must equal 1 (unit-modulus correlation "
                             "coefficient)")
        if abs(r) - 1 > 1e-4:
            raise ValueError("|r| must equal 1 (unit-modulus correlation "
                             "coefficient)")
        expo_tx = (
            np.arange(self.nb_tx)[None, :] - np.arange(self.nb_tx)[:, None]
        )
        expo_rx = (
            np.arange(self.nb_rx)[None, :] - np.arange(self.nb_rx)[:, None]
        )
        self.fading_param = (
            np.zeros((self.nb_rx, self.nb_tx), complex),
            t ** expo_tx,
            r ** expo_rx,
        )
        self._update_corr_KBSM(betat, betar)

    def uncorr_rician_fading(self, mean, k_factor):
        """Uncorrelated Rician fading (channels.py:542-558)."""
        nb_antennas = mean.size
        NLOS_gain = nb_antennas / (k_factor + 1)
        mean = mean * np.sqrt(
            k_factor * NLOS_gain
            / np.einsum("ij,ij->", np.absolute(mean), np.absolute(mean))
        )
        self.fading_param = (
            mean,
            np.identity(self.nb_tx) * NLOS_gain / nb_antennas,
            np.identity(self.nb_rx),
        )

    def expo_corr_rician_fading(self, mean, k_factor, t, r, betat=0, betar=0):
        """Exponential-correlation Rician fading (channels.py:560-627)."""
        if abs(t) - 1 > 1e-4:
            raise ValueError("|t| must equal 1 (unit-modulus correlation "
                             "coefficient)")
        if abs(r) - 1 > 1e-4:
            raise ValueError("|r| must equal 1 (unit-modulus correlation "
                             "coefficient)")
        nb_antennas = mean.size
        NLOS_gain = nb_antennas / (k_factor + 1)
        mean = mean * np.sqrt(
            k_factor * NLOS_gain
            / np.einsum("ij,ij->", np.absolute(mean), np.absolute(mean))
        )
        expo_tx = (
            np.arange(self.nb_tx)[None, :] - np.arange(self.nb_tx)[:, None]
        )
        expo_rx = (
            np.arange(self.nb_rx)[None, :] - np.arange(self.nb_rx)[:, None]
        )
        self.fading_param = (
            mean,
            t ** expo_tx * NLOS_gain / nb_antennas,
            r ** expo_rx,
        )
        self._update_corr_KBSM(betat, betar)


def bec(input_bits, p_e, *, device="cuda"):
    """Binary erasure channel (channels.py:630-649): erased bits are -1."""
    dev = resolve_device(device)
    bits = np.asarray(input_bits)
    return _host(_ch.bec(_fresh_generator(dev), bits, p_e, dev))


def bsc(input_bits, p_t, *, device="cuda"):
    """Binary symmetric channel (channels.py:652-672)."""
    dev = resolve_device(device)
    bits = np.asarray(input_bits)
    return _host(_ch.bsc(_fresh_generator(dev), bits, p_t, dev))


def awgn(input_signal, snr_dB, rate=1.0, *, device="cuda"):
    """Legacy AWGN channel (channels.py:675-708), measuring the input's
    average energy."""
    dev = resolve_device(device)
    return _host(_ch.awgn(np.asarray(input_signal), snr_dB, rate,
                          _fresh_generator(dev), dev))
