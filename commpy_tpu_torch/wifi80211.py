"""802.11 PHY link simulation (commpy.wifi80211 API).

Counterpart of ``commpy_tpu/wifi80211.py``: the K=7 (133,171) conv
code, the standard puncturing and the MCS modem table wired into a
:class:`~commpy_tpu_torch.links.LinkModel` (reference
commpy/wifi80211.py:29-216).  Encoding, mapping, demapping and the
Viterbi decode (the kernels K1 and K2 on the card) run on ``device``;
the chunk loop is the reference's, on the host.  The batched link of the
same PHY is :mod:`commpy_tpu_torch.models.wifi80211_link`.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np

from . import links as lk
from . import modulation as mod
from .channelcoding import convcode as cc
from .utils.device import resolve_device

__all__ = ["Wifi80211"]


class Wifi80211:
    """802.11 (up to VHT/ac) PHY simulation by MCS index."""

    memory = np.array(6, ndmin=1)
    # A deliberate difference from reference wifi80211.py:49, which passes
    # the standard's octal constants (133,171)_8 as decimal integers; the
    # Trellis reads its entries as plain integers, so decimal 133 keeps
    # only its low 7 bits, both generators get even tap weight, (1+D)
    # divides both and the code is catastrophic.  These are the IEEE
    # 802.11 generators 0o133/0o171 = (91, 121), as in the JAX package.
    generator_matrix = np.array((0o133, 0o171), ndmin=2)

    def get_modem(self) -> mod.Modem:
        bits_per_symbol = [2, 4, 4, 16, 16, 64, 64, 64, 256, 256]
        if self.mcs <= 2:
            return mod.PSKModem(bits_per_symbol[self.mcs], device=self.device)
        return mod.QAMModem(bits_per_symbol[self.mcs], device=self.device)

    @staticmethod
    def _get_puncture_matrix(numerator: int, denominator: int) -> List:
        if numerator == 1 and denominator == 2:
            return None
        if numerator == 2 and denominator == 3:
            return [1, 1, 1, 0]
        if numerator == 3 and denominator == 4:
            return [1, 1, 1, 0, 0, 1]
        if numerator == 5 and denominator == 6:
            return [1, 1, 1, 0, 0, 1, 1, 0, 0, 1]
        return None

    def _get_coding(self):
        coding = [
            (1, 2), (1, 2), (3, 4), (1, 2), (3, 4),
            (2, 3), (3, 4), (5, 6), (3, 4), (5, 6),
        ]
        return coding[self.mcs]

    @staticmethod
    def _get_trellis():
        return cc.Trellis(Wifi80211.memory, Wifi80211.generator_matrix)

    def __init__(self, mcs: int, *, device="cuda"):
        self.mcs = mcs
        self.modem = None
        self.device = resolve_device(device)

    def link_performance(self, channel, SNRs, tx_max, err_min,
                         send_chunk=None, frame_aggregation=1, receiver=None,
                         stop_on_surpass_error=True):
        """Monte-Carlo BER estimate for this MCS (wifi80211.py:132-216)."""
        trellis1 = Wifi80211._get_trellis()
        coding = self._get_coding()
        modem = self.get_modem()
        dev = self.device

        def modulate(bits):
            res = cc.conv_encode(bits, trellis1, "cont", device=dev)
            puncture_matrix = Wifi80211._get_puncture_matrix(
                coding[0], coding[1]
            )
            res_p = res
            if puncture_matrix:
                res_p = cc.puncturing(res, puncture_matrix)
            return modem.modulate(res_p)

        def _receiver(y, h, constellation, noise_var):
            return modem.demodulate(y, "soft", noise_var)

        if not receiver:
            receiver = _receiver

        def decoder_soft(msg):
            msg_d = msg
            puncture_matrix = Wifi80211._get_puncture_matrix(
                coding[0], coding[1]
            )
            if puncture_matrix:
                msg_d = cc.depuncturing(
                    msg,
                    puncture_matrix,
                    math.ceil(len(msg) * coding[0] / coding[1] * 2),
                )
            return cc.viterbi_decode(msg_d, trellis1, decoding_type="soft",
                                     device=dev)

        self.model = lk.LinkModel(
            modulate,
            channel,
            receiver,
            modem.num_bits_symbol,
            modem.constellation,
            modem.Es,
            decoder_soft,
            coding[0] / coding[1],
            device=dev,
        )
        return self.model.link_performance_full_metrics(
            SNRs,
            tx_max,
            err_min=err_min,
            send_chunk=send_chunk,
            code_rate=coding[0] / coding[1],
            number_chunks_per_send=frame_aggregation,
            stop_on_surpass_error=stop_on_surpass_error,
        )
