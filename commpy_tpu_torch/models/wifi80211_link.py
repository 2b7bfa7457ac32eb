"""Batched 802.11 conv-coded link (IEEE 802.11-2020 section 17, OFDM PHY).

Counterpart of ``commpy_tpu/models/wifi80211_link.py``: the K=7 (133,171)
convolutional code, the standard puncturing patterns, Gray PSK/QAM by MCS,
complex AWGN, exact-LLR soft demapping and soft Viterbi decoding.  The
802.11n LDPC link is not ported yet.
"""
from __future__ import annotations

import numpy as np

from ..ops.trellis import Trellis
from .device_links import DeviceLink, make_conv_awgn_link

__all__ = ["wifi80211_device_link", "WIFI_MCS_TABLE"]

# mcs -> (constellation size, use_psk, (rate_num, rate_den))
WIFI_MCS_TABLE = {
    0: (2, True, (1, 2)),
    1: (4, True, (1, 2)),
    2: (4, True, (3, 4)),
    3: (16, False, (1, 2)),
    4: (16, False, (3, 4)),
    5: (64, False, (2, 3)),
    6: (64, False, (3, 4)),
    7: (64, False, (5, 6)),
    8: (256, False, (3, 4)),
    9: (256, False, (5, 6)),
}

_PUNCTURES = {
    (1, 2): None,
    (2, 3): [1, 1, 1, 0],
    (3, 4): [1, 1, 1, 0, 0, 1],
    (5, 6): [1, 1, 1, 0, 0, 1, 1, 0, 0, 1],
}


def wifi80211_device_link(mcs: int, frame_bits: int = 1200,
                          scramble_seed=None, device="cuda") -> DeviceLink:
    """Build the batched 802.11 link for an MCS index (0-9).

    ``frame_bits`` must make the punctured codeword fill whole modulation
    symbols (1200 works for every MCS).  ``scramble_seed`` (non-zero 7-bit
    int) enables the frame-synchronous data scrambler.
    """
    m, use_psk, coding = WIFI_MCS_TABLE[mcs]
    # (133,171) are OCTAL in the standard: 0o133 = 91, 0o171 = 121.  Read
    # as decimal they give a catastrophic code.
    trellis = Trellis(np.array([6]), np.array([[0o133, 0o171]]))
    return make_conv_awgn_link(
        trellis=trellis,
        modulation_m=m,
        frame_bits=frame_bits,
        decoding_type="soft",
        puncture=_PUNCTURES[coding],
        use_psk=use_psk,
        scramble_seed=scramble_seed,
        name=f"wifi80211-mcs{mcs}",
        device=device,
    )
