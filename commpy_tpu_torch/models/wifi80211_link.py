"""Batched 802.11 conv-coded link (IEEE 802.11-2020 section 17, OFDM PHY).

Counterpart of ``commpy_tpu/models/wifi80211_link.py``: the K=7 (133,171)
convolutional code, the standard puncturing patterns, Gray PSK/QAM by MCS,
complex AWGN, exact-LLR soft demapping and soft Viterbi decoding; and
the 802.11n LDPC PHY link (Annex R rate-1/2 code, Gray QAM, min-sum BP).
"""
from __future__ import annotations

import numpy as np

from ..ops.trellis import Trellis
from ..ops.qcldpc import ieee80211n_params
from .device_links import (DeviceLink, make_conv_awgn_link,
                           make_qcldpc_awgn_link)

__all__ = ["wifi80211_device_link", "wifi80211n_ldpc_link",
           "WIFI_MCS_TABLE"]

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
    symbols: the 2 * ``frame_bits`` coded bits that the MCS's puncturing
    pattern keeps must be a multiple of log2(M), else ``ValueError``.
    1200 fits every MCS but 6 (64-QAM at rate 3/4: 1600 coded bits, not
    a whole number of 6-bit symbols); 3600 fits all ten.
    ``scramble_seed`` (non-zero 7-bit int) enables the frame-synchronous
    data scrambler.
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


def wifi80211n_ldpc_link(n: int = 1944, modulation_m: int = 4,
                         n_iterations: int = 15, msa_scale: float = 1.0,
                         msa_offset: float = 0.0,
                         device="cuda") -> DeviceLink:
    """802.11n LDPC PHY link: the Annex R rate-1/2 code (n in {648, 1296,
    1944}) with Gray QAM (BPSK for ``modulation_m=2``), one codeword per
    frame, min-sum BP with ``n_iterations`` flooding iterations (the
    resident kernel K4 on the card)."""
    return make_qcldpc_awgn_link(
        qc_params=ieee80211n_params(n, "1/2"),
        modulation_m=modulation_m,
        algorithm="MSA",
        n_iterations=n_iterations,
        msa_scale=msa_scale,
        msa_offset=msa_offset,
        use_psk=(modulation_m == 2),
        name=f"wifi80211n-ldpc{n}-qam{modulation_m}",
        device=device,
    )
