"""Tensor operations: trellis, convolutional encoder, modem, channel,
scrambler, Viterbi decoder, the LDPC family (dense, QC, DVB-S2, NR),
interleavers and turbo codes."""
from . import (
    channel,
    convcode,
    dvbs2,
    interleave,
    ldpc,
    modem,
    nrldpc,
    qcldpc,
    scramble,
    trellis,
    turbo,
    viterbi,
)
from .trellis import Trellis
from .viterbi import viterbi_decode, viterbi_decode_device

__all__ = [
    "channel", "convcode", "dvbs2", "interleave", "ldpc", "modem", "nrldpc",
    "qcldpc", "scramble", "trellis", "turbo", "viterbi", "Trellis",
    "viterbi_decode", "viterbi_decode_device",
]
