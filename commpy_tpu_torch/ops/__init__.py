"""Tensor operations: trellis, convolutional encoder, modem, channel,
scrambler, Viterbi decoder, the LDPC family (dense, QC, DVB-S2, NR),
interleavers, turbo codes, MIMO detection, OFDM, synchronization and RF
impairments."""
from . import (
    channel,
    convcode,
    dvbs2,
    impairments,
    interleave,
    ldpc,
    mimo,
    modem,
    nrldpc,
    ofdm,
    qcldpc,
    scramble,
    sync,
    trellis,
    turbo,
    viterbi,
)
from .trellis import Trellis
from .viterbi import viterbi_decode, viterbi_decode_device

__all__ = [
    "channel", "convcode", "dvbs2", "impairments", "interleave", "ldpc",
    "mimo", "modem", "nrldpc", "ofdm", "qcldpc", "scramble", "sync",
    "trellis", "turbo", "viterbi", "Trellis", "viterbi_decode",
    "viterbi_decode_device",
]
