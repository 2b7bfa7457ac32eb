"""Tensor operations: trellis, convolutional encoder, modem, channel,
scrambler, Viterbi decoder, the LDPC family (dense, QC, DVB-S2, NR),
interleavers and turbo codes."""
from . import interleave, turbo

__all__ = ["interleave", "turbo"]
