"""Tensor operations: trellis, convolutional encoder, modem, channel,
scrambler, Viterbi decoder, and the LDPC family (dense, QC, DVB-S2, NR)."""
