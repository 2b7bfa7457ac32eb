"""Tensor operations of the conv-coded link: trellis, encoder, modem,
channel, scrambler and Viterbi decoder."""
