"""Tensor operations: trellis, convolutional encoder, modem, channel,
scrambler, Viterbi decoder, the LDPC family (dense, QC, DVB-S2, NR),
interleavers, turbo codes, MIMO detection, OFDM, synchronization, RF
impairments, single-carrier DSP (filters, sequences, FIR, equalizers) and
the algebraic codes (GF(2^m), BCH, RS, CRC, turbo product codes),
polar codes and the sequence-parallel stream decoders."""
from . import (
    algebraic,
    bch,
    channel,
    convcode,
    crc,
    dvbs2,
    equalize,
    filters,
    fir,
    galois,
    gf2m,
    impairments,
    interleave,
    ldpc,
    mimo,
    modem,
    nrldpc,
    ofdm,
    polar,
    qcldpc,
    rs,
    scramble,
    sequences,
    stream,
    sync,
    tpc,
    trellis,
    turbo,
    viterbi,
)
from .trellis import Trellis
from .viterbi import viterbi_decode, viterbi_decode_device

__all__ = [
    "algebraic", "bch", "channel", "convcode", "crc", "dvbs2", "equalize",
    "filters", "fir", "galois", "gf2m", "impairments", "interleave", "ldpc",
    "mimo", "modem", "nrldpc", "ofdm", "polar", "qcldpc", "rs", "scramble",
    "sequences", "stream", "sync", "tpc", "trellis", "turbo", "viterbi",
    "Trellis", "viterbi_decode", "viterbi_decode_device",
]
