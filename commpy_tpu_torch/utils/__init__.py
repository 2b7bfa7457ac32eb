"""Bit helpers, device resolution, distance and power measures, and
small float32 matrix products."""
from . import measures
from .bits import np_pack_bits, np_unpack_bits, pack_bits, unpack_bits
from .device import device_constant, resolve_device
from .linalg import small_matmul
from .measures import euclid_dist, hamming_dist, signal_power, upsample

__all__ = ["pack_bits", "unpack_bits", "np_pack_bits", "np_unpack_bits",
           "hamming_dist", "euclid_dist", "upsample", "signal_power",
           "measures", "resolve_device", "device_constant", "small_matmul"]
