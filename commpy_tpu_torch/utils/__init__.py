"""Bit helpers, device resolution, distance and power measures, small
float32 matrix products, and profiling helpers."""
from . import measures, profiling
from .bits import np_pack_bits, np_unpack_bits, pack_bits, unpack_bits
from .device import device_constant, resolve_device
from .linalg import small_matmul
from .measures import euclid_dist, hamming_dist, signal_power, upsample

__all__ = ["pack_bits", "unpack_bits", "np_pack_bits", "np_unpack_bits",
           "hamming_dist", "euclid_dist", "upsample", "signal_power",
           "measures", "profiling", "resolve_device", "device_constant",
           "small_matmul"]
