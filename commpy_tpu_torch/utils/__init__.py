"""Bit helpers and device resolution."""
from .bits import np_pack_bits, np_unpack_bits, pack_bits, unpack_bits
from .device import device_constant, resolve_device

__all__ = ["pack_bits", "unpack_bits", "np_pack_bits", "np_unpack_bits",
           "resolve_device", "device_constant"]
