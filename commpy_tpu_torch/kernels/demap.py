"""The joint soft demapper on the card (K6).

K6 replaces no TPU kernel: the JAX package leaves the demapper to XLA
(``commpy_tpu/ops/modem.py:258-259``).  On the card the plain PyTorch
version (``ops/modem.py:_demodulate_joint``) ran ~20 launches over
``[..., n_sym, bps, m]`` float32 intermediates; K6 (``csrc/demap.cu``,
built at first use) computes the same LLRs with one thread a symbol and
nothing in device memory but the symbols and the LLRs.  Its arithmetic is
the plain version's, in the plain version's order (the source says how),
so the two agree bit for bit on the card.

``ops/modem.py:demap_route`` sends a complex64 (or real float32) CUDA
tensor on the joint path to :func:`demap_joint` for the orders it takes
(:func:`takes`); the plain version serves CPU tensors, complex128 symbols
and the orders K6 does not take.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = ["demap_joint", "takes", "ORDERS"]

ORDERS = (2, 4, 8, 16, 32, 64)  # the constellation sizes K6 is built for


def takes(m: int, bits_per_symbol: int) -> bool:
    """Whether K6 takes an ``m``-point constellation demapped to
    ``bits_per_symbol`` bits a symbol: m in :data:`ORDERS` and
    ``bits_per_symbol == log2(m)``."""
    return m in ORDERS and bits_per_symbol == m.bit_length() - 1


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("demap")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.demap_joint_launch.argtypes = [p, p, ll, i, i, p, ctypes.c_float, p,
                                       ll, p]
    lib.demap_joint_launch.restype = i
    return lib


def demap_joint(symbols: torch.Tensor, points, noise_var,
                maxlog: bool = False) -> torch.Tensor:
    """K6: exact (or, with ``maxlog``, max-log) LLRs of complex64 CUDA
    ``symbols`` ``[..., n_sym]`` against the ``m`` points of ``points``
    (label = index, output bit p = index bit ``log2(m)-1-p``); float32
    ``[..., n_sym * log2(m)]``, positive for bit 1.

    ``noise_var``: a Python or NumPy scalar, passed by value as float32;
    or a tensor (or array) that broadcasts against ``symbols``, read on
    the card, with stride 0 when it holds one element.  Leading axes are
    flattened; a non-contiguous input is copied; an empty input returns an
    empty output without a launch.  Raises for a tensor that is not
    complex64 on a CUDA device and for an order K6 does not take.

    Counter: ``demap_joint.launches``, every launch.
    """
    if symbols.dtype != torch.complex64:
        raise ValueError(f"demap_joint takes complex64 symbols, not "
                         f"{symbols.dtype}")
    if symbols.device.type != "cuda":
        raise ValueError(f"demap_joint runs on a CUDA tensor, not one on "
                         f"{symbols.device}")
    pts = np.ascontiguousarray(points, np.complex64).reshape(-1)
    m = len(pts)
    if m not in ORDERS:
        raise ValueError(f"demap_joint takes constellations of {ORDERS} "
                         f"points, not {m}")
    bps = m.bit_length() - 1
    dev = symbols.device
    shape = symbols.shape
    nv, stride, value = None, 0, 0.0
    if isinstance(noise_var, torch.Tensor) or np.ndim(noise_var):
        nv = torch.as_tensor(noise_var, dtype=torch.float32, device=dev)
        shape = torch.broadcast_shapes(shape, nv.shape)
        if nv.numel() != 1:
            nv, stride = nv.expand(shape).contiguous(), 1
    else:
        value = float(np.float32(noise_var))
    y = symbols.expand(shape).contiguous()
    out_shape = (*shape[:-1], shape[-1] * bps) if shape else (bps,)
    llr = torch.empty(out_shape, dtype=torch.float32, device=dev)
    if y.numel():
        with torch.cuda.device(dev):
            rc = _lib().demap_joint_launch(
                y.data_ptr(), llr.data_ptr(), y.numel(), m, int(maxlog),
                pts.ctypes.data, value,
                None if nv is None else nv.data_ptr(), stride,
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"demap_joint kernel launch failed: CUDA "
                               f"error {rc}")
        demap_joint.launches += 1
    return llr


demap_joint.launches = 0
