"""CRC-aided list decoding of polar codes on the card (K7).

K7 replaces no TPU kernel: the JAX package decodes polar codes in plain
XLA.  On the card the port's plain decoder
(``ops/polar.py:make_polar_scl_decoder_unrolled``) issues a few small
operations a tree node and a stable sort a leaf, ~21,500 launches a
decode at N = 1024; K7 (``csrc/polar_scl.cu``, built at first use)
decodes a frame, all its paths, in one warp, and a batch in one launch.
Its decisions are the plain decoder's with ``rule='minsum'`` and
``pm_rule='approx'``, bit for bit: the same f and g, float32 path metrics
summed leaf by leaf in the same order, the same ranking of the ``2L``
candidates (ties to the lower ``bit * L + parent``) and the same
CRC-aided selection (the source says how).

:func:`polar_scl_plan` says which codes K7 takes; :func:`polar_units` is
the walk it follows, planned once a code on the host;
:func:`make_polar_scl_kernel` builds a decoder with its tables on the
card.  ``ops/polar.py:make_polar_scl_route`` sends a list decode there
for the codes the plan takes.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops.crc import crc_check_table
from ..utils.device import device_constant, on_device, resolve_device
from . import _build

__all__ = ["polar_scl", "polar_scl_plan", "polar_units",
           "make_polar_scl_kernel", "MAX_N", "MAX_LIST"]

MAX_N = 1024  # the longest code K7 takes (a unit holds lo in 11 bits)
MAX_LIST = 8  # the longest list: 2L candidates fill half a warp
MAX_CRC = 32  # CRC bits a path's syndrome register holds
MAX_VTOP = 3  # top levels recomputed: 8 channel LLRs a value at most


def _paths(list_size: int) -> int:
    """The list's slots: ``list_size`` rounded up to a power of two."""
    return 1 << (int(list_size) - 1).bit_length()


def polar_scl_plan(N: int, L: int, rule: str = "minsum",
                   pm_rule: str = "approx", systematic: bool = False,
                   crc_bits: int = 0, frozen_level: int = 0):
    """K7's launch plan for a code of length ``N`` decoded with ``L``
    paths, or None where K7 does not take it.

    K7 takes power-of-two ``N`` in [2, :data:`MAX_N`], ``1 <= L <=``
    :data:`MAX_LIST`, the min-sum f with the approximate path metric, and
    non-systematic codes with at most :data:`MAX_CRC` CRC bits.  The list
    runs in ``paths`` slots (``L`` rounded up to a power of two), and a
    block of ``threads`` is one warp of ``32 / paths`` frames, one lane a
    path.  Shared memory holds, a frame, a prune's candidates (96 bytes),
    the LLRs of the tree's levels but the top ``vtop`` (``4 N / 2^vtop``
    bytes a slot) and the partial sums as bits (``N / 8`` bytes a slot):
    ``smem_bytes`` is a frame's, and a warp takes ``32 / paths`` times it.
    The top ``vtop`` levels, up to :data:`MAX_VTOP` and at most n - 1, are
    recomputed from the channel where read; they stay below the walk's
    highest all-frozen subtree, ``frozen_level``, whose leaves are made in
    place.  Returns ``{"paths", "threads", "vtop",
    "smem_bytes"}``.
    """
    n = int(N).bit_length() - 1
    if (1 << n != N or not 2 <= N <= MAX_N or not 1 <= L <= MAX_LIST
            or rule != "minsum" or pm_rule != "approx" or systematic
            or crc_bits > MAX_CRC):
        return None
    paths = _paths(L)
    vtop = max(0, min(MAX_VTOP, n - 1, n - 1 - int(frozen_level)))
    return {"paths": paths, "threads": 32, "vtop": vtop,
            "smem_bytes": 96 + 4 * (N >> vtop) * paths
            + 4 * -(-N * paths // 32)}


def polar_units(frozen) -> np.ndarray:
    """K7's walk over the frozen mask ``frozen`` [N]: each maximal
    all-frozen subtree and each info leaf, in leaf order, as int32
    ``lo | level << 11 | info << 15 | info ordinal << 16``."""
    frozen = np.asarray(frozen, bool)
    units = []
    ordinal = 0

    def walk(lo, W):
        nonlocal ordinal
        if frozen[lo:lo + W].all():
            units.append(lo | (W.bit_length() - 1) << 11)
        elif W == 1:
            units.append(lo | 1 << 15 | ordinal << 16)
            ordinal += 1
        else:
            walk(lo, W // 2)
            walk(lo + W // 2, W // 2)

    walk(0, len(frozen))
    return np.asarray(units, np.int32)


def _crc_rows(code) -> np.ndarray:
    """Row j of the CRC check table as a bit mask (bit c = column c)."""
    H = crc_check_table(code.crc, code.k_total).astype(np.int64)
    return (H << np.arange(H.shape[1])).sum(1).astype(np.uint32).view(
        np.int32)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("polar_scl")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.polar_scl_launch.argtypes = [p, p, ll, i, i, i, p, i, p, i, p]
    lib.polar_scl_launch.restype = i
    return lib


def polar_scl(llr: torch.Tensor, units: torch.Tensor, crc_rows, K: int,
              list_size: int, vtop: int) -> torch.Tensor:
    """K7: decode float32 CUDA LLRs ``[..., N]`` (positive means bit 0)
    along ``units`` (:func:`polar_units`, int32 on the same card) with
    ``list_size`` paths; ``crc_rows`` (int32 masks, one an info bit, or
    None without a CRC); ``vtop``, the top levels recomputed, as
    :func:`polar_scl_plan` gives it for the walk.  Returns the payload,
    the first ``K`` info bits, ``[..., K]`` int8.  Raises for a tensor
    that is not float32 on a CUDA device and for a shape K7 does not
    take.

    Counters: ``polar_scl.launches``, every launch; ``polar_scl.warps``,
    the warps of the last launch, ``ceil(B / (32 / paths))``.
    """
    if llr.dtype != torch.float32 or llr.device.type != "cuda":
        raise ValueError(f"polar_scl takes float32 CUDA LLRs, not "
                         f"{llr.dtype} on {llr.device}")
    N = llr.shape[-1]
    if polar_scl_plan(N, list_size) is None:
        raise ValueError(f"polar_scl takes N a power of two in [2, {MAX_N}] "
                         f"and 1 <= list_size <= {MAX_LIST}, not N = {N}, "
                         f"list_size = {list_size}")
    if not 0 <= vtop <= min(MAX_VTOP, N.bit_length() - 2):
        raise ValueError(f"vtop {vtop} is not a plan's for N = {N}")
    if units.dtype != torch.int32 or units.device != llr.device:
        raise ValueError("units must be int32 on the LLRs' device")
    x = llr.reshape(-1, N).contiguous()
    if x.data_ptr() % 16:  # K7 reads the channel as float4
        x = x.clone()
    out = torch.empty((x.shape[0], K), dtype=torch.int8, device=llr.device)
    if x.shape[0] and K:
        dev = llr.device
        with torch.cuda.device(dev):
            rc = _lib().polar_scl_launch(
                x.data_ptr(), out.data_ptr(), x.shape[0], N, list_size, K,
                units.data_ptr(), units.numel(),
                None if crc_rows is None else crc_rows.data_ptr(),
                int(vtop), torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"polar_scl kernel launch failed: CUDA "
                               f"error {rc}")
        polar_scl.launches += 1
        polar_scl.warps = -(-x.shape[0] * _paths(list_size) // 32)
    return out.reshape(*llr.shape[:-1], K)


polar_scl.launches = 0
polar_scl.warps = 0


@functools.lru_cache(maxsize=64)
def make_polar_scl_kernel(code, list_size=8, device="cuda"):
    """``decode(llr [B, N]) -> payload [B, K]`` int8 on K7, the walk and
    the CRC table copied to the card once.  Raises ValueError for a code
    :func:`polar_scl_plan` does not take."""
    dev = resolve_device(device)
    walk = polar_units(code.frozen_mask)
    plan = polar_scl_plan(code.N, list_size, systematic=code.systematic,
                          crc_bits=code.crc.length if code.crc else 0,
                          frozen_level=int(((walk >> 11) & 15).max()))
    if plan is None:
        raise ValueError(f"K7 does not take the ({code.N}, {code.K}) code "
                         f"with {list_size} paths")
    units = device_constant(walk, dev)
    rows = device_constant(_crc_rows(code), dev) if code.crc else None

    def decode(llr):
        llr = on_device(llr, dev).to(torch.float32)
        return polar_scl(llr, units, rows, code.K, list_size, plan["vtop"])

    return decode
