"""K-best MIMO detection on the card (K8).

K8 replaces no TPU kernel: the JAX package searches in plain XLA
(``commpy_tpu/ops/mimo.py``, sorts and gathers).  On the card the port's
plain search (``ops/mimo.py:_beam_search_batched`` and
``_max_log_llrs_batched``) sorts all ``C m`` candidates of every vector at
every level and gathers the survivors' state, ~150 launches a pass over
device memory; K8 (``csrc/kbest.cu``, built at first use) runs the search
and the max-log LLRs (or the hard decision) of a triangularised batch in
one launch, one lane a survivor, ``32 / lanes`` vectors a warp.  Its
output is the plain version's bit for bit: the same float32 operations in
the same order, survivors ranked by (metric, candidate index) as the plain
stable sort ranks them (the source says how).

:func:`kbest_plan` says which shapes K8 takes; ``ops/mimo.py:kbest_device``
sends a CUDA batch there after the plain triangularisation.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

__all__ = ["kbest", "kbest_plan", "NTS", "ORDERS", "MAX_K"]

NTS = (2, 4)  # the transmit antennas K8 is built for
ORDERS = (4, 16)  # the constellation sizes K8 is built for
MAX_K = 32  # survivors: a vector's lanes fill at most a warp


def kbest_plan(nt: int, m: int, K: int, bps: int, soft: bool = False,
               noise_var=0.0) -> dict:
    """K8's launch plan for ``nt`` transmit antennas, an ``m``-point
    constellation of ``bps`` bits a symbol and ``K`` survivors, with hard
    or ``soft`` output and the noise variance ``noise_var``.

    K8 takes nt in :data:`NTS`, m in :data:`ORDERS`, ``bps == log2(m)``,
    ``1 <= K <=`` :data:`MAX_K` and, for soft output, the noise variance
    as a Python or NumPy scalar (the plain version divides by a host
    scalar; K8 matches that rounding, not a tensor's).  A vector takes
    ``lanes`` lanes, K rounded up to a power of two, so a warp holds
    ``32 / lanes`` vectors.  Returns ``{"reason": None, "lanes"}``, or
    ``{"reason": why}`` where K8 does not take the call (the plain search
    then runs).
    """
    nt, m, K, bps = int(nt), int(m), int(K), int(bps)
    if nt not in NTS:
        return {"reason": f"K8 is built for nt in {NTS}, not nt = {nt}"}
    if m not in ORDERS:
        return {"reason": f"K8 is built for constellations of {ORDERS} "
                          f"points, not {m}"}
    if bps != m.bit_length() - 1:
        return {"reason": f"K8 takes log2(m) = {m.bit_length() - 1} bits "
                          f"a symbol, not {bps}"}
    if not 1 <= K <= MAX_K:
        return {"reason": f"K8 keeps 1 to {MAX_K} survivors, not K = {K}"}
    if soft and (isinstance(noise_var, torch.Tensor)
                 or np.ndim(noise_var) != 0):
        return {"reason": "K8 takes the noise variance as a host scalar, "
                          f"not a {type(noise_var).__name__}"}
    return {"reason": None, "lanes": 1 << (K - 1).bit_length()}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("kbest")
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    lib.kbest_launch.argtypes = [p, p, p, p, p, ll, i, i, i, i, p, f, f, i,
                                 f, f, p]
    lib.kbest_launch.restype = i
    return lib


def kbest(r: torch.Tensor, yt: torch.Tensor, points, K: int,
          soft: bool = False, a_priori=None, noise_var=0.0,
          llr_clip=None) -> torch.Tensor:
    """K8: K-best detection of a triangularised batch on the card.

    ``r`` ``[B, nt, nt]`` and ``yt`` ``[B, nt]``, complex64, contiguous,
    on one CUDA device: ``ops/mimo.py:_chol_qr_batched``'s output.
    ``points``: the ``m`` constellation points (label = index).  Hard ->
    the best leaf's symbols ``[B, nt]`` complex64; ``soft`` -> max-log
    LLRs ``[B, nt log2(m)]`` float32 (positive <=> bit 0, +-inf where
    every leaf agrees), with the priors ``a_priori`` (float32 ``[B, nt
    log2(m)]``, contiguous, or None) in the metric and clipped to
    ``+-llr_clip`` unless it is None.  ``noise_var`` (soft only): a
    Python or NumPy scalar, the plain version's host scalar.  An empty
    batch returns an empty output without a launch.  Raises for a dtype,
    shape, layout or device K8 does not take.

    Counter: ``kbest.launches``, every launch.
    """
    for name, t in (("r", r), ("yt", yt)):
        if t.dtype != torch.complex64:
            raise ValueError(f"kbest takes complex64 {name}, not {t.dtype}")
    if r.dim() != 3 or r.shape[1] != r.shape[2] or tuple(yt.shape) != tuple(
            r.shape[:2]):
        raise ValueError(f"kbest takes r [B, nt, nt] and yt [B, nt], not "
                         f"{tuple(r.shape)} and {tuple(yt.shape)}")
    pts = np.ascontiguousarray(points, np.complex64).reshape(-1)
    B, nt, m = r.shape[0], r.shape[1], len(pts)
    bps = m.bit_length() - 1
    plan = kbest_plan(nt, m, K, bps, soft, noise_var)
    if plan["reason"] is not None:
        raise ValueError(plan["reason"])
    if a_priori is not None:
        if not soft:
            raise ValueError("kbest takes a_priori with soft output only")
        if a_priori.dtype != torch.float32 or tuple(a_priori.shape) != (
                B, nt * bps):
            raise ValueError(f"kbest takes float32 a_priori [{B}, "
                             f"{nt * bps}], not {a_priori.dtype} "
                             f"{tuple(a_priori.shape)}")
    ins = (r, yt) if a_priori is None else (r, yt, a_priori)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("kbest takes contiguous r, yt and a_priori")
    dev = r.device
    if dev.type != "cuda" or any(t.device != dev for t in ins):
        raise ValueError(f"kbest runs on CUDA tensors of one device, not "
                         f"{[str(t.device) for t in ins]}")
    if soft:
        out = torch.empty((B, nt * bps), dtype=torch.float32, device=dev)
    else:
        out = torch.empty((B, nt), dtype=torch.complex64, device=dev)
    if not B:
        return out
    neg_n0 = -float(np.float32(noise_var)) if a_priori is not None else 0.0
    inv_2n0 = 0.0
    if soft:
        # the plain -(n0 - n1) / (2 * noise_var): a CUDA tensor divided by
        # a host scalar is multiplied by the float32 reciprocal
        with np.errstate(divide="ignore"):
            inv_2n0 = float(np.float32(1.0) / np.float32(2 * noise_var))
    clip = llr_clip is not None and soft
    lo = float(np.float32(-float(llr_clip))) if clip else 0.0
    hi = float(np.float32(float(llr_clip))) if clip else 0.0
    table = np.stack([pts.real, pts.imag], -1).astype(np.float32)
    with torch.cuda.device(dev):
        rc = _lib().kbest_launch(
            r.data_ptr(), yt.data_ptr(),
            None if a_priori is None else a_priori.data_ptr(),
            None if soft else out.data_ptr(),
            out.data_ptr() if soft else None,
            B, nt, m, int(K), plan["lanes"], table.ctypes.data, neg_n0, inv_2n0, int(clip),
            lo, hi, torch.cuda.current_stream(dev).cuda_stream)
    if rc:
        raise RuntimeError(f"kbest kernel launch failed: CUDA error {rc}")
    kbest.launches += 1
    return out


kbest.launches = 0
