"""Constellation mapping and demapping.

Counterpart of ``commpy_tpu/ops/modem.py``:

* constellations are built once on the host, Gray-labelled by the closed
  form ``i ^ (i >> 1)``; :func:`lte_16qam_constellation` is LTE's labelling
  and :func:`nr_qpsk_constellation` NR's QPSK (both beyond the reference);
* ``modulate`` is a batched gather;
* ``demodulate_hard`` is a distance-matrix argmin with the first-index
  tie-break;
* ``demodulate_soft`` computes the exact LLR as a masked logsumexp over
  the constellation, and ``demodulate_maxlog`` its max-log approximation.
  For a Gray square QAM of order >= 64 (``method='auto'``), both take the
  per-axis factorised form: each bit depends on one axis only, so the
  other axis' term cancels.  On the card the joint form runs as one
  hand-written kernel, K6 (``kernels/demap.py``), for complex64 symbols
  and orders up to 64; ``_demodulate_joint``, its plain version, serves
  CPU tensors, complex128 symbols and the larger orders
  (:func:`demap_route`).

Constellations may be NumPy arrays or tensors; they are used as complex64
on the device of the symbols, as the JAX package uses them in f32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels import demap
from ..utils.bits import np_unpack_bits, pack_bits, unpack_bits
from ..utils.device import device_constant, on_device

__all__ = [
    "gray_reorder",
    "psk_constellation",
    "qam_constellation",
    "lte_16qam_constellation",
    "nr_qpsk_constellation",
    "modulate",
    "demodulate_hard",
    "demodulate_soft",
    "demodulate_maxlog",
    "constellation_bit_masks",
]


def gray_reorder(points) -> np.ndarray:
    """Reorder ``points`` so index == bit pattern under Gray labelling:
    with g[i] = i ^ (i >> 1), new[g[i]] = old[i]."""
    pts = np.asarray(points)
    m = pts.size
    g = np.arange(m) ^ (np.arange(m) >> 1)
    out = np.empty_like(pts)
    out[g] = pts
    return out


def psk_constellation(m: int) -> np.ndarray:
    """Gray-labelled m-PSK constellation (reference modulation.py:175-211)."""
    if 2 ** int(np.log2(m)) != m:
        raise ValueError("Constellation length must be a power of 2.")
    pts = np.exp(1j * np.arange(0, 2 * np.pi, 2 * np.pi / m))
    return gray_reorder(pts)


def qam_constellation(m: int) -> np.ndarray:
    """Gray-labelled square m-QAM (reference modulation.py:213-262)."""
    num_symb_pam = np.sqrt(m)
    if num_symb_pam != int(num_symb_pam):
        raise ValueError("m must lead to a square QAM.")
    num_symb_pam = int(num_symb_pam)
    pam = np.arange(-num_symb_pam + 1, num_symb_pam, 2)
    pts = (
        np.tile(np.hstack((pam, pam[::-1])), num_symb_pam // 2) * 1j
        + pam.repeat(num_symb_pam)
    )
    return gray_reorder(pts)


def lte_16qam_constellation() -> np.ndarray:
    """LTE's 16-QAM (3GPP TS 36.211 7.1.3, Table 7.1.3-1), complex128 at
    unit mean energy, indexed by the label's bits b0 b1 b2 b3, most
    significant first (as :func:`modulate` packs them): I =
    (1-2b0)(1+2b2)/sqrt(10), Q = (1-2b1)(1+2b3)/sqrt(10), so 0000 ->
    (1+1j)/sqrt(10) and 0010 -> (3+1j)/sqrt(10)."""
    b = np_unpack_bits(np.arange(16), 4).astype(np.int64)
    return ((1 - 2 * b[:, 0]) * (1 + 2 * b[:, 2])
            + 1j * (1 - 2 * b[:, 1]) * (1 + 2 * b[:, 3])) / np.sqrt(10)


def nr_qpsk_constellation() -> np.ndarray:
    """NR's QPSK (3GPP TS 38.211 5.1.3), complex64, indexed by the label's
    bits b0 b1, most significant first (as :func:`modulate` packs them):
    d = ((1-2b0) + j(1-2b1))/sqrt(2), so 00 -> (1+1j)/sqrt(2) and 01 ->
    (1-1j)/sqrt(2).  Its mean energy is 1 to float32 rounding."""
    b = np_unpack_bits(np.arange(4), 2).astype(np.int64)
    return (((1 - 2 * b[:, 0]) + 1j * (1 - 2 * b[:, 1])) / np.sqrt(2)
            ).astype(np.complex64)


def constellation_bit_masks(m: int, bps: int) -> np.ndarray:
    """``masks[p, c]`` is True iff output bit p of constellation index c is 1
    (output position p is index bit ``bps-1-p``, reference
    modulation.py:137)."""
    c = np.arange(m)
    p = np.arange(bps)
    return ((c[None, :] >> (bps - 1 - p)[:, None]) & 1).astype(np.bool_)


def _const_tensor(constellation, device) -> torch.Tensor:
    if isinstance(constellation, torch.Tensor):
        return constellation.to(device=device, dtype=torch.complex64)
    return device_constant(np.asarray(constellation, np.complex64), device)


def _const_numpy(constellation) -> np.ndarray:
    if isinstance(constellation, torch.Tensor):
        constellation = constellation.detach().cpu().numpy()
    return np.asarray(constellation).astype(np.complex64)


def modulate(bits: torch.Tensor, constellation, bits_per_symbol: int,
             device="cuda"):
    """Map bits ``[..., n_bits]`` (moved to ``device``) to complex64
    symbols ``[..., n_bits // bits_per_symbol]``."""
    bits = on_device(bits, device)
    grouped = bits.reshape(bits.shape[:-1] + (-1, bits_per_symbol))
    idx = pack_bits(grouped).long()
    return _const_tensor(constellation, bits.device)[idx]


def _sq_dists(symbols: torch.Tensor, constellation) -> torch.Tensor:
    """|y - c|^2 for every symbol/point pair: ``[..., n_sym, m]`` float32."""
    c = _const_tensor(constellation, symbols.device)
    d = symbols.unsqueeze(-1) - c
    return (d.real * d.real + d.imag * d.imag).float()


def demodulate_hard(symbols: torch.Tensor, constellation,
                    bits_per_symbol: int) -> torch.Tensor:
    """Minimum-distance demapping, first-index tie-break; int8 bits
    ``[..., n_sym * bits_per_symbol]``."""
    idx = torch.argmin(_sq_dists(symbols, constellation), dim=-1)
    bits = unpack_bits(idx, bits_per_symbol)
    return bits.reshape(bits.shape[:-2] + (-1,))


@functools.lru_cache(maxsize=64)
def _separable_plan_cached(const_bytes: bytes, m: int, bps: int):
    const_np = np.frombuffer(const_bytes, np.complex64, count=m)
    re = np.round(const_np.real.astype(np.float64), 9)
    im = np.round(const_np.imag.astype(np.float64), 9)
    uR, iR = np.unique(re, return_inverse=True)
    uI, iI = np.unique(im, return_inverse=True)
    if len(uR) * len(uI) != m or len(np.unique(iR * len(uI) + iI)) != m:
        return None
    masks = constellation_bit_masks(m, bps)
    rows = []
    for p in range(bps):
        mk = masks[p]
        if all(len(set(mk[iR == g])) == 1 for g in range(len(uR))):
            rows.append(("I", np.array([mk[iR == g][0]
                                        for g in range(len(uR))])))
        elif all(len(set(mk[iI == g])) == 1 for g in range(len(uI))):
            rows.append(("Q", np.array([mk[iI == g][0]
                                        for g in range(len(uI))])))
        else:
            return None
    return uR.astype(np.float32), uI.astype(np.float32), tuple(rows)


def _separable_qam_plan(const_np: np.ndarray, bps: int):
    """Per-axis factorisation of a product-grid constellation, or None.

    For a full {Re levels} x {Im levels} grid where every bit depends on
    one axis only (true of Gray square QAM) the exact LLR factorises.
    Detected numerically from the concrete constellation.
    """
    const_np = np.ascontiguousarray(const_np, np.complex64)
    return _separable_plan_cached(const_np.tobytes(), len(const_np), bps)


def demap_route(m: int, bits_per_symbol: int, method: str, device_type: str,
                dtype: torch.dtype, grid: bool) -> str:
    """Which demapper takes ``m`` points on symbols of ``dtype`` on a
    ``device_type`` device.

    ``'separable'``: the per-axis form, where ``method`` asks for it
    (``'separable'``, or ``'auto'`` at an order of at least 64) and the
    constellation is a product grid that factorises (``grid``: its
    :func:`_separable_qam_plan` is not None).  Else the joint path:
    ``'kernel'``, K6 (:func:`~commpy_tpu_torch.kernels.demap.demap_joint`),
    for complex64 or real float32 symbols (exact as complex64) on a CUDA
    device and the orders K6 takes (m = 2 to 64, ``bits_per_symbol ==
    log2(m)``); ``'plain'``, :func:`_demodulate_joint`, for the rest, so
    complex128 symbols keep their float64 distances.
    """
    if method not in ("auto", "separable", "joint"):
        raise ValueError(
            f"method must be 'auto', 'separable', or 'joint', got "
            f"{method!r}")
    if grid and (method == "separable" or (method == "auto" and m >= 64)):
        return "separable"
    if (device_type == "cuda" and dtype in (torch.complex64, torch.float32)
            and demap.takes(m, bits_per_symbol)):
        return "kernel"
    return "plain"


def _noise_var_tensor(noise_var, like: torch.Tensor) -> torch.Tensor:
    """Noise variance as a float32 tensor on the symbols' device; a
    per-symbol variance gains a trailing axis for the constellation axis.

    A tensor divisor, not a Python number: for a scalar divisor PyTorch's
    CUDA division multiplies by the reciprocal, which rounds differently.
    """
    if isinstance(noise_var, (torch.Tensor, np.ndarray)) and np.ndim(
            noise_var):
        return torch.as_tensor(noise_var, dtype=torch.float32,
                               device=like.device).unsqueeze(-1)
    # a fill on the device, not a (stream-synchronising) host copy
    return torch.full((), float(noise_var), dtype=torch.float32,
                      device=like.device)


def _demodulate_soft_separable(symbols, plan, noise_var, reduce):
    uR, uI, rows = plan
    dev = symbols.device
    nv = _noise_var_tensor(noise_var, symbols)
    dI = -(symbols.real.unsqueeze(-1) - device_constant(uR, dev)) ** 2 / nv
    dQ = -(symbols.imag.unsqueeze(-1) - device_constant(uI, dev)) ** 2 / nv
    neg_inf = torch.full((), -torch.inf, dtype=dI.dtype, device=dev)
    llrs = []
    for axis, mrow in rows:
        d = dI if axis == "I" else dQ
        mk = device_constant(mrow, dev)
        r1 = reduce(torch.where(mk, d, neg_inf))
        r0 = reduce(torch.where(mk, neg_inf, d))
        llrs.append(r1 - r0)
    llr = torch.stack(llrs, dim=-1).float()
    return llr.reshape(llr.shape[:-2] + (-1,))


def _lse(x):
    return torch.logsumexp(x, dim=-1)


def _max(x):
    return torch.amax(x, dim=-1)


def _demodulate_joint(symbols, constellation, bits_per_symbol, noise_var,
                      reduce):
    """The joint demapper in plain PyTorch: ``reduce`` (logsumexp or
    amax) over the masked log-weights; K6's plain version."""
    m = len(_const_numpy(constellation))
    masks = device_constant(constellation_bit_masks(m, bits_per_symbol),
                            symbols.device)  # [bps, m]
    nv = _noise_var_tensor(noise_var, symbols)
    logw = (-_sq_dists(symbols, constellation) / nv).unsqueeze(-2)
    neg_inf = torch.full((), -torch.inf, dtype=logw.dtype,
                         device=symbols.device)
    llr = reduce(torch.where(masks, logw, neg_inf)) - reduce(
        torch.where(masks, neg_inf, logw))  # [..., n_sym, bps]
    return llr.reshape(llr.shape[:-2] + (-1,))


def _demodulate(symbols, constellation, bits_per_symbol, noise_var, method,
                maxlog):
    const_np = _const_numpy(constellation)
    m = len(const_np)
    plan = None
    if method == "separable" or (method == "auto" and m >= 64):
        plan = _separable_qam_plan(const_np, bits_per_symbol)
    reduce = _max if maxlog else _lse
    route = demap_route(m, bits_per_symbol, method, symbols.device.type,
                        symbols.dtype, plan is not None)
    if route == "separable":
        return _demodulate_soft_separable(symbols, plan, noise_var, reduce)
    if route == "kernel":
        return demap.demap_joint(symbols.to(torch.complex64), const_np,
                                 noise_var, maxlog)
    return _demodulate_joint(symbols, constellation, bits_per_symbol,
                             noise_var, reduce)


def demodulate_soft(symbols: torch.Tensor, constellation,
                    bits_per_symbol: int, noise_var, method: str = "auto"):
    """Exact-LLR soft demapping (positive LLR -> bit 1), float32
    ``[..., n_sym * bits_per_symbol]``.

    ``method='auto'`` takes the per-axis factorised form for a separable
    product-grid constellation of order >= 64; ``'separable'`` forces it,
    ``'joint'`` forces the generic path, which on the card is K6 for
    complex64 symbols and orders up to 64 (:func:`demap_route`).
    """
    return _demodulate(symbols, constellation, bits_per_symbol, noise_var,
                       method, maxlog=False)


def demodulate_maxlog(symbols: torch.Tensor, constellation,
                      bits_per_symbol: int, noise_var, method: str = "auto"):
    """Max-log LLR soft demapping, same ``method`` semantics as
    :func:`demodulate_soft`."""
    return _demodulate(symbols, constellation, bits_per_symbol, noise_var,
                       method, maxlog=True)
