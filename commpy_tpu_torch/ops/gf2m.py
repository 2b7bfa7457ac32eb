r"""Bit-sliced GF(2^m) linear algebra for the algebraic codecs.

Counterpart of ``commpy_tpu/ops/gf2m.py``, the shared toolbox of the BCH
and Reed-Solomon codecs (ops/bch.py, ops/rs.py).  Field elements are
m-bit slices on the last axis:

* multiplying by a CONSTANT is a GF(2) linear map, an m x m binary
  matrix applied as ``bits @ M`` and folded mod 2;
* a VARIABLE x VARIABLE product is a carryless shift-add of the outer
  bit product, folded by the constant [2m-1, m] reduction matrix;
* SQUARING is linear over GF(2), so a batched inverse is Fermat's
  x^(2^m - 2) through m-1 squarings and m-2 products;
* the inversionless Berlekamp-Massey recurrence runs 2t steps (a Python
  loop, the JAX package's scan) on bit-sliced state; polynomial
  evaluation over a position range (Chien search, Forney) is blocked into
  ``[B, (deg+1)m] @ [(deg+1)m, D*m]`` products with a constant advance
  between blocks.

Exactness: every value is a float32 count of 0/1 products, parity-folded
by :func:`mod2`; counts stay far below 2^24, so each result is an exact
integer whatever the order of summation, and the port's bits equal the
JAX package's.  The products run at float32 on the card unless the
caller enables TF32 (``torch.backends.cuda.matmul.allow_tf32``); TF32
keeps 0/1 inputs exact and accumulates in float32, so it is exact too.
Never half-precision accumulation: bf16 or f16 sums lose counts above
256 and 2048.

The host-side construction helpers (exp/log tables, the constant
matrices, the blocked evaluation operators) run once per code.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_constant
from .galois import _PRIMPOLYS

__all__ = [
    "gf_tables",
    "gf_table",
    "gf_constant_mult_matrix",
    "gf_reduce_matrix",
    "gf_square_matrix",
    "carryless",
    "conv_xor",
    "gf_inverse_bits",
    "mod2",
    "chien_tables",
    "bm_inversionless",
]


def gf_tables(m):
    """(exp, log) tables for GF(2^m) under the module primitive poly."""
    prim = int(_PRIMPOLYS[m])
    size = (1 << m) - 1
    exp = np.zeros(2 * size, np.int64)
    log = np.zeros(1 << m, np.int64)
    x = 1
    for i in range(size):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x >> m:
            x ^= prim
    exp[size:] = exp[:size]
    return exp, log


def gf_table(array, device):
    """A host GF(2) table as a float32 tensor on ``device``, copied there
    once per content."""
    return device_constant(np.asarray(array, np.float32), device)


def _reduce_int(v, m):
    prim = int(_PRIMPOLYS[m])
    for d in range(2 * m - 2, m - 1, -1):
        if v >> d:
            v ^= prim << (d - m)
    return v


def gf_constant_mult_matrix(const, m):
    """[m, m] GF(2) matrix M with bits(const * x) = bits(x) @ M."""
    rows = []
    for b in range(m):
        v = _reduce_int(int(const) << b, m)
        rows.append([(v >> c) & 1 for c in range(m)])
    return np.asarray(rows, np.int64)


def gf_reduce_matrix(m):
    """[2m-1, m] GF(2) matrix folding a carryless product to the field."""
    rows = []
    for d in range(2 * m - 1):
        v = _reduce_int(1 << d, m)
        rows.append([(v >> c) & 1 for c in range(m)])
    return np.asarray(rows, np.int64)


def gf_square_matrix(m):
    """[m, m] GF(2) matrix S with bits(x^2) = bits(x) @ S."""
    rows = []
    for b in range(m):
        v = _reduce_int(1 << (2 * b), m)
        rows.append([(v >> c) & 1 for c in range(m)])
    return np.asarray(rows, np.int64)


def mod2(x):
    """Parity of float32 counts (exact for integers below 2^24)."""
    return torch.remainder(x, 2.0)


def carryless(outer, m):
    """[..., m, m] outer bit products -> [..., 2m-1] float32 coefficient
    counts by static shift-adds (conv[a+c] += outer[a, c])."""
    conv = outer.new_zeros(outer.shape[:-2] + (2 * m - 1,))
    for a in range(m):
        conv[..., a:a + m] += outer[..., a, :]
    return conv


def conv_xor(a, b, m, reduce_mat):
    """Bit-sliced GF(2^m) product of per-slot elements.

    a, b: [..., m] float 0/1 bit slices (broadcastable); ``reduce_mat`` the
    float32 [2m-1, m] :func:`gf_reduce_matrix` on their device.
    """
    outer = a[..., :, None] * b[..., None, :]  # [..., m, m]
    return mod2(mod2(carryless(outer, m)) @ reduce_mat)


def gf_inverse_bits(x, m, square_mat, reduce_mat):
    """Batched inverse by Fermat: x^(2^m - 2); the inverse of 0 is 0.

    x: [..., m] bit slices.  2^m - 2 = sum_{i=1..m-1} 2^i, so the inverse
    is the product of the iterated squares x^(2^i).
    """
    sq = mod2(x @ square_mat)  # x^2
    acc = sq
    cur = sq
    for _ in range(m - 2):
        cur = mod2(cur @ square_mat)
        acc = conv_xor(acc, cur, m, reduce_mat)
    return acc


def chien_tables(m, deg, size, block, exps=None):
    """Blocked polynomial-evaluation operators over alpha^{-i}.

    For coefficients p_k carried at exponent ``exps[k]`` (default k =
    0..deg, an ordinary degree-``deg`` polynomial; entries may be
    negative, as Forney's X^{1-fcr} factor rides exponent -1),
    ``eval_mat`` [K*m, block*m] gives the bits of
    sum_k p_k alpha^{-(i0+d) exps[k]} for d in [0, block) from the block
    coefficients mu_k = p_k * alpha^{-i0 exps[k]}; ``step_mat`` advances
    mu by the constant map mu_k <- mu_k * alpha^{-block*exps[k]}.
    ``size`` = 2^m - 1.
    """
    exp, _ = gf_tables(m)
    if exps is None:
        exps = list(range(deg + 1))
    K = len(exps)
    eval_mat = np.zeros((K * m, block * m), np.int64)
    step_mat = np.zeros((K * m, K * m), np.int64)
    for k, ek in enumerate(exps):
        for d in range(block):
            Mm = gf_constant_mult_matrix(int(exp[(-d * ek) % size]), m)
            eval_mat[k * m:(k + 1) * m, d * m:(d + 1) * m] = Mm
        Ms = gf_constant_mult_matrix(int(exp[(-block * ek) % size]), m)
        step_mat[k * m:(k + 1) * m, k * m:(k + 1) * m] = Ms
    return eval_mat, step_mat


def bm_inversionless(synd, t, m, reduce_mat, nslots=None, init=None,
                     start=None, nf=None):
    """Inversionless (Burton) Berlekamp-Massey on bit-sliced syndromes.

    synd: [B, 2t, m] float 0/1 (S_1..S_2t).  Returns the locator bits lam
    [B, nslots, m] (its overall scale is immaterial: the roots are
    unchanged) and the locator degree L [B] int32.

    The errata (errors-and-erasures) configuration starts lam and the
    helper polynomial from the erasure locator Gamma with L = f and masks
    out the iterations r < f per batch element (``init=(gamma, f)``,
    ``start=f``, ``nf=f``; the growth condition becomes 2L <= r + f).
    ``nslots`` widens the polynomial buffers (errata locators reach
    degree 2t).  ``reduce_mat`` is the float32 :func:`gf_reduce_matrix`
    on the syndromes' device.

    The state is lanes-major, ``[slots, m, B]``, as in the JAX package;
    the 2t steps are a Python loop whose index is a Python int.
    """
    B = synd.shape[0]
    dev = synd.device
    ns = (t + 1) if nslots is None else nslots
    if init is None:
        lam = torch.zeros((ns, m, B), dtype=torch.float32, device=dev)
        lam[0, 0, :] = 1.0
        Lr = torch.zeros(B, dtype=torch.int32, device=dev)
    else:
        lam0, Lr = init
        lam = lam0.permute(1, 2, 0).to(torch.float32)
        Lr = Lr.to(torch.int32)
    bpoly = lam
    delta = torch.zeros((m, B), dtype=torch.float32, device=dev)
    delta[0, :] = 1.0
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    start = zero if start is None else start
    nf = zero if nf is None else nf
    red_t = reduce_mat.T.contiguous()  # [m, 2m-1]
    # the discrepancy window S_{r-j}, j = 0..ns-1, as a slice at offset r
    synd_l = synd.permute(1, 2, 0).to(torch.float32)  # [2t, m, B]
    synd_pad = torch.cat(
        [torch.zeros((ns - 1, m, B), dtype=torch.float32, device=dev),
         synd_l], dim=0)

    def cl_rows(outer):
        """[..., m(a), m(c), B] products -> [..., 2m-1, B] counts."""
        conv = outer.new_zeros(outer.shape[:-3] + (2 * m - 1, B))
        for a in range(m):
            conv[..., a:a + m, :] += outer[..., a, :, :]
        return conv

    def fold(conv_bits):
        """[..., 2m-1, B] bit rows -> [..., m, B] through the reduction
        matrix (sums of <= m rows, then parity)."""
        return mod2(red_t @ conv_bits)

    for r in range(2 * t):
        win = synd_pad[r:r + ns].flip(0)  # win[j] = S_{r - j} (0-based)
        outer = torch.sum(lam[:, :, None, :] * win[:, None, :, :],
                          dim=0)  # [m, m, B] float32 counts
        d = fold(mod2(cl_rows(outer)))  # [m, B]

        xB = torch.cat([bpoly.new_zeros((1, m, B)), bpoly[:-1]], dim=0)
        # delta * lam and d * xB, slotwise bit-sliced products
        o1 = delta[None, :, None, :] * lam[:, None, :, :]  # [ns, a, c, B]
        o2 = d[None, :, None, :] * xB[:, None, :, :]
        conv = mod2(cl_rows(o1)) + mod2(cl_rows(o2))  # [ns, 2m-1, B]
        lam_new = fold(mod2(conv))

        active = r >= start
        d_nonzero = torch.any(d > 0, dim=0)
        grow = active & d_nonzero & (2 * Lr <= r + nf)
        bpoly_new = torch.where(grow[None, None, :], lam, xB)
        bpoly = torch.where(active[None, None, :], bpoly_new, bpoly)
        lam = torch.where(active[None, None, :], lam_new, lam)
        delta = torch.where(grow[None, :], d, delta)
        # errata degree bookkeeping: L <- r + 1 + f - L (f = 0 plain)
        Lr = torch.where(grow, r + 1 + nf - Lr, Lr)
    return lam.permute(2, 0, 1), Lr
