r"""Polar codes: construction, encoding, SC and CRC-aided SCL decoding.

Counterpart of ``commpy_tpu/ops/polar.py`` (the reference has no polar
codec).  The decoders are plain PyTorch, as the JAX package's are plain
XLA; on the card the list decode of the codes it takes runs on K7
(``kernels/polar_scl.py``, one launch a batch), which the route of
:func:`make_polar_scl_route` picks once a code.

* **Construction**: Bhattacharyya (log domain) and Gaussian-approximation
  density evolution, offline NumPy in float64, as in the JAX package, so
  the frozen sets are the same.
* **Encoder**: ``x = u @ F^{\otimes n}`` over GF(2) as ``log2(N)``
  reshape-XOR butterflies on integer bits, batched over frames.
* **SC decoder** (:func:`make_polar_sc_decoder`): a loop over blocks of
  ``2^block_exp`` leaves.  Each block refreshes the carried ``[N, B]``
  LLR buffer (level ``l`` in rows ``[2^l, 2^{l+1})``) down to the block
  level, decodes its subtree recursively and stores its partial sums.
  Subtrees whose leaves are all frozen decode to zeros without
  arithmetic; every other leaf value has the recursion's dataflow, so the
  decisions are those of any SC formulation.
* **SCL decoders**: :func:`make_polar_scl_decoder` follows the JAX
  package's blocked scan (local per-leaf prunes, one deferred permutation
  of the carried ``[N, P, B]`` state a block, a genealogy pass at the
  end); :func:`make_polar_scl_decoder_unrolled` recurses over the tree
  against the frozen mask (level-parallel cascades for all-frozen
  subtrees, hierarchically deferred permutations).  Both rank the ``2P``
  candidates ``bit * P + parent`` with a stable sort, so ties go to the
  lower candidate index as ``lax.top_k`` and the stable-rank selection
  of the JAX package break them.  Path permutations are index gathers
  (the JAX package multiplies by one-hot matrices; with finite state the
  numbers are the same).

Conventions: ``G = F^{\otimes n}`` with no bit reversal; u-index
reliability follows the MSB-first polarisation recursion; ``llr = log
P(x=0)/P(x=1)`` and the hard decision is ``llr < 0``; CRCs are zero-init,
non-reflected, no final XOR, appended to the payload before encoding.
Path metrics are float32 sums in leaf order.  ``_PM_INACTIVE`` marks
list slots not yet branched, ``_CRC_FAIL`` is added to CRC-failing paths
at selection.  The min-sum and approximate path-metric rules give the
JAX package's decisions and metrics bit for bit; the exact rules
(``logaddexp``) agree to float32 rounding.

The CRC tables are :mod:`commpy_tpu_torch.ops.crc`'s, whose ``crc24c`` is
the 3GPP polynomial (the JAX package's differs; see that module).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..kernels import polar_scl as _k7
from ..utils.device import device_constant, on_device, resolve_device
from .crc import (CRC_POLYNOMIALS, CrcSpec, crc_check_table,
                  crc_encode_table)

__all__ = [
    "PolarCode",
    "CrcSpec",
    "CRC_POLYNOMIALS",
    "polar_construct",
    "polar_encode",
    "polar_rate_match",
    "polar_rate_recover",
    "polar_sc_decode",
    "polar_scl_decode",
    "make_polar_encoder",
    "make_polar_sc_decoder",
    "make_polar_scl_decoder",
    "make_polar_scl_decoder_unrolled",
    "crc_encode_table",
    "crc_check_table",
]

_F32 = torch.float32
_PM_INACTIVE = 1e30  # path metric of list slots not yet branched
_CRC_FAIL = 1e20  # added to the metric of CRC-failing paths at selection
_SHORTEN_LLR = 1e9  # "known zero" LLR of shortened positions
_BACKENDS = ("auto", "cuda", "torch")
# SC's default block of 2^SC_BLOCK_EXP leaves, on every device.  The
# eager loop is paced by its launches, which vary little with the block
# size; chip_smoke.py's Path M sweeps sizes 5-10 on the card
SC_BLOCK_EXP = 9


# ---------------------------------------------------------------------------
# Code construction (offline NumPy)
# ---------------------------------------------------------------------------

def _bhattacharyya_reliability(n, design_snr_db):
    """log-domain Bhattacharyya recursion; returns -log z (big = reliable)."""
    lz = np.array([-(10.0 ** (design_snr_db / 10.0))], np.float64)
    for _ in range(n):
        minus = lz + np.log(2.0 - np.exp(lz))  # degraded: z- = 2z - z^2
        plus = 2.0 * lz                        # upgraded: z+ = z^2
        out = np.empty(2 * lz.size, np.float64)
        out[0::2], out[1::2] = minus, plus     # MSB-first indexing
        lz = out
    return -lz


_GA_TABLE = None


def _ga_phi_table():
    """(log m, log phi(m)) samples of the exact GA functional.

    phi(m) = 1 - E[tanh(u/2)], u ~ N(m, 2m), evaluated by direct
    quadrature in log domain (E[2/(1+e^u)] as a logsumexp over a wide
    standardized grid), built once.  phi is monotone decreasing, so the
    inverse is a flipped interpolation.
    """
    global _GA_TABLE
    if _GA_TABLE is None:
        logm = np.linspace(np.log(1e-7), np.log(5e6), 4000)
        m = np.exp(logm)[:, None]  # [M, 1]
        s = np.linspace(-14.0, 14.0, 1501)[None, :]  # standardized grid
        ds = s[0, 1] - s[0, 0]
        u = m + s * np.sqrt(2.0 * m)
        # log[ N(s) * ds * 2 / (1 + e^u) ], stable for both signs of u
        log_sig = np.where(u > 0, -u - np.log1p(np.exp(-np.abs(u))),
                           -np.log1p(np.exp(-np.abs(u))))
        log_w = -0.5 * s**2 - 0.5 * np.log(2.0 * np.pi) + np.log(ds) \
            + np.log(2.0) + log_sig
        mx = log_w.max(axis=1, keepdims=True)
        logphi = (mx[:, 0] + np.log(np.sum(np.exp(log_w - mx), axis=1)))
        # enforce strict monotonicity for interpolation robustness
        logphi = np.minimum.accumulate(logphi)
        _GA_TABLE = (logm, logphi)
    return _GA_TABLE


def _ga_phi_log(x):
    """log phi(x) by table interpolation (exact-quadrature table)."""
    logm, logphi = _ga_phi_table()
    return np.interp(np.log(np.clip(x, 1e-7, 5e6)), logm, logphi)


def _ga_phi_inv_log(target_log):
    """phi^{-1} in log domain (monotone decreasing => flip and interp)."""
    logm, logphi = _ga_phi_table()
    return np.exp(np.interp(target_log, logphi[::-1], logm[::-1]))


def _ga_reliability(n, design_snr_db):
    """Gaussian-approximation mean LLRs (bigger = more reliable)."""
    m = np.array([4.0 * 10.0 ** (design_snr_db / 10.0)], np.float64)
    for _ in range(n):
        lphi = _ga_phi_log(m)
        # 1 - (1 - phi)^2 = phi * (2 - phi), stable in log domain.
        minus = _ga_phi_inv_log(lphi + np.log(2.0 - np.exp(np.minimum(
            lphi, 0.0))))
        plus = 2.0 * m
        out = np.empty(2 * m.size, np.float64)
        out[0::2], out[1::2] = minus, plus
        m = out
    return m


@dataclass(frozen=True)
class PolarCode:
    """An (N, K) polar code. ``K`` counts payload bits; if ``crc`` is set
    the K + crc.length most reliable synthetic channels are unfrozen.

    ``rm`` optionally carries a rate-matching scheme ``(mode, E)`` with
    mode in {'puncture', 'shorten', 'repeat'}: the mother code stays
    (N, K) but ``E`` coded bits go over the air (see polar_rate_match /
    polar_rate_recover)."""

    N: int
    K: int
    frozen: tuple  # length-N tuple of bools, True = frozen
    crc: CrcSpec | None = None
    rm: tuple | None = None
    systematic: bool = False

    def __post_init__(self):
        n = int(np.log2(self.N))
        if 1 << n != self.N:
            raise ValueError(f"N must be a power of two, got {self.N}")
        if len(self.frozen) != self.N:
            raise ValueError("frozen mask length != N")
        if self.k_total != self.N - sum(self.frozen):
            raise ValueError(
                f"frozen mask has {self.N - sum(self.frozen)} info slots, "
                f"need K{'+crc' if self.crc else ''} = {self.k_total}")

    @property
    def n(self):
        return int(np.log2(self.N))

    @property
    def k_total(self):
        return self.K + (self.crc.length if self.crc else 0)

    @property
    def frozen_mask(self):
        return np.asarray(self.frozen, bool)

    @property
    def info_positions(self):
        return np.flatnonzero(~self.frozen_mask)

    @property
    def rate(self):
        return self.K / self.E

    @property
    def E(self):
        """Number of transmitted coded bits (N unless rate-matched)."""
        return self.rm[1] if self.rm else self.N


def _butterfly_np(u):
    """NumPy x = u F^{tensor n} mod 2 (same stages as the device encoder)."""
    u = np.asarray(u, np.int64)
    lead = u.shape[:-1]
    N = u.shape[-1]
    n = int(np.log2(N))
    x = u
    for s in range(n):
        x = x.reshape(lead + (1 << s, 2, N >> (s + 1)))
        x = np.concatenate([x[..., 0:1, :] ^ x[..., 1:2, :], x[..., 1:2, :]],
                           axis=-2)
        x = x.reshape(lead + (N,))
    return x


def polar_construct(N, K, method="bhattacharyya", design_snr_db=2.0,
                    crc=None, E=None, rm_mode="auto", systematic=False):
    """Design an (N, K) polar code for a BPSK/AWGN design Es/N0.

    ``method``: 'bhattacharyya' (BEC-style bound) or 'ga' (Gaussian
    approximation density evolution, exact-quadrature phi).
    ``design_snr_db`` is the design **Es/N0**; set it near the intended
    operating point.  ``crc``: a CrcSpec or a name from CRC_POLYNOMIALS;
    its parity bits also occupy reliable positions.

    ``E`` (optional) rate-matches the mother code to an arbitrary number
    of transmitted bits (block schemes in the style of 5G, not 38.212's
    exact sub-block interleaver):

    * ``E < N`` + ``'shorten'``: the last ``N-E`` codeword bits are
      forced to zero by freezing the last ``N-E`` u-indices (G is lower
      triangular) and are not transmitted; the receiver knows them
      (+huge LLR).  Chosen by 'auto' for rates above 7/16.
    * ``E < N`` + ``'puncture'``: the first ``N-E`` codeword bits are
      not transmitted (0 LLR at the receiver); the first ``N-E``
      u-indices are frozen.  'auto' picks this for low rates.
    * ``E > N`` + ``'repeat'``: the codeword repeats cyclically; the
      receiver adds the repeated LLRs.

    ``systematic=True`` makes the payload (and CRC) appear verbatim at
    the info positions of the codeword (the two-pass encode; G is a GF(2)
    involution).  The property is checked exactly at construction on the
    K_total basis vectors.  Decoders re-encode the decision vector and
    read the payload from the codeword domain.
    """
    if isinstance(crc, str):
        crc = CrcSpec.named(crc)
    n = int(np.log2(N))
    if 1 << n != N:
        raise ValueError(f"N must be a power of two, got {N}")
    k_total = K + (crc.length if crc else 0)
    if not 0 < k_total <= N:
        raise ValueError(f"need 0 < K(+crc)={k_total} <= N={N}")

    rm = None
    forced = np.zeros(N, bool)
    if E is not None and E != N:
        if E <= 0:
            raise ValueError(f"E must be positive, got {E}")
        if E > N:
            if rm_mode not in ("auto", "repeat"):
                raise ValueError(f"E={E} > N={N} requires mode 'repeat'")
            rm = ("repeat", E)
        else:
            s = N - E
            if k_total > E:
                raise ValueError(
                    f"K(+crc)={k_total} cannot fit in E={E} transmitted bits")
            if rm_mode == "auto":
                rm_mode = "shorten" if k_total / E > 7.0 / 16.0 else "puncture"
            if rm_mode == "shorten":
                forced[N - s:] = True
            elif rm_mode == "puncture":
                forced[:s] = True
            else:
                raise ValueError(f"unknown rm_mode {rm_mode!r}")
            rm = (rm_mode, E)

    if method == "bhattacharyya":
        rel = _bhattacharyya_reliability(n, design_snr_db)
    elif method == "ga":
        rel = _ga_reliability(n, design_snr_db)
    else:
        raise ValueError(f"unknown construction method {method!r}")
    # Most reliable first; ties prefer the higher index (the upgraded leg).
    rel = np.where(forced, -np.inf, rel)
    order = np.lexsort((-np.arange(N), -rel))
    frozen = np.ones(N, bool)
    frozen[order[:k_total]] = False
    code = PolarCode(N=N, K=K, frozen=tuple(frozen.tolist()), crc=crc, rm=rm,
                     systematic=systematic)
    if systematic:
        _check_systematic(code)
    return code


def _check_systematic(code):
    """Raise ``ValueError`` unless two-pass encoding reproduces the
    payload at the info positions: checked exactly on the basis,
    mask_A(E(I_A)) re-encoded must be the identity there."""
    A = code.info_positions
    basis = np.zeros((len(A), code.N), np.int64)
    basis[np.arange(len(A)), A] = 1
    mid = _butterfly_np(basis)
    mid[:, code.frozen_mask] = 0
    x = _butterfly_np(mid)
    if not np.array_equal(x[:, A], np.eye(len(A), dtype=np.int64)):
        raise ValueError(
            "info set is not domination-closed: systematic two-pass "
            "encoding does not reproduce the payload for this mask")


def polar_rate_match(code, x, device="cuda"):
    """Codeword [..., N] -> transmitted bits [..., E] per ``code.rm``, on
    ``device``."""
    x = on_device(x, device)
    if not code.rm:
        return x
    mode, E = code.rm
    N = code.N
    if mode == "shorten":
        return x[..., :E]
    if mode == "puncture":
        return x[..., N - E:]
    reps = -(-E // N)  # repeat
    return x.repeat((1,) * (x.ndim - 1) + (reps,))[..., :E]


def polar_rate_recover(code, llr_e, device="cuda"):
    """Transmitted LLRs [..., E] -> mother-code LLRs [..., N] on ``device``.

    Punctured bits get 0 (unknown), shortened bits get +huge (known 0),
    repeated bits add their LLRs, copy after copy in transmission order.
    """
    llr_e = on_device(llr_e, device)
    if not code.rm:
        return llr_e
    mode, E = code.rm
    N = code.N
    lead = tuple(llr_e.shape[:-1])
    if mode == "shorten":
        pad = torch.full(lead + (N - E,), _SHORTEN_LLR, dtype=llr_e.dtype,
                         device=llr_e.device)
        return torch.cat([llr_e, pad], dim=-1)
    if mode == "puncture":
        pad = torch.zeros(lead + (N - E,), dtype=llr_e.dtype,
                          device=llr_e.device)
        return torch.cat([pad, llr_e], dim=-1)
    reps = -(-E // N)  # repeat: sum LLRs of each position's copies
    padded = torch.cat([llr_e, torch.zeros(
        lead + (reps * N - E,), dtype=llr_e.dtype, device=llr_e.device)],
        dim=-1).reshape(lead + (reps, N))
    out = padded[..., 0, :]
    for r in range(1, reps):
        out = out + padded[..., r, :]
    return out


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _butterfly(u):
    r"""x = u @ F^{\otimes n} mod 2 via n reshape-XOR stages. u [..., N]
    integer bits."""
    lead = tuple(u.shape[:-1])
    N = u.shape[-1]
    n = int(np.log2(N))
    x = u
    for s in range(n):
        x = x.reshape(lead + (1 << s, 2, N >> (s + 1)))
        x = torch.cat([x[..., 0:1, :] ^ x[..., 1:2, :], x[..., 1:2, :]],
                      dim=-2)
    return x.reshape(lead + (N,))


@functools.lru_cache(maxsize=64)
def make_polar_encoder(code, device="cuda"):
    """``encode(msg [B, K]) -> codeword [B, N]`` int8 on ``device``;
    appends the CRC if the code has one.  Systematic codes use the
    two-pass (encode, mask, encode) form."""
    dev = resolve_device(device)
    info = device_constant(code.info_positions, dev)
    nonfrozen = device_constant((~code.frozen_mask).astype(np.int8), dev)
    if code.crc:
        crc_tab = device_constant(
            crc_encode_table(code.crc, code.K).astype(np.float32), dev)

    def encode(msg):
        msg = on_device(msg, dev).to(torch.int8)
        if code.crc:
            parity = torch.remainder(msg.to(_F32) @ crc_tab, 2.0)
            msg = torch.cat([msg, parity.to(torch.int8)], dim=-1)
        u = torch.zeros(tuple(msg.shape[:-1]) + (code.N,), dtype=torch.int8,
                        device=dev)
        u[..., info] = msg
        if code.systematic:
            u = _butterfly(u) * nonfrozen
        return _butterfly(u)

    return encode


def polar_encode(code, msg, device="cuda"):
    """Encode payload bits [..., K] -> codeword [..., N] (int8) on
    ``device``."""
    return make_polar_encoder(code, device)(msg)


# ---------------------------------------------------------------------------
# Shared decoder machinery
# ---------------------------------------------------------------------------

def _f_op(a, b, rule):
    if rule == "minsum":
        return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())
    # exact: log((1 + e^{a+b}) / (e^a + e^b))
    return torch.logaddexp(torch.zeros_like(a), a + b) - torch.logaddexp(a, b)


def _g_op(a, b, s):
    return b + (1.0 - 2.0 * s) * a


def _xor_f(a, b):
    """GF(2) add on float 0/1 tensors (exact)."""
    return (a - b).abs()


def _leaf_schedule(N):
    """Static per-leaf levels: (g-level, store-level) for each phi."""
    n = int(np.log2(N))
    t1 = np.empty(N, np.int32)
    t2 = np.empty(N, np.int32)
    t1[0] = n  # leaf 0: no g, full f chain from the channel
    for phi in range(1, N):
        t1[phi] = (phi & -phi).bit_length() - 1  # ntz(phi)
    for phi in range(N):
        t2[phi] = (~phi & (phi + 1)).bit_length() - 1  # ntz(phi+1)
    t2[N - 1] = n  # nothing to store after the last leaf
    return t1, t2


def _block_schedule(nb, n_top):
    """Static per-block levels above the block level, over ``nb`` blocks.

    j1: LLR refresh (n_top = the pure-f chain for block 0, else ntz(m));
    j2: partial-sum store (ntz(m+1), nothing after the last block).
    """
    j1 = np.empty(nb, np.int32)
    j2 = np.empty(nb, np.int32)
    j1[0] = n_top
    for m in range(1, nb):
        j1[m] = (m & -m).bit_length() - 1
    for m in range(nb):
        j2[m] = (~m & (m + 1)).bit_length() - 1
    j2[nb - 1] = n_top
    return j1, j2


def _llr_refresh(L, C, chan, t, stop, n, rule):
    """Refresh the flat LLR buffer ``L`` (level l in rows [2^l, 2^{l+1}))
    in place: one g at level ``t`` (t < n), then f down to level ``stop``;
    ``t == n`` is the pure f chain from the channel ``chan``."""

    def src(level):
        return chan if level == n else L[1 << level:2 << level]

    if t < n:
        s = src(t + 1)
        h = 1 << t
        L[h:2 * h] = _g_op(s[:h], s[h:], C[h:2 * h])
    for lv in range(t - 1, stop - 1, -1):
        s = src(lv + 1)
        h = 1 << lv
        L[h:2 * h] = _f_op(s[:h], s[h:], rule)


def _ps_store(C, beta, t, stop, n):
    """Combine the partial sums ``beta`` of a just-decoded level-``stop``
    subtree with the pending left sums at levels stop..t-1 and store the
    result at level ``t`` of ``C`` (in place; nothing when t == n)."""
    if t == n:
        return
    b = beta
    for lv in range(stop, t):
        h = 1 << lv
        b = torch.cat([_xor_f(C[h:2 * h], b), b])
    C[1 << t:2 << t] = b


def _sc_subtree(alpha, frz, rule):
    """SC decode of one subtree: ``alpha [W, ...]`` level LLRs, ``frz`` a
    host bool mask [W].  Returns (decisions, partial sums), shaped like
    ``alpha``.  An all-frozen subtree decodes to zeros; the rest follows
    the recursive definition, leaf value by leaf value."""
    W = len(frz)
    if frz.all():
        z = torch.zeros_like(alpha)
        return z, z
    if W == 1:
        bit = (alpha < 0).to(alpha.dtype)
        return bit, bit
    h = W // 2
    a, b = alpha[:h], alpha[h:]
    u1, b1 = _sc_subtree(_f_op(a, b, rule), frz[:h], rule)
    u2, b2 = _sc_subtree(_g_op(a, b, b1), frz[h:], rule)
    return torch.cat([u1, u2]), torch.cat([_xor_f(b1, b2), b2])


# ---------------------------------------------------------------------------
# SC decoder
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=64)
def make_polar_sc_decoder(code, rule="minsum", full=False, block_exp=None,
                          dtype="f32", device="cuda"):
    """``decode(llr [B, N]) -> payload [B, K]`` int8 on ``device`` (or all
    N u-decisions if ``full``, frozen positions 0).

    The loop runs over blocks of ``2^block_exp`` leaves: each refreshes
    the carried ``[N, B]`` LLR buffer down to the block level, decodes
    the block's subtree and stores its partial sums.  ``block_exp=None``
    takes :data:`SC_BLOCK_EXP`; the decisions are the same at any block
    size.  ``dtype='bf16'`` keeps the LLR state in bfloat16 (not bit for
    bit with float32; held by BER).
    """
    dev = resolve_device(device)
    N, n = code.N, code.n
    if block_exp is None:
        block_exp = SC_BLOCK_EXP
    bk = min(block_exp, n)
    W, nb = 1 << bk, N >> bk
    frz_blocks = code.frozen_mask.reshape(nb, W)
    payload_pos = device_constant(code.info_positions[:code.K], dev)
    j1, j2 = _block_schedule(nb, n - bk)
    sdtype = torch.bfloat16 if dtype == "bf16" else _F32

    def decode(llr):
        llr = on_device(llr, dev)
        B = llr.shape[0]
        chan = llr.to(sdtype).T.contiguous()  # [N, B]
        L = torch.zeros((N, B), dtype=sdtype, device=dev)
        C = torch.zeros((N, B), dtype=sdtype, device=dev)
        blocks = []
        for m in range(nb):
            if bk < n:
                _llr_refresh(L, C, chan, bk + int(j1[m]), bk, n, rule)
                alpha = L[W:2 * W]
            else:
                alpha = chan
            bits, beta = _sc_subtree(alpha, frz_blocks[m], rule)
            if bk < n:
                _ps_store(C, beta, bk + int(j2[m]), bk, n)
            blocks.append(bits)
        u = torch.cat(blocks).T.to(torch.int8)  # [B, N]
        if full:
            return u
        if code.systematic:
            u = _butterfly(u)  # payload lives in the codeword domain
        return u[:, payload_pos]

    return decode


def polar_sc_decode(code, llr, rule="minsum", device="cuda"):
    """Successive-cancellation decode. llr [B, N] -> payload [B, K] int8."""
    return make_polar_sc_decoder(code, rule=rule, device=device)(llr)


# ---------------------------------------------------------------------------
# SCL decoders
# ---------------------------------------------------------------------------

def _penalty(x, pm_rule):
    """Path-metric penalty ``max(x, 0)`` (approx) or ``softplus(x)``
    (exact, as ``logaddexp(x, 0)``): deciding u=0 against a leaf LLR l
    costs ``_penalty(-l)``, u=1 ``_penalty(l)``."""
    if pm_rule == "approx":
        return torch.clamp_min(x, 0.0)
    return torch.logaddexp(x, torch.zeros_like(x))


def _prune(pm, pen0, pen1, P):
    """Keep the P smallest of the 2P candidates ``bit * P + parent`` (a
    stable sort: equal metrics keep the lower candidate index).  Returns
    (pm_new [P, B], bit [P, B] float32, parent [P, B] int64)."""
    cand = torch.cat([pm + pen0, pm + pen1])  # [2P, B]
    vals, idx = torch.sort(cand, dim=0, stable=True)
    idx = idx[:P]
    return vals[:P], (idx >= P).to(_F32), idx % P


def _permute(state, parent):
    """state [W, P, B] with paths re-ordered: out[:, p] = state[:,
    parent[p]]."""
    return torch.gather(state, 1, parent.unsqueeze(0).expand_as(state))


def _compose(p1, p2):
    """Index maps: p1 (after-first -> before) then p2 (after-second ->
    after-first) -> after-second -> before; None is the identity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    return torch.gather(p1, 0, p2)


def _select(code, u_all, pm, P, crc_h, info_pos, payload_pos, full):
    """CRC-aided (or best-metric) path selection: u_all [B, P, N] int8,
    pm [P, B] -> payload (and the full outputs)."""
    pm_b = pm.T  # [B, P]
    dom = _butterfly(u_all) if code.systematic else u_all
    score = pm_b
    if crc_h is not None:
        bits_f = dom[..., info_pos].to(_F32)  # [B, P, k_total]
        syndrome = torch.remainder(bits_f @ crc_h, 2.0)
        ok = torch.all(syndrome == 0.0, dim=-1)  # [B, P]
        score = score + torch.where(ok, 0.0, _CRC_FAIL)
    winner = torch.argmin(score, dim=-1)  # ties -> lower path index
    best = torch.gather(dom, 1, winner[:, None, None].expand(
        -1, 1, dom.shape[-1]))[:, 0]
    payload = best[:, payload_pos]
    if full:
        return payload, pm_b, u_all
    return payload


def _scl_tables(code, dev):
    crc_h = (device_constant(crc_check_table(code.crc, code.k_total)
                             .astype(np.float32), dev)
             if code.crc else None)
    return (crc_h, device_constant(code.info_positions, dev),
            device_constant(code.info_positions[:code.K], dev))


def _initial_pm(P, B, dev):
    pm = torch.full((P, B), _PM_INACTIVE, dtype=_F32, device=dev)
    pm[0] = 0.0
    return pm


@functools.lru_cache(maxsize=64)
def make_polar_scl_decoder(code, list_size=8, rule="minsum",
                           pm_rule="approx", full=False, block_exp=5,
                           device="cuda"):
    """``decode(llr [B, N]) -> payload [B, K]`` int8 on ``device``
    (CRC-aided selection when the code has a CRC).  With ``full``, returns
    (payload, pm [B, P], u_all [B, P, N]).

    The blocked scan: a loop over blocks of ``2^block_exp`` leaves.
    Within a block the per-leaf prune re-orders only the block's local
    ``[2^k, P, B]`` state and an accumulated path map; the carried
    ``[N, P, B]`` LLR and partial-sum buffers are re-ordered once a block,
    and the block's level partial sums are rebuilt by re-encoding its
    decisions.  Each block's decisions are kept in its end-of-block path
    order with its path map, and a reverse pass re-expresses them in the
    final path order.
    """
    dev = resolve_device(device)
    N, n, P = code.N, code.n, list_size
    bs = min(block_exp, n)
    Wb, nb = 1 << bs, N >> bs
    frz_blocks = code.frozen_mask.reshape(nb, Wb)
    crc_h, info_pos, payload_pos = _scl_tables(code, dev)
    j1, j2 = _block_schedule(nb, n - bs)
    lt1, lt2 = _leaf_schedule(Wb)

    def butterfly_rows(bits):
        """Re-encode block decisions [Wb, P, B] -> level-bs partial sums."""
        x = bits
        tail = tuple(bits.shape[1:])
        for s in range(bs):
            x = x.reshape((1 << s, 2, Wb >> (s + 1)) + tail)
            x = torch.cat([_xor_f(x[:, 0:1], x[:, 1:2]), x[:, 1:2]], dim=1)
            x = x.reshape((Wb,) + tail)
        return x

    def decode(llr):
        llr = on_device(llr, dev)
        B = llr.shape[0]
        chan = llr.to(_F32).T.contiguous()[:, None, :]  # [N, 1, B]
        L = torch.zeros((N, P, B), dtype=_F32, device=dev)
        C = torch.zeros((N, P, B), dtype=_F32, device=dev)
        pm = _initial_pm(P, B, dev)
        ident = torch.arange(P, device=dev)[:, None].expand(P, B)
        bits_all, perms = [], []
        for m in range(nb):
            if bs < n:
                _llr_refresh(L, C, chan, bs + int(j1[m]), bs, n, rule)
                alpha = L[Wb:2 * Wb]  # level-bs rows, block-start order
            else:
                alpha = chan.expand(N, P, B)
            Ll = torch.zeros((Wb, P, B), dtype=_F32, device=dev)
            Cl = torch.zeros((Wb, P, B), dtype=_F32, device=dev)
            bits_blk = torch.zeros((Wb, P, B), dtype=_F32, device=dev)
            acc = ident
            for j in range(Wb):
                _llr_refresh(Ll, Cl, alpha, int(lt1[j]), 0, bs, rule)
                leaf = Ll[1]
                if frz_blocks[m, j]:
                    pm = pm + _penalty(-leaf, pm_rule)
                else:
                    pm, bit, parent = _prune(pm, _penalty(-leaf, pm_rule),
                                             _penalty(leaf, pm_rule), P)
                    Ll, Cl, alpha, bits_blk = (
                        _permute(x, parent) for x in (Ll, Cl, alpha,
                                                      bits_blk))
                    acc = torch.gather(acc, 0, parent)
                    bits_blk[j] = bit
                _ps_store(Cl, bits_blk[j:j + 1], int(lt2[j]), 0, bs)
            if bs < n:
                # one deferred re-ordering of the big carried state
                L, C = _permute(L, acc), _permute(C, acc)
                _ps_store(C, butterfly_rows(bits_blk), bs + int(j2[m]), bs,
                          n)
            bits_all.append(bits_blk)
            perms.append(acc)

        # genealogy: each block's bits (end-of-block path order) in the
        # final path order, composing the block path maps from the end
        cur = ident
        outs = [None] * nb
        for m in range(nb - 1, -1, -1):
            outs[m] = _permute(bits_all[m], cur)
            cur = torch.gather(perms[m], 0, cur)
        u_all = torch.cat(outs).permute(2, 1, 0).to(torch.int8)  # [B, P, N]
        return _select(code, u_all, pm, P, crc_h, info_pos, payload_pos,
                       full)

    return decode


def _frozen_cascade(alpha, rule):
    """Leaf LLRs of an all-frozen subtree, level-parallel.

    With every decision known to be 0 the SC recursion has no sequential
    dependence: each level maps node rows (a; b) to children (f(a, b);
    g(a, b, 0)) in one full-width op pair.  Each leaf value's dataflow is
    the per-leaf recursion's, so the penalties are the same.
    """
    x = alpha  # [W, P, B]
    W = x.shape[0]
    tail = tuple(x.shape[1:])
    for s in range(int(np.log2(W))):
        v = x.reshape((1 << s, 2, W >> (s + 1)) + tail)
        a, b = v[:, 0], v[:, 1]
        x = torch.stack([_f_op(a, b, rule), _g_op(a, b, 0.0)],
                        dim=1).reshape((W,) + tail)
    return x


@functools.lru_cache(maxsize=64)
def make_polar_scl_decoder_unrolled(code, list_size=8, rule="minsum",
                                    pm_rule="approx", full=False,
                                    device="cuda"):
    """SCL decoder specialised to the code's frozen mask; the same
    decisions, path metrics and path order as
    :func:`make_polar_scl_decoder` (with the exact rules the metrics may
    differ in the last bit, decisions equal).

    The decode recurses over the tree: maximal all-frozen subtrees become
    a level-parallel cascade (:func:`_frozen_cascade`) with their
    penalties added leaf by leaf in order; an info leaf prunes the list;
    a node's permutations are deferred to its pending sibling rows (``2W``
    rows for a width-``W`` node), so the decisions come back in the final
    path order without a reverse pass.  Each call issues one small
    operation per tree node: on a GPU the decode is paced by its
    launches.
    """
    dev = resolve_device(device)
    N, P = code.N, list_size
    frozen = code.frozen_mask
    crc_h, info_pos, payload_pos = _scl_tables(code, dev)

    def decode(llr):
        llr = on_device(llr, dev)
        B = llr.shape[0]
        alpha0 = llr.to(_F32).T[:, None, :].expand(N, P, B)

        def rec(alpha, lo, hi, pm):
            """-> (bits [W, P, B] or None if all zero, beta likewise,
            path map [P, B] or None if the identity, pm)."""
            W = hi - lo
            if frozen[lo:hi].all():
                leaf = _frozen_cascade(alpha, rule) if W > 1 else alpha
                pen0 = _penalty(-leaf, pm_rule)
                for w in range(W):  # per-leaf accumulation order
                    pm = pm + pen0[w]
                return None, None, None, pm
            if W == 1:
                pm, bit, parent = _prune(pm, _penalty(-alpha[0], pm_rule),
                                         _penalty(alpha[0], pm_rule), P)
                return bit[None], bit[None], parent, pm
            h = W // 2
            a, b = alpha[:h], alpha[h:]
            u1, b1, p1, pm = rec(_f_op(a, b, rule), lo, lo + h, pm)
            if p1 is not None:
                ab = _permute(torch.cat([a, b]), p1)
                a, b = ab[:h], ab[h:]
            galpha = _g_op(a, b, 0.0) if b1 is None else _g_op(a, b, b1)
            u2, b2, p2, pm = rec(galpha, lo + h, hi, pm)
            if p2 is not None and u1 is not None:
                stk = _permute(torch.cat([u1, b1]), p2)
                u1, b1 = stk[:h], stk[h:]
            perm = _compose(p1, p2)
            if u1 is None:
                zeros = torch.zeros((h, P, B), dtype=_F32, device=dev)
                bits = torch.cat([zeros, u2])
                beta = torch.cat([b2, b2])
            elif u2 is None:
                zeros = torch.zeros((h, P, B), dtype=_F32, device=dev)
                bits = torch.cat([u1, zeros])
                beta = torch.cat([b1, zeros])
            else:
                bits = torch.cat([u1, u2])
                beta = torch.cat([_xor_f(b1, b2), b2])
            return bits, beta, perm, pm

        bits, _, _, pm = rec(alpha0, 0, N, _initial_pm(P, B, dev))
        if bits is None:  # degenerate all-frozen code
            bits = torch.zeros((N, P, B), dtype=_F32, device=dev)
        u_all = bits.permute(2, 1, 0).to(torch.int8)  # [B, P, N]
        return _select(code, u_all, pm, P, crc_h, info_pos, payload_pos,
                       full)

    return decode


def polar_scl_route(code, list_size, rule, pm_rule, backend,
                    device_type) -> str:
    """The list decoder's route for ``code`` on a ``device_type`` device:
    ``'kernel'`` (K7), ``'unrolled'``
    (:func:`make_polar_scl_decoder_unrolled`) or ``'scan'``
    (:func:`make_polar_scl_decoder`).

    ``backend='auto'`` takes K7 on the card for every code its plan takes
    (:func:`~commpy_tpu_torch.kernels.polar_scl.polar_scl_plan`: N <= 1024,
    L <= 8, min-sum, approximate metric, non-systematic), the unrolled
    decoder for the rest of the card's, and the scan on the CPU;
    ``'torch'`` takes the plain decoders on any device; ``'cuda'`` raises
    unless the device is the card and K7 takes the code.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got "
                         f"{backend!r}")
    takes = _k7.polar_scl_plan(
        code.N, list_size, rule, pm_rule, code.systematic,
        code.crc.length if code.crc else 0) is not None
    if backend == "cuda":
        if device_type != "cuda":
            raise ValueError("backend='cuda' needs a CUDA tensor, got one on "
                             f"{device_type}")
        if not takes:
            raise NotImplementedError(
                f"backend='cuda' takes non-systematic codes of N <= "
                f"{_k7.MAX_N} with at most {_k7.MAX_LIST} paths, min-sum "
                f"and the approximate metric (got N = {code.N}, "
                f"list_size = {list_size}, rule = {rule!r}, pm_rule = "
                f"{pm_rule!r}, systematic = {code.systematic}); use "
                "backend='auto'")
        return "kernel"
    if device_type != "cuda":
        return "scan"
    return "kernel" if backend == "auto" and takes else "unrolled"


@functools.lru_cache(maxsize=64)
def make_polar_scl_route(code, list_size=8, rule="minsum", pm_rule="approx",
                         backend="auto", device="cuda"):
    """``decode(llr [B, N]) -> payload [B, K]`` int8 on ``device`` by
    :func:`polar_scl_route`'s choice, made once here."""
    dev = resolve_device(device)
    route = polar_scl_route(code, list_size, rule, pm_rule, backend,
                            dev.type)
    if route == "kernel":
        return _k7.make_polar_scl_kernel(code, list_size, device=dev)
    make = (make_polar_scl_decoder_unrolled if route == "unrolled"
            else make_polar_scl_decoder)
    return make(code, list_size=list_size, rule=rule, pm_rule=pm_rule,
                device=dev)


def polar_scl_decode(code, llr, list_size=8, rule="minsum", pm_rule="approx",
                     backend="auto", device="cuda"):
    """List decode. llr [B, N] -> payload [B, K] int8 (CRC-aided if set).

    The route (:func:`polar_scl_route`): on a GPU K7 for the codes it
    takes and the decoder specialised to the frozen mask
    (:func:`make_polar_scl_decoder_unrolled`) for the rest; on the CPU the
    blocked scan (:func:`make_polar_scl_decoder`).  Their outputs are the
    same.
    """
    return make_polar_scl_route(code, list_size=list_size, rule=rule,
                                pm_rule=pm_rule, backend=backend,
                                device=device)(llr)
