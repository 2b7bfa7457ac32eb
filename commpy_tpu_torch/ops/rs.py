r"""Reed-Solomon codes over GF(2^m): construction, encode, decode.

Counterpart of ``commpy_tpu/ops/rs.py`` (the reference has no algebraic
codec): t-symbol-error-correcting RS, the outer code of DVB-T
(RS(204,188), fcr=0) and CCSDS (RS(255,223)).

The device path shares the bit-sliced GF(2^m) machinery of the BCH codec
(:mod:`commpy_tpu_torch.ops.gf2m`): systematic parity and syndromes are
single GF(2) products of the symbol BITS, Berlekamp-Massey runs
inversionless for 2t steps, and both the Chien search and the Forney
evaluator (x^{1-fcr} * Omega at the locator roots, divided by Lambda'
through Fermat-inverse squaring chains) are blocked constant-matrix
evaluations.

Conventions: wire symbol j carries polynomial coefficient x^{n-1-j}
(message first, parity high-degree first); g(x) = prod_{j=fcr}^{fcr+2t-1}
(x - alpha^j) with ``fcr`` in {0, 1}; shortening drops leading message
symbols (virtual zeros).  Symbol bits are LSB-first (:func:`_sym_to_bits`,
:func:`_bits_to_sym`), unlike the MSB-first bits elsewhere; the
conversion back to symbols is integer arithmetic, exact for any m.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..utils.device import on_device, resolve_device
from .gf2m import (
    bm_inversionless,
    chien_tables,
    conv_xor,
    gf_constant_mult_matrix,
    gf_inverse_bits,
    gf_reduce_matrix,
    gf_square_matrix,
    gf_table,
    gf_tables,
    mod2,
)

__all__ = [
    "RsCode",
    "rs_construct",
    "rs_genpoly",
    "rs_encode",
    "rs_decode",
    "rs_errata_decode",
    "rs_gmd_decode",
    "make_rs_encoder",
    "make_rs_decoder",
    "make_rs_errata_decoder",
    "make_rs_gmd_decoder",
]


def rs_genpoly(m, t, fcr=1):
    """g(x) = prod_{j=fcr}^{fcr+2t-1} (x - alpha^j); field-element
    coefficients, lowest degree first."""
    exp, log = gf_tables(m)
    size = (1 << m) - 1

    def gmul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(exp[(log[a] + log[b]) % size])

    g = [1]
    for j in range(fcr, fcr + 2 * t):
        root = int(exp[j % size])
        new = [0] * (len(g) + 1)
        for i, c in enumerate(g):  # g * (x + root)
            new[i + 1] ^= c
            new[i] ^= gmul(root, c)
        g = new
    return tuple(g)


@dataclass(frozen=True)
class RsCode:
    """A (possibly shortened) Reed-Solomon code over GF(2^m).

    ``n``/``k`` count transmitted SYMBOLS; t = n_parity / 2 symbol errors
    are correctable.  ``fcr`` is the first consecutive root exponent
    (1 = narrow sense; 0 = the DVB/CCSDS convention).
    """

    n: int
    k: int
    m: int
    t: int
    fcr: int
    genpoly: tuple  # field-element coefficients, low-degree first

    @property
    def n_parent(self):
        return (1 << self.m) - 1

    @property
    def n_parity(self):
        return 2 * self.t

    @property
    def shortening(self):
        return self.n_parent - self.n


def rs_construct(m, t, shorten=0, fcr=1):
    """Build the t-symbol-error RS code of length 2^m - 1 - shorten."""
    if not 2 <= m <= 16:
        raise ValueError(f"need 2 <= m <= 16, got {m}")
    if fcr not in (0, 1):
        raise ValueError("fcr must be 0 or 1")
    n_parent = (1 << m) - 1
    k = n_parent - 2 * t - shorten
    if k <= 0:
        raise ValueError(
            f"no message symbols left: 2^{m}-1 = {n_parent}, parity "
            f"{2 * t}, shorten {shorten}")
    return RsCode(n=n_parent - shorten, k=k, m=m, t=t, fcr=fcr,
                  genpoly=rs_genpoly(m, t, fcr))


def _symbol_remainders(code):
    """[n_parent, 2t] field elements: x^deg mod g for every degree."""
    exp, log = gf_tables(code.m)
    size = code.n_parent
    g = np.asarray(code.genpoly, np.int64)
    r = len(g) - 1  # == 2t

    def gmul(a, b):
        if a == 0 or b == 0:
            return 0
        return int(exp[(log[a] + log[b]) % size])

    rows = np.zeros((size, r), np.int64)
    rem = np.zeros(r, np.int64)
    rem[0] = 1
    for deg in range(size):
        rows[deg] = rem
        top = int(rem[r - 1])
        rem = np.concatenate([[0], rem[:r - 1]])
        if top:
            # x^r = g[:r] (monic g): subtract top * g
            rem ^= np.array([gmul(top, int(c)) for c in g[:r]], np.int64)
    return rows


def _parity_table_bits(code):
    """[k*m, 2t*m] GF(2) matrix: parity bits = msg bits @ P."""
    m, t = code.m, code.t
    rows = _symbol_remainders(code)
    degs = code.n - 1 - np.arange(code.k)  # message symbol j -> x^{n-1-j}
    P = np.zeros((code.k * m, 2 * t * m), np.int64)
    for j in range(code.k):
        rem = rows[degs[j]]
        for el in range(2 * t):
            if rem[el]:
                Mm = gf_constant_mult_matrix(int(rem[el]), m)
                # parity wire slot p carries coefficient degree 2t-1-p
                p = 2 * t - 1 - el
                P[j * m:(j + 1) * m, p * m:(p + 1) * m] = Mm
    return P


def _syndrome_table_bits(code):
    """[n*m, 2t*m] GF(2) matrix: syndrome bits = received bits @ S, with
    S_i = r(alpha^{fcr+i}) for i = 0..2t-1."""
    m, t = code.m, code.t
    exp, _ = gf_tables(m)
    size = code.n_parent
    degs = code.n - 1 - np.arange(code.n)
    S = np.zeros((code.n * m, 2 * t * m), np.int64)
    for p in range(code.n):
        for i in range(2 * t):
            c = int(exp[((code.fcr + i) * int(degs[p])) % size])
            Mm = gf_constant_mult_matrix(c, m)
            S[p * m:(p + 1) * m, i * m:(i + 1) * m] = Mm
    return S


def _sym_to_bits(x, m):
    """int symbols [..., n] -> float32 bit slices [..., n, m], LSB first."""
    shifts = torch.arange(m, dtype=torch.int32, device=x.device)
    return ((x.to(torch.int32)[..., None] >> shifts) & 1).to(torch.float32)


def _bits_to_sym(bits, m):
    """0/1 bit slices [..., n, m] (any dtype) -> int32 symbols [..., n],
    LSB first, in integer arithmetic."""
    shifts = torch.arange(m, dtype=torch.int32, device=bits.device)
    return (bits.to(torch.int32) << shifts).sum(-1, dtype=torch.int32)


@functools.lru_cache(maxsize=32)
def make_rs_encoder(code, device="cuda"):
    """``encode(msg symbols [B, k]) -> codeword [B, n]`` int32 on
    ``device``."""
    dev = resolve_device(device)
    m = code.m
    P = gf_table(_parity_table_bits(code), dev)

    def encode(msg):
        bits = _sym_to_bits(on_device(msg, dev), m)  # [B, k, m]
        flat = bits.reshape(bits.shape[:-2] + (code.k * m,))
        parity = mod2(flat @ P).reshape(bits.shape[:-2] + (2 * code.t, m))
        return torch.cat([_bits_to_sym(bits, m), _bits_to_sym(parity, m)],
                         dim=-1)

    return encode


def rs_encode(code, msg, device="cuda"):
    """Systematic RS encode on ``device``: symbol ints [..., k] ->
    [..., n]."""
    return make_rs_encoder(code, device)(msg)


def _forney_tables(code, D, lam_deg, dv_deg, dev):
    """The blocked evaluators of the locator, Forney's numerator
    X^{1-fcr} Omega(X^{-1}) (coefficient omega_u at exponent
    u - (1 - fcr)) and the locator's derivative."""
    m, t, size = code.m, code.t, code.n_parent
    om_exps = [u - (1 - code.fcr) for u in range(2 * t)]
    tabs = (chien_tables(m, lam_deg, size, D),
            chien_tables(m, 2 * t - 1, size, D, exps=om_exps),
            chien_tables(m, dv_deg, size, D))
    return [(gf_table(e, dev), gf_table(s, dev)) for e, s in tabs]


def _chien_forney(code, D, tables, mu, SQ_mat, R_mat):
    """Roots [B, n_parent] and error magnitudes [B, n_parent, m] from the
    block coefficients ``mu = (locator, omega, derivative)``."""
    m = code.m
    size = code.n_parent
    B = mu[0].shape[0]
    roots, mags = [], []
    for _ in range(-(-size // D)):
        lv, ov, dvv = (mod2(x @ ev).reshape(B, D, m)
                       for x, (ev, _) in zip(mu, tables))
        is_root = ~torch.any(lv > 0, dim=-1)
        # e = omega_eff(Xinv) * inv(Lambda'(Xinv)) at the roots
        inv_d = gf_inverse_bits(dvv, m, SQ_mat, R_mat)
        mag = conv_xor(ov, inv_d, m, R_mat) * is_root[..., None]
        roots.append(is_root)
        mags.append(mag)
        mu = [mod2(x @ st) for x, (_, st) in zip(mu, tables)]
    return (torch.cat(roots, dim=1)[:, :size],
            torch.cat(mags, dim=1)[:, :size])


def _omega(lam, synd, t, n_lam, m, R_mat):
    """Omega = S(x) * Lambda(x) mod x^{2t} (bit-sliced convolution)."""
    om = torch.zeros_like(synd)
    for j in range(n_lam):
        om[:, j:] += conv_xor(lam[:, j:j + 1, :], synd[:, :2 * t - j, :], m,
                              R_mat)
    return mod2(om)


def _finish(code, r_syms, r_bits, roots, mags, Lr, degs, extra_ok=None):
    """Correct the received word at the in-range roots and flag success."""
    err_wire = roots[:, degs]  # [B, n]
    corrected = _bits_to_sym(mod2(r_bits + mags[:, degs]), code.m)
    total_roots = roots.sum(-1, dtype=torch.int32)
    in_range = err_wire.sum(-1, dtype=torch.int32)
    ok = (total_roots == Lr) & (in_range == total_roots)
    if extra_ok is not None:
        ok = ok & extra_ok
    corrected = torch.where(ok[:, None], corrected, r_syms.to(torch.int32))
    return corrected, in_range, ok


@functools.lru_cache(maxsize=32)
def make_rs_decoder(code, chien_block=None, device="cuda"):
    """``decode(received symbols [B, n]) -> (corrected [B, n] int32,
    n_err [B] int32, ok [B] bool)`` on ``device``.

    ``n_err`` counts corrected SYMBOL errors; ``ok`` False flags a
    detected failure (> t errors), and the received word is returned as
    it is.
    """
    dev = resolve_device(device)
    m, t = code.m, code.t
    if chien_block is None:
        chien_block = min(512, code.n_parent)
    D = chien_block
    S_tab = gf_table(_syndrome_table_bits(code), dev)
    R_mat = gf_table(gf_reduce_matrix(m), dev)
    SQ_mat = gf_table(gf_square_matrix(m), dev)
    # Lambda'(x): coefficients d_j = lam_{j+1} for even j, else 0
    tables = _forney_tables(code, D, t, max(t - 1, 0), dev)
    dmask = np.zeros(max(t, 1), np.float32)
    dmask[0::2] = 1.0
    dmask = torch.as_tensor(dmask, device=dev)[None, :, None]
    degs = torch.as_tensor(code.n - 1 - np.arange(code.n), device=dev)

    def decode(r_syms):
        r_syms = on_device(r_syms, dev)
        B = r_syms.shape[0]
        r_bits = _sym_to_bits(r_syms, m)  # [B, n, m]
        synd = mod2(r_bits.reshape(B, code.n * m) @ S_tab).reshape(
            B, 2 * t, m)
        lam, Lr = bm_inversionless(synd, t, m, R_mat)
        om = _omega(lam, synd, t, t + 1, m, R_mat)
        dv = lam[:, 1:t + 1, :] * dmask
        mu = [lam.reshape(B, -1), om.reshape(B, -1), dv.reshape(B, -1)]
        roots, mags = _chien_forney(code, D, tables, mu, SQ_mat, R_mat)
        return _finish(code, r_syms, r_bits, roots, mags, Lr, degs)

    return decode


def rs_decode(code, r_syms, device="cuda"):
    """Hard-decision decode on ``device``: [B, n] symbol ints ->
    (corrected, n_errors, ok).  On failure (ok=False) the received word
    is returned as it is."""
    return make_rs_decoder(code, device=device)(r_syms)


@functools.lru_cache(maxsize=32)
def make_rs_errata_decoder(code, chien_block=None, device="cuda"):
    """``decode(r_syms [B, n], erasure_mask [B, n]) -> (corrected,
    n_errata, ok)`` on ``device``: errors-AND-erasures decoding.

    Corrects e errors plus f flagged erasures whenever 2e + f <= 2t.
    The erasure locator Gamma = prod (1 + X_i x) is built position by
    position (n steps of constant-multiply matrices); Berlekamp-Massey
    starts from (Gamma, L=f) with its first f iterations masked per
    word, which yields the errata locator Psi = Lambda * Gamma; Chien and
    Forney run at degree 2t.  With an empty mask it decodes as
    :func:`make_rs_decoder`.
    """
    dev = resolve_device(device)
    m, t = code.m, code.t
    if chien_block is None:
        chien_block = min(512, code.n_parent)
    D = chien_block
    size = code.n_parent
    exp, _ = gf_tables(m)
    S_tab = gf_table(_syndrome_table_bits(code), dev)
    R_mat = gf_table(gf_reduce_matrix(m), dev)
    SQ_mat = gf_table(gf_square_matrix(m), dev)
    ns = 2 * t + 1  # the errata locator reaches degree 2t
    tables = _forney_tables(code, D, 2 * t, 2 * t - 1, dev)
    dmask = np.zeros(2 * t, np.float32)
    dmask[0::2] = 1.0
    dmask = torch.as_tensor(dmask, device=dev)[None, :, None]
    degs_np = code.n - 1 - np.arange(code.n)
    degs = torch.as_tensor(degs_np, device=dev)
    # per-position X_p = alpha^{deg_p} constant-multiply matrices
    Mx = gf_table(np.stack([gf_constant_mult_matrix(int(exp[int(d) % size]), m)
                        for d in degs_np]), dev)  # [n, m, m]

    def decode(r_syms, erasure_mask):
        r_syms = on_device(r_syms, dev)
        B = r_syms.shape[0]
        mask = on_device(erasure_mask, dev).to(torch.float32)  # [B, n]
        r_bits = _sym_to_bits(r_syms, m)
        synd = mod2(r_bits.reshape(B, code.n * m) @ S_tab).reshape(
            B, 2 * t, m)
        # Gamma = prod over erased p of (1 + X_p x), degree capped at 2t
        gamma = torch.zeros((B, ns, m), dtype=torch.float32, device=dev)
        gamma[:, 0, 0] = 1.0
        for p in range(code.n):
            prod = mod2(gamma @ Mx[p])  # [B, ns, m]
            shifted = torch.cat([prod.new_zeros((B, 1, m)), prod[:, :-1]],
                                dim=1)
            gamma = mod2(gamma + mask[:, p, None, None] * shifted)
        f = mask.sum(-1).to(torch.int32)  # [B]
        lam, Lr = bm_inversionless(synd, t, m, R_mat, nslots=ns,
                                   init=(gamma, f), start=f, nf=f)
        om = _omega(lam, synd, t, 2 * t, m, R_mat)
        dv = lam[:, 1:, :] * dmask  # Psi' (char-2 derivative)
        mu = [lam.reshape(B, -1), om.reshape(B, -1), dv.reshape(B, -1)]
        roots, mags = _chien_forney(code, D, tables, mu, SQ_mat, R_mat)
        return _finish(code, r_syms, r_bits, roots, mags, Lr, degs,
                       extra_ok=f <= 2 * t)

    return decode


def rs_errata_decode(code, r_syms, erasure_mask, device="cuda"):
    """Errors-and-erasures decode on ``device``: corrects e errors + f
    erasures while 2e + f <= 2t.  Returns (corrected, n_errata, ok)."""
    return make_rs_errata_decoder(code, device=device)(r_syms, erasure_mask)


@functools.lru_cache(maxsize=32)
def make_rs_gmd_decoder(code, chien_block=None, device="cuda"):
    """``decode(r_syms [B, n], reliability [B, n]) -> (corrected,
    n_errata, ok)`` on ``device``: Forney's Generalized Minimum Distance
    soft decoding.

    Runs t+1 errors-and-erasures trials, erasing the 0, 2, ..., 2t
    least-reliable symbols, as one batched errata decode, then keeps the
    successful candidate with the smallest soft discrepancy (the sum of
    reliabilities where it changed the word).  Meant for informative
    reliabilities (burst flags, fading nulls); on plain AWGN |LLR|
    spreads hard decoding is the better tool, as the JAX package's
    docstring records.  Falls back to the received word with ok=False
    when no trial succeeds.
    """
    dev = resolve_device(device)
    errata = make_rs_errata_decoder(code, chien_block=chien_block,
                                    device=dev)
    n_trials = code.t + 1

    def decode(r_syms, reliability):
        r_syms = on_device(r_syms, dev)
        rel = on_device(reliability, dev).to(torch.float32)
        B, n = r_syms.shape
        # rank[b, i] = how many symbols are less reliable than i
        order = torch.argsort(rel, dim=-1, stable=True)
        rank = torch.argsort(order, dim=-1, stable=True)
        # trial j erases rank < 2j
        trials = 2 * torch.arange(n_trials, device=dev)
        masks = rank[:, None, :] < trials[None, :, None]
        rx_t = r_syms[:, None, :].expand(B, n_trials, n)
        corr, nerr, ok = errata(rx_t.reshape(B * n_trials, n),
                                masks.reshape(B * n_trials, n))
        corr = corr.reshape(B, n_trials, n)
        nerr = nerr.reshape(B, n_trials)
        ok = ok.reshape(B, n_trials)
        changed = (corr != r_syms[:, None, :]).to(torch.float32)
        score = torch.sum(changed * rel[:, None, :], dim=-1)
        score = torch.where(ok, score, torch.inf)
        best = torch.argmin(score, dim=-1)  # [B]
        any_ok = torch.any(ok, dim=-1)
        corrected = torch.gather(corr, 1,
                                 best[:, None, None].expand(-1, 1, n))[:, 0]
        corrected = torch.where(any_ok[:, None], corrected,
                                r_syms.to(torch.int32))
        n_out = torch.gather(nerr, 1, best[:, None])[:, 0]
        n_out = torch.where(any_ok, n_out, 0)
        return corrected, n_out, any_ok

    return decode


def rs_gmd_decode(code, r_syms, reliability, device="cuda"):
    """GMD soft-decision decode on ``device`` (t+1 batched erasure
    trials).  ``reliability`` [B, n]: larger = more trustworthy symbol
    (e.g. the minimum |LLR| over its bits).  Returns (corrected,
    n_errata, ok)."""
    return make_rs_gmd_decoder(code, device=device)(r_syms, reliability)
