r"""BCH codes: construction, systematic encoding, hard and Chase decoding.

Counterpart of ``commpy_tpu/ops/bch.py`` (the reference ships no
algebraic codec): t-error-correcting binary BCH, DVB-S2's outer code.
Everything on the device is bit-sliced GF(2^m) linear algebra
(:mod:`commpy_tpu_torch.ops.gf2m`):

* **Encoding**: ``parity = msg @ P mod 2``, ``P`` the x^j-mod-g table.
* **Syndromes**: ``synd_bits = r @ S mod 2``, S[i, (j,b)] = bit b of
  alpha^{i(j+1)}.  One [B, n] @ [n, 2t*m] product.
* **Locator**: the inversionless Berlekamp-Massey recurrence, 2t steps,
  or at t = 2 the closed-form quadratic (``locator='quad'``).
* **Chien search over the parent length**: within a block of D
  positions the evaluation is one ``[B, (t+1)m] @ [(t+1)m, D*m]``
  product; between blocks the coefficients advance by a constant map.
  ``ceil(n_parent / D)`` blocks: roots in the shortened prefix count
  toward the ``ok`` flag, so the search does not stop at n.

The products are plain ``torch.matmul`` on float32 0/1 operands (the
JAX package leaves them to XLA too); the module's constant tables are
built once per code and device.  Results equal the JAX package's bit
for bit (see gf2m's note on exactness).  Chase candidates are ranked by
float32 soft scores, summed as PyTorch sums them.
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
    gf_reduce_matrix,
    gf_square_matrix,
    gf_table,
    gf_tables,
    mod2 as _mod2,
)

__all__ = [
    "BchCode",
    "bch_construct",
    "bch_genpoly",
    "bch_encode",
    "bch_decode",
    "bch_chase_decode",
    "make_bch_encoder",
    "make_bch_decoder",
    "make_bch_chase_decoder",
    "make_bch_chase_soft",
]


# ---------------------------------------------------------------------------
# Host-side code construction
# ---------------------------------------------------------------------------

def _poly_mul_gf2(a, b):
    """Multiply GF(2)[x] polynomials given as coefficient int arrays."""
    out = np.zeros(len(a) + len(b) - 1, np.int64)
    for i, ai in enumerate(a):
        if ai:
            out[i:i + len(b)] ^= np.asarray(b, np.int64)
    return out


def bch_genpoly(m, t):
    """Generator polynomial of the primitive t-error BCH of length 2^m-1.

    LCM of the minimal polynomials of alpha^1..alpha^{2t}, as a
    coefficient array, lowest degree first.
    """
    exp, log = gf_tables(m)
    size = (1 << m) - 1
    covered = set()
    g = np.array([1], np.int64)
    for j in range(1, 2 * t + 1):
        if j % size in covered:
            continue
        coset = []
        c = j % size
        while c not in coset:
            coset.append(c)
            c = (2 * c) % size
        covered.update(coset)
        # minimal poly = prod (x - alpha^c) over GF(2^m), checked binary
        poly = np.array([1], np.int64)
        for c in coset:
            root = exp[c]
            shifted = np.concatenate([[0], poly])
            scaled = np.array(
                [exp[(log[p] + log[root]) % size] if p else 0 for p in poly]
                + [0], np.int64)
            poly = shifted ^ scaled
        if np.any(poly > 1):
            raise AssertionError("minimal polynomial is not binary")
        g = _poly_mul_gf2(g, poly)
    return g


@dataclass(frozen=True)
class BchCode:
    """A (possibly shortened) binary BCH code.

    ``n``/``k`` are the transmitted lengths; ``m``/``t`` define the parent
    primitive code of length 2^m - 1 (shortening drops leading message
    bits, which both ends treat as zeros).
    """

    n: int
    k: int
    m: int
    t: int
    genpoly: tuple  # low-degree-first coefficients

    @property
    def n_parent(self):
        return (1 << self.m) - 1

    @property
    def n_parity(self):
        return len(self.genpoly) - 1

    @property
    def shortening(self):
        return self.n_parent - self.n


def bch_construct(m, t, shorten=0):
    """Build the t-error-correcting BCH code of length 2^m - 1 - shorten."""
    if not 2 <= m <= 16:
        raise ValueError(f"need 2 <= m <= 16, got {m}")
    g = bch_genpoly(m, t)
    n_parent = (1 << m) - 1
    r = len(g) - 1
    k = n_parent - r - shorten
    if k <= 0:
        raise ValueError(
            f"no message bits left: 2^{m}-1 = {n_parent}, parity {r}, "
            f"shorten {shorten}")
    return BchCode(n=n_parent - shorten, k=k, m=m, t=t,
                   genpoly=tuple(int(c) for c in g))


def _parity_table(code):
    """[k, r] GF(2) matrix: parity = msg @ P.

    Row j is x^{n-1-j} mod g (message bit j rides coefficient x^{n-1-j};
    parity occupies the low-degree coefficients), built by multiplying by
    x degree after degree: O(n * r).
    """
    g = np.asarray(code.genpoly, np.int64)
    r = len(g) - 1
    rows = np.zeros((code.n_parent, r), np.int64)
    rem = np.zeros(r, np.int64)
    rem[0] = 1  # x^0
    for deg in range(code.n_parent):
        rows[deg] = rem
        carry = rem[r - 1]
        rem = np.concatenate([[0], rem[:r - 1]])
        if carry:
            rem ^= g[:r]
    degs = code.n - 1 - np.arange(code.k)
    # parity wire position k + j carries coefficient x^{r-1-j}
    return rows[degs][:, ::-1]


def _syndrome_table(code):
    """[n, 2t*m] GF(2) matrix: syndrome bits = r @ S.

    Wire position i carries coefficient x^{n-1-i}; S_j = r(alpha^j) for
    j = 1..2t.
    """
    exp, _ = gf_tables(code.m)
    size = code.n_parent
    degs = code.n - 1 - np.arange(code.n)
    tab = np.zeros((code.n, 2 * code.t * code.m), np.int64)
    for j in range(1, 2 * code.t + 1):
        vals = exp[(degs * j) % size]  # alpha^{deg * j}
        bits = (vals[:, None] >> np.arange(code.m)[None, :]) & 1
        tab[:, (j - 1) * code.m:j * code.m] = bits
    return tab


# ---------------------------------------------------------------------------
# Device encoder and decoders
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=32)
def make_bch_encoder(code, device="cuda"):
    """``encode(msg [B, k] 0/1) -> codeword [B, n]`` int8 on ``device``,
    systematic (message first)."""
    dev = resolve_device(device)
    P = gf_table(_parity_table(code), dev)

    def encode(msg):
        msg_f = on_device(msg, dev).to(torch.float32)
        parity = _mod2(msg_f @ P)
        return torch.cat([msg_f, parity], dim=-1).to(torch.int8)

    return encode


def bch_encode(code, msg, device="cuda"):
    """Systematic BCH encode on ``device``: [..., k] -> [..., n]."""
    return make_bch_encoder(code, device)(msg)


@functools.lru_cache(maxsize=32)
def make_bch_decoder(code, chien_block=None, locator="auto", device="cuda"):
    """``decode(hard bits [B, n]) -> (corrected [B, n] int8, n_err [B]
    int32, ok [B] bool)`` on ``device``.

    ``ok`` is False where decoding failed (more than t errors detected:
    the locator degree disagrees with its root count, or a root lies in
    the shortened prefix).  One syndrome product, the locator, then
    ``ceil(n_parent / D)`` Chien products.

    ``locator``: 'bm' runs the 2t-step inversionless Berlekamp-Massey;
    'quad' (t = 2 only) takes the closed form ``Lambda(x) ~ S1 + S1^2 x +
    (S3 + S1^3) x^2`` (the usual quadratic scaled by S1, the same roots);
    'auto' takes 'quad' at t = 2.  Both give the same corrections and ok
    flags on decodable words and flag ok=False past t.
    """
    dev = resolve_device(device)
    m, t, n = code.m, code.t, code.n
    if locator not in ("auto", "bm", "quad"):
        raise ValueError("locator must be 'auto', 'bm', or 'quad'")
    if locator == "quad" and t != 2:
        raise ValueError("the closed-form locator applies to t=2 only")
    use_quad = (locator == "quad") or (locator == "auto" and t == 2)
    if chien_block is None:
        chien_block = min(512, code.n_parent)
    D = chien_block
    S_tab = gf_table(_syndrome_table(code), dev)
    R_mat = gf_table(gf_reduce_matrix(m), dev)
    SQ_mat = gf_table(gf_square_matrix(m), dev)
    eval_np, step_np = chien_tables(m, t, code.n_parent, D)
    eval_mat, step_mat = gf_table(eval_np, dev), gf_table(step_np, dev)
    n_blocks = -(-code.n_parent // D)
    # wire position j carries coefficient x^{n-1-j}
    degs = torch.as_tensor(code.n - 1 - np.arange(n), device=dev)

    def _mul_rows(a, b):
        """Bit-sliced GF(2^m) product, lanes-major [m, B] x [m, B]."""
        outer = a[:, None, :] * b[None, :, :]  # [m, m, B] float32 counts
        conv = outer.new_zeros((2 * m - 1,) + a.shape[1:])
        for i in range(m):
            conv[i:i + m] += outer[i]
        return _mod2(R_mat.T @ _mod2(conv))

    def _quad_locator(synd):
        """Closed-form t=2 locator: lam [B, 3, m], Lr [B]."""
        s1 = synd[:, 0].T  # [m, B]
        s3 = synd[:, 2].T
        s1_2 = _mod2(SQ_mat.T @ s1)             # S1^2 (a linear map)
        s1_3 = _mul_rows(s1_2, s1)              # S1^3
        lam2 = _mod2(s3 + s1_3)                 # S3 + S1^3
        s1_nz = torch.any(s1 > 0, dim=0)        # [B]
        s3_nz = torch.any(s3 > 0, dim=0)
        # S1 != 0: Lambda' = [S1, S1^2, S3+S1^3], L = 2 or 1
        # S1 == 0, S3 == 0: no errors: Lambda = [1, 0, 0], L = 0
        # S1 == 0, S3 != 0: uncorrectable: Lambda = 1 (no roots), L = 1
        one = torch.zeros_like(s1)
        one[0] = 1.0
        lam0 = torch.where(s1_nz[None, :], s1, one)
        lam1 = torch.where(s1_nz[None, :], s1_2, 0.0)
        lam2 = torch.where(s1_nz[None, :], lam2, 0.0)
        Lr = torch.where(
            s1_nz, torch.where(torch.any(lam2 > 0, dim=0), 2, 1),
            torch.where(s3_nz, 1, 0)).to(torch.int32)
        lam = torch.stack([lam0, lam1, lam2], dim=0)  # [3, m, B]
        return lam.permute(2, 0, 1), Lr

    def decode(r_bits):
        r_bits = on_device(r_bits, dev)
        B = r_bits.shape[0]
        synd = _mod2(r_bits.to(torch.float32) @ S_tab).reshape(B, 2 * t, m)
        if use_quad:
            lam, Lr = _quad_locator(synd)
        else:
            lam, Lr = bm_inversionless(synd, t, m, R_mat)

        # blocked Chien search over the parent length
        mu = lam.reshape(B, (t + 1) * m)
        roots = []
        for _ in range(n_blocks):
            vals = _mod2(mu @ eval_mat).reshape(B, D, m)
            roots.append(~torch.any(vals > 0, dim=-1))  # Lambda == 0
            mu = _mod2(mu @ step_mat)
        # roots[:, b0*D + d] flags a root at alpha^{-(b0*D+d)}: an error
        # at coefficient degree b0*D + d
        roots = torch.cat(roots, dim=-1)[:, :code.n_parent]
        err_wire = roots[:, degs]  # [B, n]
        corrected = torch.bitwise_xor(r_bits.to(torch.int8),
                                      err_wire.to(torch.int8))
        # success: locator degree == number of roots, all of them inside
        # the transmitted length (a root in the shortened prefix is a
        # miscorrection)
        total_roots = roots.sum(-1, dtype=torch.int32)
        in_range = err_wire.sum(-1, dtype=torch.int32)
        ok = (total_roots == Lr) & (in_range == total_roots)
        return corrected, in_range, ok

    return decode


def bch_decode(code, r_bits, device="cuda"):
    """Hard-decision decode on ``device``: [B, n] -> (corrected, n_errors,
    ok)."""
    return make_bch_decoder(code, device=device)(r_bits)


def _chase_candidates(hard, r_bits, rel, p):
    """The 2^p Chase test words of each word, hard-decoded.

    Pattern q flips the position of reliability rank i < p when bit i of
    q is set (a stable sort ranks equal reliabilities by position).
    Returns (corr [B, 2^p, n], ok [B, 2^p], score [B, 2^p]): the soft
    discrepancy of each successful candidate, +inf for a failed one.
    """
    B, n = r_bits.shape
    n_pat = 1 << p
    order = torch.argsort(rel, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)  # [B, n]
    in_lru = rank < p  # the p least-reliable positions
    q = torch.arange(n_pat, device=rel.device)
    flip = ((q[None, :, None] >> rank.clamp(max=p - 1)[:, None, :]) & 1
            ) * in_lru[:, None, :]  # [B, 2^p, n]
    rx = torch.bitwise_xor(r_bits.to(torch.int8)[:, None, :],
                           flip.to(torch.int8))
    corr, _, ok = hard(rx.reshape(B * n_pat, n))
    corr = corr.reshape(B, n_pat, n)
    ok = ok.reshape(B, n_pat)
    changed = (corr != r_bits[:, None, :]).to(torch.float32)
    score = torch.sum(changed * rel[:, None, :], dim=-1)
    return corr, ok, torch.where(ok, score, torch.inf)


@functools.lru_cache(maxsize=32)
def make_bch_chase_decoder(code, p=4, chien_block=None, device="cuda"):
    """``decode(hard_bits [B, n], reliability [B, n]) -> (corrected,
    n_errors, ok)`` on ``device``: Chase-2 soft-decision decoding.

    Flips every subset of the ``p`` least-reliable positions (2^p test
    patterns, folded into the batch of one hard decode) and keeps the
    successful candidate with the smallest soft discrepancy (the sum of
    reliabilities where it changed the received word); falls back to the
    received word with ok=False when no pattern succeeds.
    """
    dev = resolve_device(device)
    hard = make_bch_decoder(code, chien_block=chien_block, device=dev)

    def decode(r_bits, reliability):
        r_bits = on_device(r_bits, dev)
        rel = on_device(reliability, dev).to(torch.float32)
        corr, ok, score = _chase_candidates(hard, r_bits, rel, p)
        best = torch.argmin(score, dim=-1)
        any_ok = torch.any(ok, dim=-1)
        corrected = torch.gather(
            corr, 1, best[:, None, None].expand(-1, 1, corr.shape[-1]))[:, 0]
        corrected = torch.where(any_ok[:, None], corrected,
                                r_bits.to(torch.int8))
        n_out = (corrected != r_bits).sum(-1, dtype=torch.int32)
        n_out = torch.where(any_ok, n_out, 0)
        return corrected, n_out, any_ok

    return decode


def bch_chase_decode(code, hard_bits, reliability, p=4, device="cuda"):
    """Chase-2 soft decode: 2^p batched test patterns over the ``p``
    least-reliable bits.  ``reliability`` [B, n]: larger = more
    trustworthy (e.g. |LLR|).  Returns (corrected, n_errors, ok)."""
    return make_bch_chase_decoder(code, p=p, device=device)(hard_bits,
                                                            reliability)


@functools.lru_cache(maxsize=32)
def make_bch_chase_soft(code, p=4, beta=0.5, chien_block=None,
                        device="cuda"):
    """``decode(llr [B, n]) -> (soft_out [B, n], hard [B, n] int8)`` on
    ``device``: soft-output Chase, the Pyndiah SISO element of turbo
    product codes.

    Input LLRs: positive => bit 0.  Each bit's soft output is
    (m_competitor - m_best)/2 signed by the best candidate's decision,
    where m are the candidates' soft discrepancies and the competitor is
    the best candidate disagreeing at that bit; without a competitor it
    is Pyndiah's +/- (beta + |llr|).
    """
    dev = resolve_device(device)
    hard_dec = make_bch_decoder(code, chien_block=chien_block, device=dev)

    def decode(llr):
        llr = on_device(llr, dev).to(torch.float32)
        r_bits = (llr < 0).to(torch.int8)
        rel = torch.abs(llr)
        corr, ok, score = _chase_candidates(hard_dec, r_bits, rel, p)
        best = torch.argmin(score, dim=-1)
        m_best = torch.amin(score, dim=-1)  # [B]
        d_best = torch.gather(
            corr, 1, best[:, None, None].expand(-1, 1, corr.shape[-1])
        )[:, 0].to(torch.float32)  # [B, n] the best candidate's bits
        # best metric among candidates disagreeing with d_best at bit i
        agree = corr.to(torch.float32) == d_best[:, None, :]
        m_comp = torch.amin(torch.where(agree, torch.inf, score[..., None]),
                            dim=1)  # [B, n]
        has_comp = torch.isfinite(m_comp)
        sign = 1.0 - 2.0 * d_best  # +1 for bit 0 (the positive-LLR side)
        soft = torch.where(
            has_comp,
            0.5 * (m_comp - m_best[:, None]) * sign,
            (beta + rel) * sign)
        any_ok = torch.any(ok, dim=-1)
        # no candidate at all: the channel belief passes through
        soft = torch.where(any_ok[:, None], soft, llr)
        hard_out = torch.where(any_ok[:, None], d_best.to(torch.int8),
                               r_bits)
        return soft, hard_out

    return decode
