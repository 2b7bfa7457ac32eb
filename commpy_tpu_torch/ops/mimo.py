"""MIMO detection: ML, K-best sphere decoding, best-first tree search.

Counterpart of ``commpy_tpu/ops/mimo.py`` (reference
commpy/modulation.py:299-646):

* ``mimo_ml`` — an index-arithmetic candidate grid in the reference's
  repeat/tile order and one argmin over the batch;
* ``kbest`` — Schnorr-Euchner K-best with per-level candidate counts
  fixed by the shapes: on the card one launch of K8
  (``kernels/kbest.py``) after the triangularisation; in plain PyTorch
  every level is expand -> score -> stable sort -> gather over the whole
  batch;
* ``best_first_detector`` / ``best_first_device`` — the priority-stack
  tree search as a host search, and a batched fixed-budget variant (per
  level beam widths, counter-hypothesis LLRs);
* ``max_log_approx`` / ``bit_lvl_repr``.

Survivors are taken with a stable sort, so among equal metrics the lower
candidate index comes first, as ``jax.lax.top_k`` orders them
(``torch.topk`` gives no such order on CUDA).  The small complex
products (``H x``, ``H^H H``) are float32 sums of elementwise products
(:func:`~commpy_tpu_torch.utils.linalg.small_matmul`), whatever the
caller's TF32 settings.
"""
from __future__ import annotations

from bisect import insort

import numpy as np
import torch

from ..kernels import kbest as K8
from ..utils.bits import unpack_bits
from ..utils.device import device_constant, on_device
from ..utils.linalg import small_matmul

__all__ = [
    "mimo_ml",
    "mimo_ml_device",
    "kbest",
    "kbest_device",
    "best_first_detector",
    "best_first_device",
    "bit_lvl_repr",
    "max_log_approx",
    "max_log_approx_device",
]


# --------------------------------------------------------------------------
# ML detection
# --------------------------------------------------------------------------

def _candidate_grid(constellation, n):
    """[n, m^n] grid in the reference's repeat/tile order, and its
    constellation indices."""
    m = len(constellation)
    M = m ** n
    j = np.arange(M)
    idx = np.stack(
        [(j // m ** (n - 1 - i)) % m for i in range(n)], axis=0
    )  # [n, M]
    return np.asarray(constellation)[idx], idx


def mimo_ml_device(y, h, constellation, device="cuda") -> torch.Tensor:
    """Batched exhaustive ML detection.

    y: ``[..., nr]``; h: ``[..., nr, nt]``. Returns symbols ``[..., nt]``.
    Scores all ``m^nt`` candidates of every vector at once (no chunking):
    ``[..., nr, m^nt]`` complex64 must fit on the device.
    """
    y = on_device(y, device)
    h = on_device(h, y.device)
    nt = h.shape[-1]
    grid_np, _ = _candidate_grid(np.asarray(constellation), nt)
    grid = device_constant(grid_np.astype(np.complex64), y.device)
    hx = small_matmul(h.to(torch.complex64), grid)  # [..., nr, M]
    d = y.to(torch.complex64)[..., None] - hx
    score = torch.sum(d.real ** 2 + d.imag ** 2, dim=-2)  # [..., M]
    best = torch.argmin(score, dim=-1)
    return torch.movedim(grid[:, best], 0, -1)


def mimo_ml(y, h, constellation, device="cuda") -> np.ndarray:
    """Reference-compatible single-vector ML detection (modulation.py:299)."""
    return mimo_ml_device(np.asarray(y), np.asarray(h),
                          np.asarray(constellation), device).cpu().numpy()


# --------------------------------------------------------------------------
# K-best Schnorr-Euchner
# --------------------------------------------------------------------------

def kbest_device(y, h, constellation, K: int, noise_var=0.0,
                 output_type="hard", bits_per_symbol=None,
                 selection: str = "exact", a_priori=None,
                 llr_clip=None, device="cuda") -> torch.Tensor:
    """Batched K-best detection.

    y: ``[B, nr]``, h: ``[B, nr, nt]``.
    hard -> symbols ``[B, nt]``; soft -> LLRs ``[B, nt*bits_per_symbol]``
    (reference sign: positive <=> bit 0, ``+-inf`` where every survivor
    agrees on a bit).

    ``selection``: ``'exact'`` keeps the K best candidates of each level
    by a stable sort (equal metrics: lower candidate index first).
    ``'approx'`` is accepted for parity with the JAX package, where it
    names the TPU's approximate top-k; off the TPU that lowers to the
    exact selection, and here it is the exact selection too.

    ``a_priori`` (soft only): ``[B, nt*bits_per_symbol]`` prior LLRs
    (positive <=> bit 0).  The max-log MAP candidate metric gains the
    prior term ``-N0 * sum_j (1-2 b_j(x)) * La_j`` during the search, so
    the priors also steer survivor selection; the returned LLRs are
    posteriors.

    ``llr_clip`` (soft only): clip the output LLRs to ``+-llr_clip``.

    Route: on a CUDA tensor whose shape :func:`kbest_plan
    <commpy_tpu_torch.kernels.kbest.kbest_plan>` takes, the plain
    triangularisation, then one launch of K8 (``kernels/kbest.py``) for
    the search and the output, bit for bit with the plain search; CPU
    tensors and the calls the plan refuses (for a reason it states) take
    the plain search, :func:`_kbest_plain`.

    Counter: ``kbest_device.vectors``, the vectors ``B`` of every call,
    always on (a host int; reset it by assigning 0).
    """
    if selection not in ("exact", "approx"):
        raise ValueError(
            f"selection must be 'exact' or 'approx' (got {selection!r})"
        )
    y = on_device(y, device)
    kbest_device.vectors += int(y.shape[0])
    h = on_device(h, y.device)
    const = np.asarray(constellation)
    nt = h.shape[-1]
    m = int(const.shape[0])
    if a_priori is not None and output_type != "soft":
        raise ValueError("a_priori requires output_type='soft'")
    if output_type not in ("hard", "soft"):
        raise ValueError('output_type must be "hard" or "soft"')
    if bits_per_symbol is None:
        bits_per_symbol = int(np.log2(m))
    soft = output_type == "soft"
    if (y.device.type == "cuda" and K8.kbest_plan(
            nt, m, K, bits_per_symbol, soft, noise_var)["reason"] is None):
        r, yt = _chol_qr_batched(h.to(torch.complex64),
                                 y.to(torch.complex64))
        la = None
        if a_priori is not None:
            la = on_device(a_priori, y.device).to(torch.float32).reshape(
                y.shape[0], nt * bits_per_symbol).contiguous()
        return K8.kbest(r, yt, const, int(K), soft, la, noise_var, llr_clip)
    return _kbest_plain(y, h, const, K, noise_var, output_type,
                        bits_per_symbol, a_priori, llr_clip)


def _kbest_plain(y, h, const, K: int, noise_var, output_type: str,
                 bits_per_symbol: int, a_priori=None, llr_clip=None):
    """K-best detection in plain PyTorch: :func:`kbest_device`'s search
    on CPU tensors and K8's plain version (its arguments as
    :func:`kbest_device`'s, on one device, ``const`` a NumPy array and
    ``bits_per_symbol`` given)."""
    nt = h.shape[-1]
    m = int(const.shape[0])
    level_bias = None
    if a_priori is not None:
        # sgn[j, b] = 1 - 2*bit_b(j), MSB first (the soft output's order)
        j_idx = np.arange(m)[:, None]
        b_idx = np.arange(bits_per_symbol)[None, :]
        sgn = (1.0 - 2.0 * ((j_idx >> (bits_per_symbol - 1 - b_idx)) & 1)
               ).astype(np.float32)
        la = on_device(a_priori, y.device).to(torch.float32).reshape(
            y.shape[0], nt, 1, bits_per_symbol)
        # bias[B, t, j] = -N0 * sum_b sgn[j, b] * La[B, t, b]
        s = device_constant(sgn, y.device)
        acc = la[..., 0] * s[:, 0]
        for b in range(1, bits_per_symbol):
            acc = acc + la[..., b] * s[:, b]
        level_bias = -float(np.float32(noise_var)) * acc
    X, mets, idx = _beam_search_batched(y, h, const, (int(K),) * nt,
                                        level_bias=level_bias)
    if output_type == "hard":
        return X[:, :, 0]
    llrs = _max_log_llrs_batched(idx, mets, bits_per_symbol, noise_var)
    if llr_clip is not None:
        llrs = torch.clamp(llrs, -float(llr_clip), float(llr_clip))
    return llrs


kbest_device.vectors = 0


def _leaf_bits(sym_idx: torch.Tensor, bps: int) -> torch.Tensor:
    """[B, nt, W] indices -> [B, W, nt*bps] bits (reference bit layout)."""
    bits = unpack_bits(sym_idx, bps)  # [B, nt, W, bps]
    B, nt, W, _ = bits.shape
    return bits.permute(0, 2, 1, 3).reshape(B, W, nt * bps)


def _max_log_llrs_batched(sym_idx, mets, bps: int, noise_var):
    """Batched max-log LLRs straight from the search leaves (whose
    metrics are ``|y - H x|^2``), reference modulation.py:599-646."""
    bits = _leaf_bits(sym_idx, bps)  # [B, W, nb]
    m = mets[:, :, None]
    inf = torch.full((), float("inf"), device=mets.device)
    n0 = torch.amin(torch.where(bits == 0, m, inf), dim=1)  # [B, nb]
    n1 = torch.amin(torch.where(bits == 1, m, inf), dim=1)
    return -(n0 - n1) / (2 * noise_var)


def kbest(y, h, constellation, K, noise_var=0, output_type="hard",
          demode=None, device="cuda") -> np.ndarray:
    """Reference-compatible K-best (modulation.py:325-419)."""
    h = np.asarray(h)
    nb_tx, nb_rx = h.shape
    if nb_rx > nb_tx:
        raise ValueError("h has more columns than rows")
    constellation = np.asarray(constellation)
    y = np.asarray(y)[None]
    if output_type == "hard":
        out = kbest_device(y, h[None], constellation, int(K), device=device)
    elif output_type == "soft":
        bps = int(np.log2(len(constellation)))
        out = kbest_device(y, h[None], constellation, int(K), noise_var,
                           "soft", bps, device=device)
    else:
        raise ValueError('output_type must be "hard" or "soft"')
    return out[0].cpu().numpy()


# --------------------------------------------------------------------------
# Max-log LLR from a candidate list
# --------------------------------------------------------------------------

def max_log_approx_device(y, h, noise_var, pts, constellation,
                          bits_per_symbol: int, device="cuda"):
    """Max-log LLRs over a candidate list (modulation.py:599-646).

    y ``[nr]``, h ``[nr, nt]``, pts ``[nt, P]`` (candidates column-wise).
    Bits come from the nearest constellation point of each candidate.
    Returns LLRs ``[nt * bits_per_symbol]``.
    """
    pts = on_device(pts, device)
    y = on_device(y, pts.device)
    h = on_device(h, pts.device)
    nt, P = pts.shape
    const = device_constant(np.asarray(constellation), pts.device).to(
        pts.dtype)
    d = torch.abs(pts[..., None] - const)  # [nt, P, m]
    sym_idx = torch.argmin(d, dim=-1)  # [nt, P]
    bits = unpack_bits(sym_idx, bits_per_symbol)  # [nt, P, bps]
    bits = bits.movedim(1, 0).reshape(P, nt * bits_per_symbol)

    res = y[:, None] - small_matmul(h, pts)  # [nr, P]
    norms = torch.sum(res.real ** 2 + res.imag ** 2, dim=0)  # [P]

    inf = torch.full((), float("inf"), dtype=norms.dtype, device=pts.device)
    n0 = torch.where(bits.T == 0, norms[None, :], inf)  # [nb, P]
    n1 = torch.where(bits.T == 1, norms[None, :], inf)
    llr = torch.amin(n0, dim=-1) - torch.amin(n1, dim=-1)
    return -llr / (2 * noise_var)


def max_log_approx(y, h, noise_var, pts_list, demode):
    """Reference-compatible max-log LLR (callback-based demode), on the
    host in float64."""
    pts_list = np.asarray(pts_list)
    nb_pts = pts_list.shape[1]
    bits = np.asarray(
        demode(pts_list.reshape(-1, order="F"))
    ).reshape(nb_pts, -1)
    nb_bits = bits.shape[1]
    y = np.asarray(y)
    h = np.asarray(h)
    res = y[:, None] - h.dot(pts_list)
    norms = (np.abs(res) ** 2).sum(0)
    LLR = np.empty(nb_bits)
    for k in range(nb_bits):
        n0 = norms[bits[:, k] == 0]
        n1 = norms[bits[:, k] == 1]
        LLR[k] = (n0.min() if n0.size else np.inf) - (
            n1.min() if n1.size else np.inf
        )
    return -LLR / (2 * noise_var)


def bit_lvl_repr(H, w):
    """Bit-level channel lift A = H (I kron w) (modulation.py:568-596), on
    the host in the inputs' precision."""
    w = np.asarray(w)
    beta = len(w)
    if beta % 2 != 0:
        raise ValueError("Beta (length of w) must be even.")
    H = np.asarray(H)
    n = H.shape[1]
    return np.einsum("rt,tb->rtb", H, np.ones((n, 1)) * w).reshape(
        H.shape[0], n * beta)


# --------------------------------------------------------------------------
# Best-first tree search
# --------------------------------------------------------------------------
#
# The detector of reference modulation.py:422-565 (He/Zhang/Liang 2019) is
# a priority search over the QR-triangularized tree: per-level bounded
# stacks of partial hypotheses, a MAP hypothesis plus per-bit
# counter-hypothesis metrics (their clipped difference is the LLR), and a
# radius rule that discards any node whose partial metric can no longer
# improve a counter-hypothesis it could still reach.
#
# * ``best_first_detector`` — host search replicating the reference's
#   statistics, written around flat sorted sibling groups;
# * ``best_first_device`` — the batched path: the dynamic stacks become
#   static per-level beam widths (K-best with per-level limits).  Its
#   counter-hypothesis metrics come only from leaves that differ from the
#   MAP hypothesis (true max-log), so its LLR magnitudes exceed the host
#   search's, with the same signs on confident bits.


def best_first_detector(y, h, constellation, stack_size, noise_var, demode,
                        llr_max):
    """Best-first MIMO soft detection (host, NumPy float64).

    Parameters mirror reference modulation.py:422-457: ``stack_size`` is a
    tuple of per-level stack bounds (length: number of levels - 1),
    ``demode`` maps a symbol vector to its hard bits, ``llr_max`` clips the
    counter-hypothesis metrics.  ``noise_var`` is accepted for signature
    parity (the metric differences are returned unscaled, as in the
    reference).  Returns per-bit LLRs ``(map_metric - counter) * sign``.
    """
    h = np.asarray(h)
    n_lvl = h.shape[0]
    const = np.asarray(constellation)
    m = const.size
    bps = int(np.log2(m))

    q, r = np.linalg.qr(h)
    yt = q.conj().T.dot(np.asarray(y))

    best_metric = np.inf
    best_bits = None  # MAP hypothesis bits in {-1, +1}, [n_lvl, bps]
    counter = np.full((n_lvl, bps), np.inf)

    # A *sibling group* is the metric-sorted family of children of one
    # parent: (parent_suffix, symbols_sorted [m], metrics_sorted [m]).
    # A node is (metric, group, rank); its suffix is its own symbol
    # prepended to the parent suffix (antenna order: current .. last).
    def child_group(suffix, base_metric):
        d = suffix.size + 1
        res = yt[-d]
        if d > 1:
            res = res - r[-d, -d + 1:].dot(suffix)
        mets = base_metric + np.abs(res - r[-d, -d] * const) ** 2
        order = np.argsort(mets)
        return (suffix, const[order], mets[order])

    def node_suffix(group, rank):
        return np.concatenate(([group[1][rank]], group[0]))

    def signed_bits(vec):
        b = np.asarray(demode(vec)).reshape(-1, bps)
        return np.where(b == 0, -1, b)

    def met_key(node):
        return node[0]

    # stacks[i] holds nodes with n_lvl - i assigned symbols, ascending by
    # metric; stacks[0] collects leaves.
    stacks = [[] for _ in range(n_lvl)]
    root = child_group(np.empty(0, const.dtype), 0.0)
    stacks[-1].append((root[2][0], root, 0))

    while any(len(s) for s in stacks[1:]):
        # One sweep: pop the best node of each stack (leaf side first),
        # re-arm its next sibling, push its best child one level down.
        for lower in range(n_lvl - 1):
            src = lower + 1
            if not stacks[src]:
                continue
            met, group, rank = stacks[src].pop(0)
            vec = node_suffix(group, rank)

            if best_bits is None:
                radius = np.inf
            else:
                bits = signed_bits(vec)
                differ = best_bits[src:] != bits
                reachable = counter[src:][differ]
                radius = max(
                    counter[:src].max(),
                    reachable.max() if reachable.size else np.inf,
                )

            if rank + 1 < m and group[2][rank + 1] <= radius:
                insort(stacks[src], (group[2][rank + 1], group, rank + 1),
                       key=met_key)
            child = child_group(vec, met)
            if child[2][0] <= radius:
                insort(stacks[lower], (child[2][0], child, 0), key=met_key)

        # Leaf bookkeeping: a better leaf becomes the MAP hypothesis (the
        # old MAP metric damps every counter); a worse one only damps.
        if stacks[0]:
            met, group, rank = stacks[0][0]
            if met < best_metric:
                np.minimum(counter, best_metric, out=counter)
                best_metric = met
                best_bits = signed_bits(node_suffix(group, rank))
            else:
                np.minimum(counter, met, out=counter)
            np.clip(counter, best_metric - llr_max, best_metric + llr_max,
                    out=counter)

        stacks[0].clear()
        for lower in range(n_lvl - 1):
            del stacks[lower + 1][stack_size[lower]:]

    return ((best_metric - counter) * best_bits).reshape(-1)


def _chol_qr_batched(h: torch.Tensor, y: torch.Tensor):
    """Batched triangularization by Cholesky.

    h ``[B, nr, nt]``, y ``[B, nr]`` -> (r ``[B, nt, nt]`` upper
    triangular, yt ``[B, nt]``) with ``|yt - r x|^2 = |Q^H y - R x|^2`` up
    to a per-row unit phase (metric-invariant): ``R^H R = H^H H`` and
    ``yt = R^{-H} H^H y``, unrolled over the small static ``nt`` in the
    JAX package's order (Cholesky-Banachiewicz, a 1e-30 floor on the
    diagonal).
    """
    nt = h.shape[-1]
    hc = h.conj()
    G = small_matmul(hc.transpose(1, 2), h)  # [B, nt, nt]
    z = small_matmul(hc.transpose(1, 2), y[:, :, None])[:, :, 0]  # [B, nt]
    L = [[None] * nt for _ in range(nt)]
    for i in range(nt):
        s = G[:, i, i].real
        for k in range(i):
            s = s - (L[i][k] * L[i][k].conj()).real
        L[i][i] = torch.sqrt(torch.clamp_min(s, 1e-30)).to(h.dtype)
        for j in range(i + 1, nt):
            t = G[:, j, i]
            for k in range(i):
                t = t - L[j][k] * L[i][k].conj()
            L[j][i] = t / L[i][i]
    # forward substitution L w = z  ->  w = yt
    w = []
    for i in range(nt):
        t = z[:, i]
        for k in range(i):
            t = t - L[i][k] * w[k]
        w.append(t / L[i][i])
    yt = torch.stack(w, dim=-1)
    zero = torch.zeros_like(L[0][0])
    r = torch.stack(
        [torch.stack([L[j][i].conj() if j >= i else zero for j in range(nt)],
                     dim=-1)
         for i in range(nt)],
        dim=-2,
    )
    return r, yt


def _beam_search_batched(y, h, constellation, widths, qr=None,
                         level_bias=None):
    """Fully batched fixed-budget tree search.

    Expanded candidate ``j * C + c`` is symbol j under parent c (the
    reference's repeat order); each level keeps the ``widths[l]`` best by
    a stable sort and gathers the survivors' state with
    ``take_along_dim`` (exact).  y ``[B, nr]`` complex, h ``[B, nr, nt]``
    complex, ``constellation`` a NumPy array.

    Returns (X ``[B, nt, W]`` complex leaves, d_tot ``[B, W]`` ascending,
    sym_idx ``[B, nt, W]`` int64 constellation indices).  The metrics
    d_tot equal ``|y - H x|^2`` per leaf.
    """
    dev = y.device
    nt = h.shape[-1]
    const = np.asarray(constellation)
    m = int(const.shape[0])
    if qr is None:
        qr = _chol_qr_batched(h.to(torch.complex64), y.to(torch.complex64))
    r, yt = qr
    B = yt.shape[0]
    hr = device_constant(const.real.astype(np.float32), dev)  # [m]
    hi = device_constant(const.imag.astype(np.float32), dev)
    rr = r.real.to(torch.float32)  # [B, nt, nt]
    ri = r.imag.to(torch.float32)

    # residual rows [B, nt, C]; chosen symbols [B, nt, C] and their
    # constellation indices (so soft output needs no nearest-point search)
    dr = yt.real.to(torch.float32)[:, :, None]
    di = yt.imag.to(torch.float32)[:, :, None]
    Xr = torch.zeros((B, nt, 1), dtype=torch.float32, device=dev)
    Xi = torch.zeros((B, nt, 1), dtype=torch.float32, device=dev)
    Ix = torch.zeros((B, nt, 1), dtype=torch.int64, device=dev)
    dt = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    C = 1
    for lvl, coor in enumerate(range(nt - 1, -1, -1)):
        CM = C * m
        # metric increment |d[coor] - r[coor,coor] * s|^2 (real diagonal)
        rii = rr[:, coor, coor][:, None, None]  # [B,1,1]
        er = dr[:, coor, :, None] - rii * hr[None, None, :]  # [B,C,m]
        ei = di[:, coor, :, None] - rii * hi[None, None, :]
        inc = er * er + ei * ei
        if level_bias is not None:
            inc = inc + level_bias[:, coor, None, :]
        # candidate index j*C + c: [B, m, C]
        cand = (dt[:, None, :] + inc.transpose(1, 2)).reshape(B, CM)
        keep = min(CM, int(widths[lvl]))
        vals, order = torch.sort(cand, dim=-1, stable=True)
        sel = order[:, :keep]  # [B, keep]
        dt = vals[:, :keep].contiguous()
        c_idx = sel % C  # parent index
        j_idx = sel // C  # symbol index
        par = c_idx[:, None, :].expand(B, nt, keep)
        Xr = torch.take_along_dim(Xr, par, dim=2)
        Xi = torch.take_along_dim(Xi, par, dim=2)
        dr = torch.take_along_dim(dr, par, dim=2)
        di = torch.take_along_dim(di, par, dim=2)
        Ix = torch.take_along_dim(Ix, par, dim=2)
        sr = hr[j_idx]  # [B, keep]
        si = hi[j_idx]
        Xr[:, coor, :] = sr
        Xi[:, coor, :] = si
        Ix[:, coor, :] = j_idx
        # residual updates: row coor consumed its symbol; rows above
        # (indices < coor) subtract r[i, coor] * s (complex)
        dr[:, coor, :] = dr[:, coor, :] + -(rr[:, coor, coor][:, None] * sr)
        di[:, coor, :] = di[:, coor, :] + -(rr[:, coor, coor][:, None] * si)
        if coor > 0:
            rr_c = rr[:, :coor, coor][:, :, None]  # [B, coor, 1]
            ri_c = ri[:, :coor, coor][:, :, None]
            dr[:, :coor, :] = dr[:, :coor, :] + -(
                rr_c * sr[:, None, :] - ri_c * si[:, None, :])
            di[:, :coor, :] = di[:, :coor, :] + -(
                rr_c * si[:, None, :] + ri_c * sr[:, None, :])
        C = keep
    return torch.complex(Xr, Xi), dt, Ix


def _beam_search_single(y, h, constellation, widths, qr=None):
    """Fixed-budget tree search for ONE received vector.

    widths[l] is the number of survivors kept after expanding level l
    (l = 0 expands the last antenna).  Returns (X [nt, W_last], d_tot
    [W_last]), every kept leaf and its metric.  ``qr`` passes a
    precomputed (r, yt) pair; without it the QR is
    ``torch.linalg.qr``'s.
    """
    nt = h.shape[1]
    const = torch.as_tensor(np.asarray(constellation),
                            device=y.device).to(y.dtype)
    m = const.shape[0]
    if qr is None:
        q, r = torch.linalg.qr(h)
        yt = small_matmul(q.conj().T, y[:, None])[:, 0]
    else:
        r, yt = qr

    X = torch.zeros((nt, 1), dtype=const.dtype, device=y.device)
    d = yt[:, None]  # residuals [nr, cand]
    d_tot = torch.zeros((1,), dtype=torch.float32, device=y.device)
    nb_can = 1
    for lvl, coor in enumerate(range(nt - 1, -1, -1)):
        nb_hyp = nb_can * m
        X = X.repeat(1, m)
        d = d.repeat(1, m)
        d_tot_h = d_tot.repeat(m)
        hyp = const.repeat_interleave(nb_can)
        X[coor] = hyp
        d[coor] = d[coor] + -(r[coor, coor] * hyp)
        d_tot_h = d_tot_h + torch.abs(d[coor]) ** 2

        keep = min(nb_hyp, int(widths[lvl]))
        sel = torch.sort(d_tot_h, stable=True)[1][:keep]
        X = X[:, sel]
        d = d[:, sel]
        d[:coor] = d[:coor] + -(r[:coor, coor, None] * hyp[sel])
        d_tot = d_tot_h[sel]
        nb_can = keep
    return X, d_tot


def best_first_device(y, h, constellation, beam=16, llr_max=500.0,
                      bits_per_symbol=None, device="cuda") -> torch.Tensor:
    """Batched fixed-budget best-first detection.

    The host detector's dynamic per-level stacks become static per-level
    beam widths, so every level is a fixed-shape expand -> score -> sort
    over the whole batch.

    y ``[B, nr]`` received vectors; h ``[B, nr, nt]`` channels; ``beam``
    an int or a per-level tuple (length nt) of survivor counts;
    ``llr_max`` the counter-metric clip (reference modulation.py:558).

    Returns LLRs ``[B, nt * bits_per_symbol]`` in the reference convention
    ``(map_metric - counter_metric) * map_bit_sign`` (unscaled by the noise
    variance, positive <=> bit 0), the counter clipped to
    ``map_metric +- llr_max``, so every value is finite.
    """
    y = on_device(y, device)
    h = on_device(h, y.device)
    const = np.asarray(constellation)
    nt = h.shape[-1]
    m = const.shape[0]
    if bits_per_symbol is None:
        bits_per_symbol = int(np.log2(m))
    widths = (beam,) * nt if np.ndim(beam) == 0 else tuple(beam)
    _, mets, idx = _beam_search_batched(y, h, const, widths)
    bits = _leaf_bits(idx, bits_per_symbol)  # [B, W, nb]
    map_i = torch.argmin(mets, dim=-1)  # [B]
    map_met = torch.take_along_dim(mets, map_i[:, None], dim=-1)  # [B, 1]
    map_bits = torch.take_along_dim(bits, map_i[:, None, None], dim=1)
    sign = (2 * map_bits[:, 0, :] - 1).to(torch.float32)  # [B, nb]
    differ = bits != map_bits
    inf = torch.full((), float("inf"), device=mets.device)
    counter = torch.amin(torch.where(differ, mets[:, :, None], inf), dim=1)
    counter = torch.minimum(torch.maximum(counter, map_met - llr_max),
                            map_met + llr_max)
    return (map_met - counter) * sign


def _counter_hyp_llrs(X, mets, constellation, bps: int, llr_max):
    """MAP/counter-hypothesis LLRs from a leaf candidate list.

    X ``[nt, W]`` leaves (exact constellation points), mets ``[W]``.
    """
    map_idx = torch.argmin(mets)
    map_met = mets[map_idx]
    const = torch.as_tensor(np.asarray(constellation),
                            device=X.device).to(X.dtype)
    d = torch.abs(X[..., None] - const)  # [nt, W, m]
    sym_idx = torch.argmin(d, dim=-1)
    bits = unpack_bits(sym_idx, bps)  # [nt, W, bps]
    map_bits = bits[:, map_idx]  # [nt, bps]
    sign = (2 * map_bits - 1).to(torch.float32)
    differ = bits != map_bits[:, None, :]
    inf = torch.full((), float("inf"), device=mets.device)
    counter = torch.amin(torch.where(differ, mets[None, :, None], inf),
                         dim=1)  # [nt, bps]
    counter = torch.minimum(torch.maximum(counter, map_met - llr_max),
                            map_met + llr_max)
    return ((map_met - counter) * sign).reshape(-1)
