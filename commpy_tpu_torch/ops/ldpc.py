"""LDPC codes: design-file IO, systematic encoding, and batched BP decoding.

Counterpart of ``commpy_tpu/ops/ldpc.py``:

* the design-file parser and writer keep the reference text format
  (reference ldpc.py:55-61) and dict keys; the four shipped designs are
  copied under ``commpy_tpu_torch/designs/ldpc/`` (:data:`DESIGNS`);
* the decoder runs on a dense ``[B, n_cnodes, max_cnode_deg]`` edge
  tensor (the -1 padding of the adjacency lists maps to masked slots);
  variable-node sums and edge reads are products with the one-hot
  edge-incidence matrix, left to ``torch.matmul`` as the JAX package
  leaves them to XLA;
* the reference's per-block syndrome early exit becomes a loop whose
  state freezes converged blocks;
* ``backend='auto'`` lifts quasi-cyclic codes (every shipped WiMAX
  design) onto :func:`~commpy_tpu_torch.ops.qcldpc.qc_bp_decode_device`
  and its kernels;
* ``ldpc_bp_decode_sharded`` splits one graph's check rows over the
  ranks of a mesh.

Decoded outputs match the reference: hard word via signbit, posterior
LLRs, one block per column (Fortran order) in the host API.
"""
from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as splg
import torch

from ..kernels.qc_bp import sign_keep_zero
from ..parallel.mesh import axis_index, axis_size, check_axis, psum
from ..utils.device import on_device
from .qcldpc import _loo_prod

__all__ = [
    "DESIGNS",
    "get_ldpc_code_params",
    "build_matrix",
    "write_ldpc_params",
    "triang_ldpc_systematic_encode",
    "ldpc_bp_decode",
    "ldpc_bp_decode_device",
    "ldpc_bp_decode_sharded",
    "ldpc_encode_device",
]

_llr_max = 500.0  # reference ldpc.py:11
# the shipped design files (gallager/, wimax/), read by the parser
DESIGNS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "designs", "ldpc")

# --------------------------------------------------------------------------
# Design file IO (host)
# --------------------------------------------------------------------------

def _parse_ragged(lines, deg, max_deg):
    """Vectorized ragged-section parse: rows of 1-based neighbor ids ->
    a -1-padded [n, max_deg] 0-based adjacency matrix.

    One tokenization of the whole section, then a single scatter by
    (row, slot) computed from the degree prefix sums — no per-row loop.
    """
    n = len(deg)
    flat = np.array(" ".join(lines).split(), dtype=np.int64) - 1
    if flat.size != int(deg.sum()):
        raise ValueError(
            f"design file section has {flat.size} entries, degree list "
            f"promises {int(deg.sum())}"
        )
    starts = np.concatenate([[0], np.cumsum(deg)[:-1]])
    row = np.repeat(np.arange(n), deg)
    slot = np.arange(flat.size) - np.repeat(starts, deg)
    adj = -np.ones((n, max_deg), dtype=np.int64)
    adj[row, slot] = flat
    return adj, row, slot, flat


def get_ldpc_code_params(ldpc_design_filename, compute_matrix=False):
    """Parse an LDPC design file (text format of reference ldpc.py:55-61:
    header ``n_vnodes n_cnodes`` / ``max_vnode_deg max_cnode_deg``,
    degree lists, then 1-based per-vnode and per-cnode adjacency rows).

    From-scratch vectorized parse: each section is tokenized once and
    scattered into its padded adjacency matrix, and the vnode<->cnode
    cross-index maps (the slot of each shared edge in the peer's row)
    come from aligning the two sections' edge lists with one lexsort
    each — no per-node Python loops.  The returned dict schema is the
    established interop contract (flattened int32 adjacency/cross maps,
    -1 padding), byte-identical to previous rounds' output.
    """
    with open(ldpc_design_filename) as f:
        text = f.read().split("\n")
    n_vnodes, n_cnodes = (int(x) for x in text[0].split())
    max_vnode_deg, max_cnode_deg = (int(x) for x in text[1].split())
    vnode_deg_list = np.array(text[2].split(), dtype=np.int32)
    cnode_deg_list = np.array(text[3].split(), dtype=np.int32)
    if vnode_deg_list.size != n_vnodes or cnode_deg_list.size != n_cnodes:
        raise ValueError("degree list length does not match the header")

    vnode_adj_list, v_row, v_slot, v_peer = _parse_ragged(
        text[4:4 + n_vnodes], vnode_deg_list, max_vnode_deg
    )
    cnode_adj_list, c_row, c_slot, c_peer = _parse_ragged(
        text[4 + n_vnodes:4 + n_vnodes + n_cnodes],
        cnode_deg_list, max_cnode_deg,
    )

    # Cross-index maps: both sections list the SAME edge set, once as
    # (v, c, slot-in-v-row) and once as (c, v, slot-in-c-row).  Sorting
    # each by the edge key (v, c) aligns them element for element, so
    # the peer slots transfer with two scatters.
    v_order = np.lexsort((v_peer, v_row))    # edges sorted by (v, c)
    c_order = np.lexsort((c_row, c_peer))    # edges sorted by (v, c)
    if not (np.array_equal(v_row[v_order], c_peer[c_order])
            and np.array_equal(v_peer[v_order], c_row[c_order])):
        raise ValueError(
            "vnode and cnode sections disagree on the edge set"
        )
    cnode_vnode_map = -np.ones((n_cnodes, max_cnode_deg), dtype=np.int64)
    vnode_cnode_map = -np.ones((n_vnodes, max_vnode_deg), dtype=np.int64)
    cnode_vnode_map[c_row[c_order], c_slot[c_order]] = v_slot[v_order]
    vnode_cnode_map[v_row[v_order], v_slot[v_order]] = c_slot[c_order]

    ldpc_code_params = {
        "n_vnodes": n_vnodes,
        "n_cnodes": n_cnodes,
        "max_cnode_deg": max_cnode_deg,
        "max_vnode_deg": max_vnode_deg,
        "cnode_adj_list": cnode_adj_list.flatten().astype(np.int32),
        "vnode_adj_list": vnode_adj_list.flatten().astype(np.int32),
        "cnode_vnode_map": cnode_vnode_map.flatten().astype(np.int32),
        "vnode_cnode_map": vnode_cnode_map.flatten().astype(np.int32),
        "cnode_deg_list": cnode_deg_list,
        "vnode_deg_list": vnode_deg_list,
    }
    if compute_matrix:
        build_matrix(ldpc_code_params)
    return ldpc_code_params


def build_matrix(ldpc_code_params):
    """Build sparse H (CSC) and G = inv(H_sys) @ H_parity (CSR).

    Valid for approximately-triangular systematic codes
    (reference ldpc.py:13-48).  Adds both to the params dict.
    """
    n_cnodes = ldpc_code_params["n_cnodes"]
    deg = ldpc_code_params["cnode_deg_list"]
    adj = ldpc_code_params["cnode_adj_list"].reshape(
        (n_cnodes, ldpc_code_params["max_cnode_deg"])
    )
    rows = np.repeat(np.arange(n_cnodes), deg)
    cols = np.concatenate([adj[c, : deg[c]] for c in range(n_cnodes)])
    H = sp.csc_matrix(
        (np.ones(rows.size, np.int8), (rows, cols)),
        shape=(n_cnodes, ldpc_code_params["n_vnodes"]),
    )
    systematic_part = H[:, -n_cnodes:]
    parity_part = H[:, :-n_cnodes]
    ldpc_code_params["parity_check_matrix"] = H
    ldpc_code_params["generator_matrix"] = (
        splg.inv(systematic_part).dot(parity_part).tocsr()
    )


def write_ldpc_params(parity_check_matrix, file_path):
    """Write a parity-check matrix as a design file (reference ldpc.py:257)."""
    H = np.asarray(parity_check_matrix)
    with open(file_path, "x") as f:
        f.write("{} {}\n".format(H.shape[1], H.shape[0]))
        f.write("{} {}\n".format(H.sum(0).max(), H.sum(1).max()))
        for deg in H.sum(0):
            f.write("{} ".format(deg))
        f.write("\n")
        for deg in H.sum(1):
            f.write("{} ".format(deg))
        f.write("\n")
        for line in H.T:
            nodes = line.nonzero()[0]
            for node in nodes[:-1]:
                f.write("{}\t".format(node + 1))
            f.write("{}\n".format(nodes[-1] + 1))
        for col in H:
            nodes = col.nonzero()[0]
            for node in nodes[:-1]:
                f.write("{}\t".format(node + 1))
            f.write("{}\n".format(nodes[-1] + 1))
        f.write("\n")

# --------------------------------------------------------------------------
# Encoding
# --------------------------------------------------------------------------

def ldpc_encode_device(message_bits, generator_dense, device="cuda"):
    """Batched systematic encode ``[..., k] -> [..., n]`` int8 on
    ``device``: parity = G @ m mod 2 as a dense product (G entries are
    0/1 and k < 2^24, so float32 accumulation is exact)."""
    m = on_device(message_bits, device)
    G = on_device(generator_dense, m.device).to(torch.float32)
    parity = torch.remainder(m.to(torch.float32) @ G.T, 2.0)
    return torch.cat([m.to(torch.int8), parity.to(torch.int8)], dim=-1)


def triang_ldpc_systematic_encode(message_bits, ldpc_code_params, pad=True,
                                  device="cuda"):
    """Reference-compatible systematic encoder (ldpc.py:302-354); returns
    a NumPy int8 array ``[n_vnodes(, n_blocks)]``."""
    if (
        ldpc_code_params.get("generator_matrix") is None
        or ldpc_code_params.get("parity_check_matrix") is None
    ):
        build_matrix(ldpc_code_params)

    message_bits = np.asarray(message_bits)
    G = ldpc_code_params["generator_matrix"]
    block_length = G.shape[1]
    modulo = len(message_bits) % block_length
    if modulo:
        if pad:
            message_bits = np.concatenate(
                (message_bits, np.zeros(block_length - modulo,
                                        message_bits.dtype))
            )
        else:
            raise ValueError(
                "Padding is disable but message length is not a multiple of "
                "block length."
            )
    message_bits = message_bits.reshape(block_length, -1, order="F")

    Gd = np.asarray(G.todense()) % 2
    coded = ldpc_encode_device(message_bits.T.astype(np.int8), Gd,
                               device).cpu().numpy().T  # [n_v, n_blocks]
    return coded.squeeze().astype(np.int8)


# --------------------------------------------------------------------------
# Decoding
# --------------------------------------------------------------------------

def _bp_core(llr, cmask, Ainc, algorithm: str, n_iters: int,
             msa_scale: float = 1.0, msa_offset: float = 0.0, mesh=None):
    """Belief propagation over the padded Tanner edge arrays.

    llr ``[B, n_v]``; cmask ``[n_c, cd]`` valid-edge mask; Ainc
    ``[n_c*cd, n_v]`` float32 one-hot, edge e -> its variable node.  The
    permutations are products with Ainc (``torch.matmul``), whose sums
    of a node's few messages may round in another order than XLA's.

    With ``mesh`` (edge-sharded, SPMD), cmask and Ainc hold only this
    rank's check rows: the variable-node sums and the convergence test
    are completed by all-reduce, and llr and the outputs are the same on
    every rank.
    """
    B, n_v = llr.shape
    n_c, cd = cmask.shape

    def to_vnodes(edge_vals):  # [B, n_c, cd] -> [B, n_v]
        out = edge_vals.reshape(B, n_c * cd) @ Ainc
        return out if mesh is None else psum(out, mesh)

    def to_edges(vnode_vals):  # [B, n_v] -> [B, n_c, cd]
        return (vnode_vals @ Ainc.T).reshape(B, n_c, cd)

    def gather_total(c2v):
        return llr + to_vnodes(torch.where(cmask, c2v, 0.0))

    def syndrome_ok(dec):
        par = torch.sum(torch.where(cmask, to_edges(dec.to(torch.float32)),
                                    0.0), dim=-1)
        bad = torch.any(torch.remainder(par, 2.0) != 0, dim=-1)
        return ~(bad if mesh is None else psum(bad, mesh))

    def cn_update(v2c):
        if algorithm == "SPA":
            t = torch.tanh(v2c * 0.5)
            prod = _loo_prod(t, cmask)
            msg = 2.0 * torch.atanh(torch.clamp(prod, -1.0, 1.0))
            return torch.clamp(msg, -_llr_max, _llr_max)
        if algorithm == "MSA":
            sign = _loo_prod(sign_keep_zero(v2c), cmask)
            mag = torch.where(cmask, torch.abs(v2c), torch.inf)
            big = torch.full_like(mag[..., :1], torch.inf)
            pref = [big]
            for j in range(1, cd):
                pref.append(torch.minimum(pref[-1], mag[..., j - 1:j]))
            suf = [big]
            for j in range(cd - 2, -1, -1):
                suf.append(torch.minimum(suf[-1], mag[..., j + 1:j + 2]))
            suf.reverse()
            loo_min = torch.cat([torch.minimum(pref[j], suf[j])
                                 for j in range(cd)], dim=-1)
            # normalised/offset min-sum: plain MSA at (1, 0) exactly
            mag_out = torch.clamp_min(msa_scale * loo_min - msa_offset, 0.0)
            return torch.where(cmask, sign * mag_out, 0.0)
        raise NameError(
            'Please input a valid decoder_algorithm string '
            '(meanning "SPA" or "MSA").'
        )

    dec = torch.signbit(llr).to(torch.int8)
    c2v = torch.zeros((B, n_c, cd), dtype=torch.float32, device=llr.device)
    out_llr = llr
    it = 0
    while it < n_iters:
        act = ~syndrome_ok(dec)  # [B]
        if not bool(act.any()):
            break
        total = gather_total(c2v)
        v2c = torch.where(cmask, to_edges(total) - c2v, 0.0)
        new_c2v = cn_update(v2c)
        new_total = gather_total(new_c2v)
        new_dec = torch.signbit(new_total).to(torch.int8)
        c2v = torch.where(act[:, None, None], new_c2v, c2v)
        out_llr = torch.where(act[:, None], new_total, out_llr)
        dec = torch.where(act[:, None], new_dec, dec)
        it += 1
    return dec, out_llr


def _edge_arrays(ldpc_code_params, device):
    """(cmask ``[n_c, cd]`` bool, Ainc ``[n_c*cd, n_v]`` float32 one-hot)
    on ``device``, made once per device and kept on the params dict."""
    cache = ldpc_code_params.setdefault("_torch_edge_arrays", {})
    key = str(device)
    if key in cache:
        return cache[key]
    n_v = ldpc_code_params["n_vnodes"]
    n_c = ldpc_code_params["n_cnodes"]
    cd = ldpc_code_params["max_cnode_deg"]
    cadj = np.asarray(ldpc_code_params["cnode_adj_list"]).reshape(n_c, cd)
    cmask = cadj >= 0
    flat = cadj.reshape(-1)
    valid = flat >= 0
    Ainc = torch.zeros((n_c * cd, n_v), dtype=torch.float32, device=device)
    Ainc[torch.as_tensor(np.flatnonzero(valid), device=device),
         torch.as_tensor(flat[valid].astype(np.int64), device=device)] = 1.0
    out = (torch.as_tensor(cmask, device=device), Ainc)
    cache[key] = out
    return out


def _maybe_qc_params(ldpc_code_params):
    """Detect and cache (on the params dict) the quasi-cyclic structure
    of a design-file code: the largest circulant size Z with at least two
    block rows.  Returns the QC params dict or None."""
    if "_qc_lift" in ldpc_code_params:
        return ldpc_code_params["_qc_lift"]
    from .qcldpc import detect_qc_structure

    n_c = ldpc_code_params["n_cnodes"]
    n_v = ldpc_code_params["n_vnodes"]
    g = int(np.gcd(n_c, n_v))
    qc = None
    for Z in sorted(
        {d for d in range(2, g + 1) if g % d == 0}, reverse=True
    ):
        if n_c // Z < 2:
            continue
        qc = detect_qc_structure(ldpc_code_params, Z)
        if qc is not None:
            break
    ldpc_code_params["_qc_lift"] = qc
    return qc


def ldpc_bp_decode_device(llr, ldpc_code_params, decoder_algorithm,
                          n_iters, backend: str = "auto",
                          msa_scale: float = 1.0, msa_offset: float = 0.0,
                          device="cuda"):
    """Batched BP decode on ``device``: llr ``[..., n_vnodes]`` (positive
    means bit 0) -> (dec int8, out_llr).

    ``backend='auto'`` lifts quasi-cyclic codes (the shipped WiMAX
    designs; 1440.720 is QC with Z=60) onto
    :func:`~commpy_tpu_torch.ops.qcldpc.qc_bp_decode_device`;
    ``'dense'`` forces the incidence-product core.
    ``msa_scale``/``msa_offset``: normalised/offset min-sum; (1, 0) is the
    reference's plain MSA.
    """
    if decoder_algorithm not in ("SPA", "MSA"):
        raise NameError(
            'Please input a valid decoder_algorithm string '
            '(meanning "SPA" or "MSA").'
        )
    if (msa_scale, msa_offset) != (1.0, 0.0) and decoder_algorithm != "MSA":
        raise ValueError("msa_scale/msa_offset apply to MSA only")
    if backend not in ("auto", "dense"):
        raise ValueError(f"backend must be 'auto' or 'dense', got "
                         f"{backend!r}")
    if backend == "auto":
        qc = _maybe_qc_params(ldpc_code_params)
        if qc is not None:
            from .qcldpc import qc_bp_decode_device

            return qc_bp_decode_device(
                llr, qc, decoder_algorithm, n_iters,
                msa_scale=msa_scale, msa_offset=msa_offset, device=device,
            )
    x = on_device(llr, device).to(torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    lead = x.shape[:-1]
    x = torch.clamp(x.reshape(-1, x.shape[-1]), -_llr_max, _llr_max)
    cmask, Ainc = _edge_arrays(ldpc_code_params, x.device)
    dec, out_llr = _bp_core(x, cmask, Ainc, decoder_algorithm, int(n_iters),
                            msa_scale=float(msa_scale),
                            msa_offset=float(msa_offset))
    dec = dec.reshape(lead + dec.shape[-1:])
    out_llr = out_llr.reshape(lead + out_llr.shape[-1:])
    if squeeze:
        return dec[0], out_llr[0]
    return dec, out_llr


def ldpc_bp_decode_sharded(llr, ldpc_code_params, decoder_algorithm,
                           n_iters, mesh, axis_name: str = "dp"):
    """Edge-sharded BP decode: one Tanner graph split over the mesh (SPMD).

    The check rows (and their edges) are split over the ranks of
    ``mesh``, padded with all-masked rows (always-satisfied checks) to a
    multiple of its size; each rank updates its own rows, and the
    variable-node sums and the convergence test are completed by
    all-reduce (the tensor-parallel decoder).  llr ``[..., n_vnodes]``
    and the outputs are the same on every rank.  The per-node sums add
    the ranks' partials, so posteriors may round otherwise than the
    one-device decode.
    """
    if decoder_algorithm not in ("SPA", "MSA"):
        raise NameError(
            'Please input a valid decoder_algorithm string '
            '(meanning "SPA" or "MSA").'
        )
    check_axis(mesh, axis_name)
    x = on_device(llr, mesh.device_type).to(torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    lead = x.shape[:-1]
    x = torch.clamp(x.reshape(-1, x.shape[-1]), -_llr_max, _llr_max)
    cmask, Ainc = _edge_arrays(ldpc_code_params, x.device)
    D, r = axis_size(mesh), axis_index(mesh)
    n_c, cd = cmask.shape
    rows = -(-n_c // D)  # check rows a rank; the padding rows are masked
    lo, hi = min(r * rows, n_c), min((r + 1) * rows, n_c)
    cm = torch.zeros((rows, cd), dtype=torch.bool, device=x.device)
    cm[:hi - lo] = cmask[lo:hi]
    ai = torch.zeros((rows * cd, Ainc.shape[1]), dtype=torch.float32,
                     device=x.device)
    ai[:(hi - lo) * cd] = Ainc[lo * cd:hi * cd]
    dec, out = _bp_core(x, cm, ai, decoder_algorithm, int(n_iters),
                        mesh=mesh)
    dec = dec.reshape(lead + dec.shape[-1:])
    out = out.reshape(lead + out.shape[-1:])
    if squeeze:
        return dec[0], out[0]
    return dec, out


def ldpc_bp_decode(llr_vec, ldpc_code_params, decoder_algorithm, n_iters,
                   device="cuda"):
    """Reference-compatible BP decode (ldpc.py:144-255), NumPy in and out.

    llr_vec: 1D float array, length a multiple of n_vnodes; the blocks
    are decoded at once, as one batch on ``device``.
    """
    llr_vec = np.asarray(llr_vec, float)
    n_v = ldpc_code_params["n_vnodes"]
    n_blocks = llr_vec.size // n_v
    blocks = llr_vec.reshape(n_blocks, n_v).astype(np.float32)
    dec, out = ldpc_bp_decode_device(
        blocks, ldpc_code_params, decoder_algorithm, n_iters, device=device
    )
    dec = dec.cpu().numpy().T.squeeze().astype(np.int8)
    out = out.cpu().numpy().astype(float).T.squeeze()
    return dec, out
