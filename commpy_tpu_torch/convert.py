"""Carry state across from the JAX package.

The links have no weights: their "parameters" are the codes' tables and
the modem's constellation.  Constellations pass through as NumPy arrays.

* :func:`trellis_from_tables` rebuilds a port
  :class:`~commpy_tpu_torch.ops.trellis.Trellis` from a dict of NumPy
  tables (for example read off a ``commpy_tpu`` Trellis), checking the
  inverse tables against the forward ones.
* :func:`qc_params_from_arrays` and :func:`ldpc_params_from_arrays` take
  a JAX package LDPC params dict (NumPy arrays, tuples, SciPy sparse
  matrices), drop its private cache keys (``_device_edge_arrays`` holds
  JAX arrays, ``_qc_lift`` a nested dict) and re-check the structure
  before the port decodes with it.
* :func:`turbo_params_from_arrays` takes a turbo code's component
  trellis tables and interleaver permutation (``p_array``); those two are
  the code's whole state.
* :func:`bch_code_from_fields`, :func:`rs_code_from_fields` and
  :func:`crc_spec_from_fields` take the fields of a JAX package
  ``BchCode``, ``RsCode`` or ``CrcSpec`` and rebuild the port's object
  from its own construction, which must give the same generator
  polynomial.  Filter, channel and equalizer taps pass through as NumPy
  arrays.
* :func:`polar_code_from_fields` takes the fields of a JAX package
  ``PolarCode`` (``N``, ``K``, ``frozen``, ``crc``, ``rm``,
  ``systematic``); the frozen mask is the code's whole design.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .ops.trellis import Trellis

__all__ = ["TABLE_KEYS", "trellis_tables", "trellis_from_tables",
           "qc_params_from_arrays", "ldpc_params_from_arrays",
           "turbo_params_from_arrays", "bch_code_from_fields",
           "rs_code_from_fields", "crc_spec_from_fields",
           "polar_code_from_fields"]

TABLE_KEYS = ("next_state_table", "output_table", "pred_state_table",
              "pred_input_table", "branch_codewords")
_SCALAR_KEYS = ("k", "n", "total_memory")


def trellis_tables(trellis) -> dict:
    """The dict :func:`trellis_from_tables` takes, read off any object with
    the Trellis attributes (a port or a ``commpy_tpu`` Trellis)."""
    d = {key: np.asarray(getattr(trellis, key)) for key in TABLE_KEYS}
    d.update({key: int(getattr(trellis, key)) for key in _SCALAR_KEYS})
    return d


def trellis_from_tables(d: dict) -> Trellis:
    """Build a port Trellis from ``d`` (see :data:`TABLE_KEYS`, plus ``k``,
    ``n`` and ``total_memory``).

    The inverse tables and branch codewords are recomputed from the
    forward tables and must equal the ones given.  The result encodes with
    the trellis FSM (``is_feedforward`` is False: the generator taps are
    not part of the tables).
    """
    missing = [key for key in TABLE_KEYS + _SCALAR_KEYS if key not in d]
    if missing:
        raise KeyError(f"missing trellis tables: {missing}")
    t = Trellis.__new__(Trellis)
    t.k, t.n = int(d["k"]), int(d["n"])
    t.total_memory = int(d["total_memory"])
    t.number_states = 2 ** t.total_memory
    t.number_inputs = 2 ** t.k
    t.memory = np.atleast_1d(np.asarray(d.get("memory", t.total_memory)))
    t.code_type = d.get("code_type", "default")
    t.is_feedforward = False
    t.g_taps = None
    t.next_state_table = np.asarray(d["next_state_table"]).astype(int)
    t.output_table = np.asarray(d["output_table"]).astype(int)
    S, I = t.number_states, t.number_inputs
    if t.next_state_table.shape != (S, I) or t.output_table.shape != (S, I):
        raise ValueError(f"forward tables must be [{S}, {I}]")
    t._build_inverse_tables()
    for key in TABLE_KEYS[2:]:
        if not np.array_equal(getattr(t, key), np.asarray(d[key])):
            raise ValueError(f"{key} disagrees with the forward tables")
    return t


def _public_copy(d: dict) -> dict:
    """The dict without private (``_``-prefixed) keys, arrays copied."""
    out = {}
    for key, value in d.items():
        if key.startswith("_"):
            continue
        if isinstance(value, np.ndarray):
            value = value.copy()
        elif sp.issparse(value):
            value = value.copy()
        elif isinstance(value, dict):
            value = _public_copy(value)
        out[key] = value
    return out


def qc_params_from_arrays(d: dict) -> dict:
    """A port QC params dict from a JAX package one (same schema).

    Checks ``Mb``, ``Nb``, ``Z``, ``K``, ``n_vnodes`` and ``k_bits``
    against ``block_j``/``block_s``, the block tables against
    ``base_matrix`` where there is one (DVB-S2 params: against the
    address table, ``pos_masks`` included), and the encoder against H
    (``encode_matrix`` algebraically; the structured dual-diagonal and
    NR encoders on a random message).  Raises ``ValueError`` on any
    disagreement.
    """
    from .ops import qcldpc as Q

    q = _public_copy(d)
    q["block_j"] = np.asarray(q["block_j"], np.int32)
    q["block_s"] = np.asarray(q["block_s"], np.int32)
    Mb, K = q["block_j"].shape
    Z, Nb = int(q["Z"]), int(q["Nb"])
    if (Mb, K) != (q["Mb"], q["K"]) or q["block_s"].shape != (Mb, K):
        raise ValueError("Mb/K disagree with block_j/block_s")
    if q["n_vnodes"] != Nb * Z:
        raise ValueError(f"n_vnodes {q['n_vnodes']} != Nb*Z {Nb * Z}")
    if "pos_masks" in q:
        q["pos_masks"] = tuple((int(i), int(k), tuple(int(p) for p in exc))
                               for (i, k, exc) in q["pos_masks"])
    if "dvbs2" in q:
        from .ops.dvbs2 import dvbs2_qc_params

        t = q["dvbs2"]
        t["table"] = tuple(tuple(int(x) for x in row) for row in t["table"])
        ref = dvbs2_qc_params(t["table"], t["n"], t["rate"])
        for key in ("block_j", "block_s", "pos_masks", "k_bits", "Mb", "Nb"):
            if not np.array_equal(np.asarray(ref[key], dtype=object),
                                  np.asarray(q[key], dtype=object)):
                raise ValueError(f"{key} disagrees with the address table")
        return q
    if q.get("base_matrix") is None:
        raise ValueError("QC params need a base_matrix or a dvbs2 table")
    q["base_matrix"] = np.asarray(q["base_matrix"], np.int32)
    ref = Q.qc_code_params(q["base_matrix"], Z, compute_encoder=False)
    for key in ("block_j", "block_s", "Mb", "Nb", "K", "k_bits"):
        if not np.array_equal(np.asarray(ref[key]), np.asarray(q[key])):
            raise ValueError(f"{key} disagrees with base_matrix")
    H = Q.expand_base_matrix(q["base_matrix"], Z).astype(np.int64)
    k = q["k_bits"]
    if "encode_matrix" in q:
        P = np.asarray(q["encode_matrix"]).astype(np.int64)
        if P.shape != (H.shape[0], k) or ((H[:, :k] + H[:, k:] @ P)
                                          % 2).any():
            raise ValueError("encode_matrix does not satisfy H c = 0")
        q["encode_matrix"] = P.astype(np.int8)
    elif q.get("parity_structure") in ("dual_diagonal", "nr_triangular"):
        msg = np.random.RandomState(0).randint(0, 2, (1, k)).astype(np.int8)
        if q["parity_structure"] == "dual_diagonal":
            cw = Q.qc_encode_device(msg, q, device="cpu")
        else:
            from .ops.nrldpc import nr_encode_device

            cw = nr_encode_device(msg, q, device="cpu")
        if ((H @ cw.numpy()[0].astype(np.int64)) % 2).any():
            raise ValueError(f"the {q['parity_structure']} encoder does "
                             "not satisfy H c = 0")
    return q


def ldpc_params_from_arrays(d: dict) -> dict:
    """A port design-file LDPC params dict from a JAX package one.

    Checks that the variable- and check-node adjacency lists describe one
    edge set with the stated degrees, and, where present, that
    ``parity_check_matrix`` is that H and ``generator_matrix`` is what
    :func:`~commpy_tpu_torch.ops.ldpc.build_matrix` makes of it.  Raises
    ``ValueError`` on any disagreement.
    """
    q = _public_copy(d)
    n_v, n_c = int(q["n_vnodes"]), int(q["n_cnodes"])
    cd, vd = int(q["max_cnode_deg"]), int(q["max_vnode_deg"])
    for key in ("cnode_adj_list", "vnode_adj_list", "cnode_vnode_map",
                "vnode_cnode_map"):
        q[key] = np.asarray(q[key], np.int32)
    for key in ("cnode_deg_list", "vnode_deg_list"):
        q[key] = np.asarray(q[key], np.int32)
    cadj = q["cnode_adj_list"].reshape(n_c, cd)
    vadj = q["vnode_adj_list"].reshape(n_v, vd)
    if not (np.array_equal((cadj >= 0).sum(1), q["cnode_deg_list"])
            and np.array_equal((vadj >= 0).sum(1), q["vnode_deg_list"])):
        raise ValueError("adjacency lists disagree with the degree lists")
    rows = np.repeat(np.arange(n_c), q["cnode_deg_list"])
    H = np.zeros((n_c, n_v), np.int64)
    H[rows, cadj[cadj >= 0]] = 1
    Hv = np.zeros((n_c, n_v), np.int64)
    Hv[vadj[vadj >= 0], np.repeat(np.arange(n_v), q["vnode_deg_list"])] = 1
    if not np.array_equal(H, Hv):
        raise ValueError("vnode and cnode adjacency disagree on the edges")
    if q.get("parity_check_matrix") is not None:
        if not np.array_equal(np.asarray(q["parity_check_matrix"]
                                         .todense()) % 2, H):
            raise ValueError("parity_check_matrix disagrees with the "
                             "adjacency lists")
    if q.get("generator_matrix") is not None:
        # build_matrix inverts H's last n_c columns over the reals, which
        # gives a GF(2) encoder only for near-triangular codes: hold the
        # given matrix to that construction, not to H c = 0
        from .ops.ldpc import build_matrix

        ref = {key: q[key] for key in ("n_cnodes", "n_vnodes",
                                       "max_cnode_deg", "cnode_adj_list",
                                       "cnode_deg_list")}
        build_matrix(ref)
        G, G_ref = q["generator_matrix"], ref["generator_matrix"]
        if G.shape != G_ref.shape or not np.allclose(
                np.asarray(G.todense()), np.asarray(G_ref.todense())):
            raise ValueError("generator_matrix disagrees with build_matrix "
                             "of the adjacency lists")
    return q


def turbo_params_from_arrays(d: dict):
    """A port turbo code ``(Trellis, p_array)`` from NumPy arrays.

    ``d`` holds the component trellis as :func:`trellis_tables` gives it
    (read off a ``commpy_tpu`` Trellis) and ``p_array``, the interleaver
    permutation, which must be a permutation of ``range(L)``.  Raises
    ``ValueError`` otherwise.
    """
    trellis = trellis_from_tables(d)
    p = np.asarray(d["p_array"])
    if p.ndim != 1 or not np.issubdtype(p.dtype, np.integer) or not \
            np.array_equal(np.sort(p), np.arange(p.size)):
        raise ValueError("p_array is not a permutation of range(L)")
    return trellis, p.astype(np.int64)


def _fields(d, keys) -> dict:
    """``d``'s ``keys`` as Python ints (genpoly / poly as int tuples); ``d``
    is a dict or any object with those attributes."""
    get = d.get if isinstance(d, dict) else (lambda k: getattr(d, k, None))
    missing = [key for key in keys if get(key) is None]
    if missing:
        raise KeyError(f"missing fields: {missing}")
    return {key: (tuple(int(c) for c in get(key))
                  if key in ("genpoly", "poly") else int(get(key)))
            for key in keys}


def bch_code_from_fields(d):
    """A port :class:`~commpy_tpu_torch.ops.bch.BchCode` from ``{n, k, m,
    t, genpoly}`` (read off a JAX package ``BchCode``): the port's
    ``bch_construct(m, t, shorten=2^m - 1 - n)`` must give the same k and
    generator polynomial, else ``ValueError``."""
    from .ops.bch import bch_construct

    f = _fields(d, ("n", "k", "m", "t", "genpoly"))
    code = bch_construct(f["m"], f["t"], shorten=(1 << f["m"]) - 1 - f["n"])
    if (code.k, code.genpoly) != (f["k"], f["genpoly"]):
        raise ValueError(f"fields {f} disagree with the BCH code of m="
                         f"{f['m']}, t={f['t']}, n={f['n']} (k={code.k})")
    return code


def rs_code_from_fields(d):
    """A port :class:`~commpy_tpu_torch.ops.rs.RsCode` from ``{n, k, m, t,
    fcr, genpoly}`` (read off a JAX package ``RsCode``): the port's
    ``rs_construct`` must give the same k and generator polynomial, else
    ``ValueError``."""
    from .ops.rs import rs_construct

    f = _fields(d, ("n", "k", "m", "t", "fcr", "genpoly"))
    code = rs_construct(f["m"], f["t"], shorten=(1 << f["m"]) - 1 - f["n"],
                        fcr=f["fcr"])
    if (code.k, code.genpoly) != (f["k"], f["genpoly"]):
        raise ValueError(f"fields {f} disagree with the RS code of m="
                         f"{f['m']}, t={f['t']}, n={f['n']}, fcr={f['fcr']}")
    return code


def crc_spec_from_fields(d, name=None):
    """A port :class:`~commpy_tpu_torch.ops.crc.CrcSpec` from ``{poly,
    init, xorout}`` (read off a JAX package ``CrcSpec``).

    ``poly`` must be MSB-first 0/1 coefficients with a leading and a
    constant term, and ``init``/``xorout`` must fit its width.  With
    ``name`` the poly must be the port's named one: a JAX package crc24c
    spec is refused, since the port's crc24c is the 3GPP polynomial (see
    ``ops/crc.py``).  Raises ``ValueError`` otherwise.
    """
    from .ops.crc import CRC_POLYNOMIALS, CrcSpec

    f = _fields(d, ("poly", "init", "xorout"))
    poly = f["poly"]
    r = len(poly) - 1
    if r < 1 or set(poly) - {0, 1} or poly[0] != 1 or poly[-1] != 1:
        raise ValueError(f"poly {poly} is not a CRC generator (0/1, "
                         "leading and constant terms set)")
    if not (0 <= f["init"] < 1 << r and 0 <= f["xorout"] < 1 << r):
        raise ValueError(f"init/xorout do not fit {r} bits")
    if name is not None and CRC_POLYNOMIALS[name] != poly:
        raise ValueError(f"poly {poly} is not the port's {name} "
                         f"{CRC_POLYNOMIALS[name]}")
    return CrcSpec(poly=poly, init=f["init"], xorout=f["xorout"])


def polar_code_from_fields(d):
    """A port :class:`~commpy_tpu_torch.ops.polar.PolarCode` from ``{N, K,
    frozen, crc, rm, systematic}`` (read off a JAX package ``PolarCode``).

    ``crc`` (None, or a CrcSpec's fields) goes through
    :func:`crc_spec_from_fields`; a code whose CRC is the JAX package's
    crc24c keeps that polynomial, which is not the port's crc24c.  The
    port's ``PolarCode`` checks the mask against N, K and the CRC length;
    a systematic code's payload must reappear at its info positions.
    Raises ``ValueError`` otherwise.
    """
    from .ops.polar import PolarCode, _check_systematic

    get = d.get if isinstance(d, dict) else (lambda k: getattr(d, k, None))
    crc = get("crc")
    rm = get("rm")
    code = PolarCode(
        N=int(get("N")), K=int(get("K")),
        frozen=tuple(bool(f) for f in get("frozen")),
        crc=None if crc is None else crc_spec_from_fields(crc),
        rm=None if rm is None else (str(rm[0]), int(rm[1])),
        systematic=bool(get("systematic")))
    if code.rm and code.rm[0] not in ("shorten", "puncture", "repeat"):
        raise ValueError(f"unknown rate-matching mode {code.rm[0]!r}")
    if code.systematic:
        _check_systematic(code)
    return code
