"""Carry state across from the JAX package.

The conv-coded link has no weights: its "parameters" are the code's
trellis tables and the modem's constellation.  Constellations pass
through as NumPy arrays.  :func:`trellis_from_tables` rebuilds a port
:class:`~commpy_tpu_torch.ops.trellis.Trellis` from a dict of NumPy tables
(for example read off a ``commpy_tpu`` Trellis), checking the inverse
tables against the forward ones, so a decoder can run on a code whose
generator description is not at hand.
"""
from __future__ import annotations

import numpy as np

from .ops.trellis import Trellis

__all__ = ["TABLE_KEYS", "trellis_tables", "trellis_from_tables"]

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
