"""Quasi-cyclic LDPC codes: base-graph expansion, GF(2) systematic
encoding, and belief propagation over the circulant structure.

Counterpart of ``commpy_tpu/ops/qcldpc.py``.  H is an ``[Mb x Nb]`` grid
of ``Z x Z`` blocks, each zero or a cyclic shift ``P^s`` of the identity:
check ``(i, z)`` connects variable ``(j, (z + s) % Z)`` for every nonzero
block ``(j, s)`` of row i, so every message permutation is a cyclic roll
of the Z axis.

* The host tables (the twelve IEEE 802.11n Annex R base matrices,
  :func:`qc_code_params`, :func:`detect_qc_structure`, :func:`qc_girth`,
  :func:`random_qc_params`, ...) are NumPy, copied from the JAX package
  with the same dict schema.
* :func:`qc_encoder` / :func:`qc_encode_device` encode on the device
  (dense GF(2) ``P`` product, or the structured dual-diagonal path).
* :func:`qc_bp_decode_device` decodes with SPA or (normalised/offset)
  MSA, flooding or layered.  ``backend='auto'`` routes by
  :func:`select_backend`: the resident kernel K4 when it takes the code
  on the card (its messages fit in shared memory, its rows and Z within
  the kernel's limits), else the streamed layered kernel K5 when it
  does, else the plain PyTorch core ``_qc_bp_core`` (the
  counterpart of the JAX package's XLA core, on the ``[B, Mb, Z, K]``
  edge tensor).  The kernels live in ``kernels/qc_bp.py``.
* :func:`qc_bp_decode_sharded` splits one graph's circulant axis over the
  ranks of a mesh (flooding, the plain core's arithmetic).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.qc_bp import (LLR_MAX, qc_bp_resident, qc_bp_streamed,
                             resident_plan, sign_keep_zero, streamed_plan)
from ..parallel.mesh import (NamedSharding, P, axis_index, axis_size,
                             check_axis, ppermute, psum)
from ..utils.device import device_constant, on_device, resolve_device

__all__ = [
    "qc_code_params",
    "expand_base_matrix",
    "detect_qc_structure",
    "ieee80211n_params",
    "random_qc_params",
    "qc_girth",
    "qc_export_design",
    "qc_encoder",
    "qc_encode_device",
    "qc_bp_decode_device",
    "qc_bp_decode_sharded",
    "select_backend",
    "qc_rows",
    "IEEE80211N_BASE",
    "BACKENDS",
]

_llr_max = LLR_MAX  # reference ldpc.py:11 clipping
BACKENDS = ("auto", "resident", "streamed", "torch")

# --------------------------------------------------------------------------
# IEEE 802.11n base matrices (Annex R), -1 = zero block
# --------------------------------------------------------------------------

_80211N_R12_Z27 = """
 0 -1 -1 -1  0  0 -1 -1  0 -1 -1  0  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
22  0 -1 -1 17 -1  0  0 12 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
 6 -1  0 -1 10 -1 -1 -1 24 -1  0 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
 2 -1 -1  0 20 -1 -1 -1 25  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
23 -1 -1 -1  3 -1 -1 -1  0 -1  9 11 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
24 -1 23  1 17 -1  3 -1 10 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
25 -1 -1 -1  8 -1 -1 -1  7 18 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
13 24 -1 -1  0 -1  8 -1  6 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
 7 20 -1 16 22 10 -1 -1 23 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
11 -1 -1 -1 19 -1 -1 -1 13 -1  3 17 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
25 -1  8 -1 23 18 -1 14  9 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
 3 -1 -1 -1 16 -1 -1  2 25  5 -1 -1  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""

_80211N_R12_Z81 = """
57 -1 -1 -1 50 -1 11 -1 50 -1 79 -1  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
 3 -1 28 -1  0 -1 -1 -1 55  7 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
30 -1 -1 -1 24 37 -1 -1 56 14 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
62 53 -1 -1 53 -1 -1  3 35 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
40 -1 -1 20 66 -1 -1 22 28 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
 0 -1 -1 -1  8 -1 42 -1 50 -1 -1  8 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
69 79 79 -1 -1 -1 56 -1 52 -1 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
65 -1 -1 -1 38 57 -1 -1 72 -1 27 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
64 -1 -1 -1 14 52 -1 -1 30 -1 -1 32 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
-1 45 -1 70  0 -1 -1 -1 77  9 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
 2 56 -1 57 35 -1 -1 -1 -1 -1 12 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
24 -1 61 -1 60 -1 -1 27 51 -1 -1 16  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""


_80211N_R23_Z27 = """
25 26 14 -1 20 -1  2 -1  4 -1 -1  8 -1 16 -1 18  1  0 -1 -1 -1 -1 -1 -1
10  9 15 11 -1  0 -1  1 -1 -1 18 -1  8 -1 10 -1 -1  0  0 -1 -1 -1 -1 -1
16  2 20 26 21 -1  6 -1  1 26 -1  7 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
10 13  5  0 -1  3 -1  7 -1 -1 26 -1 -1 13 -1 16 -1 -1 -1  0  0 -1 -1 -1
23 14 24 -1 12 -1 19 -1 17 -1 -1 -1 20 -1 21 -1  0 -1 -1 -1  0  0 -1 -1
 6 22  9 20 -1 25 -1 17 -1  8 -1 14 -1 18 -1 -1 -1 -1 -1 -1 -1  0  0 -1
14 23 21 11 20 -1 24 -1 18 -1 19 -1 -1 -1 -1 22 -1 -1 -1 -1 -1 -1  0  0
17 11 11 20 -1 21 -1 26 -1  3 -1 -1 18 -1 26 -1  1 -1 -1 -1 -1 -1 -1  0
"""

_80211N_R34_Z27 = """
16 17 22 24  9  3 14 -1  4  2  7 -1 26 -1  2 -1 21 -1  1  0 -1 -1 -1 -1
25 12 12  3  3 26  6 21 -1 15 22 -1 15 -1  4 -1 -1 16 -1  0  0 -1 -1 -1
25 18 26 16 22 23  9 -1  0 -1  4 -1  4 -1  8 23 11 -1 -1 -1  0  0 -1 -1
 9  7  0  1 17 -1 -1  7  3 -1  3 23 -1 16 -1 -1 21 -1  0 -1 -1  0  0 -1
24  5 26  7  1 -1 -1 15 24 15 -1  8 -1 13 -1 13 -1 11 -1 -1 -1 -1  0  0
 2  2 19 14 24  1 15 19 -1 21 -1  2 -1 24 -1  3 -1  2  1 -1 -1 -1 -1  0
"""

_80211N_R56_Z27 = """
17 13  8 21  9  3 18 12 10  0  4 15 19  2  5 10 26 19 13 13  1  0 -1 -1
 3 12 11 14 11 25  5 18  0  9  2 26 26 10 24  7 14 20  4  2 -1  0  0 -1
22 16  4  3 10 21 12  5 21 14 19  5 -1  8  5 18 11  5  5 15  0 -1  0  0
 7  7 14 14  4 16 16 24 24 10  1  7 15  6 10 26  8 18 21 14  1 -1 -1  0
"""

_80211N_R12_Z54 = """
40 -1 -1 -1 22 -1 49 23 43 -1 -1 -1  1  0 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
50  1 -1 -1 48 35 -1 -1 13 -1 30 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1 -1
39 50 -1 -1  4 -1  2 -1 -1 -1 -1 49 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1 -1
33 -1 -1 38 37 -1 -1  4  1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1 -1
45 -1 -1 -1  0 22 -1 -1 20 42 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1 -1
51 -1 -1 48 35 -1 -1 -1 44 -1 18 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
47 11 -1 -1 -1 17 -1 -1 51 -1 -1 -1  0 -1 -1 -1 -1 -1  0  0 -1 -1 -1 -1
 5 -1 25 -1  6 -1 45 -1 13 40 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1 -1
33 -1 -1 34 24 -1 -1 -1 23 -1 -1 46 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1 -1
 1 -1 27 -1  1 -1 -1 -1 38 -1 44 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0 -1
-1 18 -1 -1 23 -1 -1  8  0 35 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0  0
49 -1 17 -1 30 -1 -1 -1 34 -1 -1 19  1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1  0
"""

_80211N_R23_Z54 = """
39 31 22 43 -1 40  4 -1 11 -1 -1 50 -1 -1 -1  6  1  0 -1 -1 -1 -1 -1 -1
25 52 41  2  6 -1 14 -1 34 -1 -1 -1 24 -1 37 -1 -1  0  0 -1 -1 -1 -1 -1
43 31 29  0 21 -1 28 -1 -1  2 -1 -1  7 -1 17 -1 -1 -1  0  0 -1 -1 -1 -1
20 33 48 -1  4 13 -1 26 -1 -1 22 -1 -1 46 42 -1 -1 -1 -1  0  0 -1 -1 -1
45  7 18 51 12 25 -1 -1 -1 50 -1 -1  5 -1 -1 -1  0 -1 -1 -1  0  0 -1 -1
35 40 32 16  5 -1 -1 18 -1 -1 43 51 -1 32 -1 -1 -1 -1 -1 -1 -1  0  0 -1
 9 24 13 22 28 -1 -1 37 -1 -1 25 -1 -1 52 -1 13 -1 -1 -1 -1 -1 -1  0  0
32 22  4 21 16 -1 -1 -1 27 28 -1 38 -1 -1 -1  8  1 -1 -1 -1 -1 -1 -1  0
"""

_80211N_R34_Z54 = """
39 40 51 41  3 29  8 36 -1 14 -1  6 -1 33 -1 11 -1  4  1  0 -1 -1 -1 -1
48 21 47  9 48 35 51 -1 38 -1 28 -1 34 -1 50 -1 50 -1 -1  0  0 -1 -1 -1
30 39 28 42 50 39  5 17 -1  6 -1 18 -1 20 -1 15 -1 40 -1 -1  0  0 -1 -1
29  0  1 43 36 30 47 -1 49 -1 47 -1  3 -1 35 -1 34 -1  0 -1 -1  0  0 -1
 1 32 11 23 10 44 12  7 -1 48 -1  4 -1  9 -1 17 -1 16 -1 -1 -1 -1  0  0
13  7 15 47 23 16 47 -1 43 -1 29 -1 52 -1  2 -1 53 -1  1 -1 -1 -1 -1  0
"""

_80211N_R56_Z54 = """
48 29 37 52  2 16  6 14 53 31 34  5 18 42 53 31 45 -1 46 52  1  0 -1 -1
17  4 30  7 43 11 24  6 14 21  6 39 17 40 47  7 15 41 19 -1 -1  0  0 -1
 7  2 51 31 46 23 16 11 53 40 10  7 46 53 33 35 -1 25 35 38  0 -1  0  0
19 48 41  1 10  7 36 47  5 29 52 52 31 10 26  6  3  2 -1 51  1 -1 -1  0
"""

_80211N_R23_Z81 = """
61 75  4 63 56 -1 -1 -1 -1 -1 -1  8 -1  2 17 25  1  0 -1 -1 -1 -1 -1 -1
56 74 77 20 -1 -1 -1 64 24  4 67 -1  7 -1 -1 -1 -1  0  0 -1 -1 -1 -1 -1
28 21 68 10  7 14 65 -1 -1 -1 23 -1 -1 -1 75 -1 -1 -1  0  0 -1 -1 -1 -1
48 38 43 78 76 -1 -1 -1 -1  5 36 -1 15 72 -1 -1 -1 -1 -1  0  0 -1 -1 -1
40  2 53 25 -1 52 62 -1 20 -1 -1 44 -1 -1 -1 -1  0 -1 -1 -1  0  0 -1 -1
69 23 64 10 22 -1 21 -1 -1 -1 -1 -1 68 23 29 -1 -1 -1 -1 -1 -1  0  0 -1
12  0 68 20 55 61 -1 40 -1 -1 -1 52 -1 -1 -1 44 -1 -1 -1 -1 -1 -1  0  0
58  8 34 64 78 -1 -1 11 78 24 -1 -1 -1 -1 -1 58  1 -1 -1 -1 -1 -1 -1  0
"""

_80211N_R34_Z81 = """
48 29 28 39  9 61 -1 -1 -1 63 45 80 -1 -1 -1 37 32 22  1  0 -1 -1 -1 -1
 4 49 42 48 11 30 -1 -1 -1 49 17 41 37 15 -1 54 -1 -1 -1  0  0 -1 -1 -1
35 76 78 51 37 35 21 -1 17 64 -1 -1 -1 59  7 -1 -1 32 -1 -1  0  0 -1 -1
 9 65 44  9 54 56 73 34 42 -1 -1 -1 35 -1 -1 -1 46 39  0 -1 -1  0  0 -1
 3 62  7 80 68 26 -1 80 55 -1 36 -1 26 -1  9 -1 72 -1 -1 -1 -1 -1  0  0
26 75 33 21 69 59  3 38 -1 -1 -1 35 -1 62 36 26 -1 -1  1 -1 -1 -1 -1  0
"""

_80211N_R56_Z81 = """
13 48 80 66  4 74  7 30 76 52 37 60 -1 49 73 31 74 73 23 -1  1  0 -1 -1
69 63 74 56 64 77 57 65  6 16 51 -1 64 -1 68  9 48 62 54 27 -1  0  0 -1
51 15  0 80 24 25 42 54 44 71 71  9 67 35 -1 58 -1 29 -1 53  0 -1  0  0
16 29 36 41 44 56 59 37 50 24 -1 65  4 65 52 -1  4 -1 73 52  1 -1 -1  0
"""


def _parse_base(text: str) -> np.ndarray:
    rows = [r.split() for r in text.strip().splitlines()]
    return np.array([[int(v) for v in r] for r in rows], np.int32)


IEEE80211N_BASE = {
    (648, "1/2"): (_parse_base(_80211N_R12_Z27), 27),
    (648, "2/3"): (_parse_base(_80211N_R23_Z27), 27),
    (648, "3/4"): (_parse_base(_80211N_R34_Z27), 27),
    (648, "5/6"): (_parse_base(_80211N_R56_Z27), 27),
    (1296, "1/2"): (_parse_base(_80211N_R12_Z54), 54),
    (1296, "2/3"): (_parse_base(_80211N_R23_Z54), 54),
    (1296, "3/4"): (_parse_base(_80211N_R34_Z54), 54),
    (1296, "5/6"): (_parse_base(_80211N_R56_Z54), 54),
    (1944, "1/2"): (_parse_base(_80211N_R12_Z81), 81),
    (1944, "2/3"): (_parse_base(_80211N_R23_Z81), 81),
    (1944, "3/4"): (_parse_base(_80211N_R34_Z81), 81),
    (1944, "5/6"): (_parse_base(_80211N_R56_Z81), 81),
}


# --------------------------------------------------------------------------
# Parameter construction (host)
# --------------------------------------------------------------------------

def _gf2_parity_solver(H: np.ndarray, n_parity: int) -> np.ndarray:
    """Dense GF(2) encode matrix: parity = (P @ msg) % 2.

    H ``[M, N]`` with the message on the first N - n_parity columns.
    Solves Hp * p = Hi * m by Gauss-Jordan over GF(2) (host, int8).
    """
    M, N = H.shape
    k = N - n_parity
    A = np.concatenate([H[:, k:].astype(np.int8),
                        H[:, :k].astype(np.int8)], axis=1)  # [Hp | Hi]
    # eliminate on the first n_parity columns
    for col in range(n_parity):
        piv = col + np.argmax(A[col:, col] != 0)
        if A[piv, col] == 0:
            raise ValueError("parity part of H is singular over GF(2)")
        if piv != col:
            A[[col, piv]] = A[[piv, col]]
        hit = (A[:, col] == 1)
        hit[col] = False
        A[hit] ^= A[col]
    return A[:, n_parity:]  # [n_parity, k]: p = P m (mod 2)


def qc_code_params(base_matrix, Z: int, compute_encoder: bool = True) -> dict:
    """Build decode/encode parameters from a QC base matrix.

    base_matrix ``[Mb, Nb]`` of circulant shifts (-1 = zero block).
    The message occupies the first ``(Nb - Mb) * Z`` bits (standard QC
    systematic layout).
    """
    Bm = np.asarray(base_matrix, np.int32)
    Mb, Nb = Bm.shape
    blocks = [
        [(j, int(Bm[i, j])) for j in range(Nb) if Bm[i, j] >= 0]
        for i in range(Mb)
    ]
    K = max(len(b) for b in blocks)
    block_j = -np.ones((Mb, K), np.int32)
    block_s = np.zeros((Mb, K), np.int32)
    for i, row in enumerate(blocks):
        for k, (j, s) in enumerate(row):
            block_j[i, k] = j
            block_s[i, k] = s
    params = {
        "base_matrix": Bm,
        "Z": int(Z),
        "Mb": Mb,
        "Nb": Nb,
        "K": K,
        "block_j": block_j,
        "block_s": block_s,
        "n_vnodes": Nb * Z,
        "n_cnodes": Mb * Z,
        "k_bits": (Nb - Mb) * Z,
    }
    if compute_encoder:
        H = expand_base_matrix(Bm, Z)
        params["encode_matrix"] = _gf2_parity_solver(H, Mb * Z)
    return params


def expand_base_matrix(Bm: np.ndarray, Z: int) -> np.ndarray:
    """Dense H ``[Mb Z, Nb Z]`` int8 from the base matrix (host)."""
    Mb, Nb = Bm.shape
    H = np.zeros((Mb * Z, Nb * Z), np.int8)
    eye = np.eye(Z, dtype=np.int8)
    for i in range(Mb):
        for j in range(Nb):
            s = Bm[i, j]
            if s >= 0:
                # P^s: row z has its 1 at column (z + s) % Z
                H[i * Z:(i + 1) * Z, j * Z:(j + 1) * Z] = np.roll(
                    eye, s % Z, axis=1
                )
    return H


def detect_qc_structure(ldpc_code_params: dict, Z: int):
    """Lift a generic design-file code onto the QC path if possible.

    Partitions the code's H into Z x Z blocks and checks each is zero or
    a cyclic shift of the identity.  Returns qc params (without the
    encoder, which design files already provide) or None.
    """
    n_c = ldpc_code_params["n_cnodes"]
    n_v = ldpc_code_params["n_vnodes"]
    if n_c % Z or n_v % Z:
        return None
    Mb, Nb = n_c // Z, n_v // Z
    cd = ldpc_code_params["max_cnode_deg"]
    adj = ldpc_code_params["cnode_adj_list"].reshape(n_c, cd)
    H = np.zeros((n_c, n_v), np.int8)
    deg = ldpc_code_params["cnode_deg_list"]
    for c in range(n_c):
        H[c, adj[c, : deg[c]]] = 1
    Bm = -np.ones((Mb, Nb), np.int32)
    eye = np.eye(Z, dtype=np.int8)
    for i in range(Mb):
        for j in range(Nb):
            blk = H[i * Z:(i + 1) * Z, j * Z:(j + 1) * Z]
            nz = blk.sum()
            if nz == 0:
                continue
            if nz != Z:
                return None
            s = int(np.argmax(blk[0]))
            if not np.array_equal(blk, np.roll(eye, s, axis=1)):
                return None
            Bm[i, j] = s
    return qc_code_params(Bm, Z, compute_encoder=False)


def ieee80211n_params(n: int = 1944, rate: str = "1/2") -> dict:
    """IEEE 802.11n LDPC code parameters (Annex R base matrices).

    All twelve standard configurations are shipped: ``n`` in
    {648, 1296, 1944} x ``rate`` in {"1/2", "2/3", "3/4", "5/6"}.
    (The reference ships only Gallager/WiMAX design files,
    commpy/channelcoding/ldpc.py:51; these are the real production
    tables its text format was meant for.)
    """
    try:
        Bm, Z = IEEE80211N_BASE[(n, rate)]
    except KeyError:
        raise ValueError(
            f"no shipped 802.11n base matrix for (n={n}, rate={rate}); "
            f"available: {sorted(IEEE80211N_BASE)}"
        )
    return qc_code_params(Bm, Z)


def _has_6cycle_through(Bm: np.ndarray, Z: int, j: int,
                        rows, shifts) -> bool:
    """True if placing column ``j`` with ``(rows, shifts)`` closes a
    lifted 6-cycle against the columns already in ``Bm``.

    A 6-cycle through column j uses two of its entries (r_a, j),
    (r_b, j) plus a row r3 reached from r_b via column c2 and returning
    to r_a via column c3; it lifts to a real cycle iff the alternating
    shift sum vanishes mod Z (Fossorier 2004, Thm 2.1):
    (s[r_a,j]-s[r_b,j]) + (s[r_b,c2]-s[r3,c2]) + (s[r3,c3]-s[r_a,c3])
    ≡ 0 (mod Z).
    """
    Mb, Nb = Bm.shape
    cols_of = [np.nonzero(Bm[r] >= 0)[0] for r in range(Mb)]
    w = len(rows)
    for a in range(w):
        for b in range(w):
            if a == b:
                continue
            ra, rb = int(rows[a]), int(rows[b])
            d_ab = (int(shifts[a]) - int(shifts[b])) % Z
            for c2 in cols_of[rb]:
                if c2 == j:
                    continue
                r3s = np.nonzero(Bm[:, c2] >= 0)[0]
                for r3 in r3s:
                    r3 = int(r3)
                    if r3 == rb or r3 == ra:
                        continue
                    d_bc = (int(Bm[rb, c2]) - int(Bm[r3, c2])) % Z
                    for c3 in cols_of[r3]:
                        if c3 == j or c3 == c2 or Bm[ra, c3] < 0:
                            continue
                        d_ca = (int(Bm[r3, c3]) - int(Bm[ra, c3])) % Z
                        if (d_ab + d_bc + d_ca) % Z == 0:
                            return True
    return False


def qc_girth(base_matrix, Z: int, cap: int = 8) -> int:
    """Girth of the LIFTED Tanner graph, certified up to ``cap``.

    Returns 4, 6, or ``cap`` (meaning girth >= cap; only cap=8 is
    implemented).  Block-level cycle test (Fossorier 2004): a base-graph
    cycle lifts to a real cycle iff its alternating circulant-shift sum
    vanishes mod Z — so girth is decided entirely on the (tiny) base
    matrix, never on the expanded H.
    """
    if cap != 8:
        raise NotImplementedError("qc_girth certifies up to girth 8")
    Bm = np.asarray(base_matrix, np.int32)
    Mb, Nb = Bm.shape
    # 4-cycles: a row pair sharing >= 2 columns with equal shift diff
    for r1 in range(Mb):
        for r2 in range(r1 + 1, Mb):
            both = np.nonzero((Bm[r1] >= 0) & (Bm[r2] >= 0))[0]
            if both.size < 2:
                continue
            diffs = (Bm[r1, both] - Bm[r2, both]) % Z
            if np.unique(diffs).size < diffs.size:
                return 4
    # 6-cycles: reuse the incremental test column by column (checking
    # column j against columns < j covers every triple exactly once)
    for j in range(Nb):
        rows = np.nonzero(Bm[:, j] >= 0)[0]
        sub = Bm.copy()
        sub[:, j:] = -1  # only earlier columns participate as c2/c3
        if _has_6cycle_through(sub, Z, j, rows, Bm[rows, j]):
            return 6
    return cap


def qc_export_design(params: dict, file_path: str) -> None:
    """Write a designed QC code as a reference-format design file.

    Round-trips through the text format the reference defines
    (ldpc.py:55-61): ``get_ldpc_code_params`` reads it back and
    ``detect_qc_structure`` re-lifts it onto the QC decode path — so a
    designed code interoperates with any tool speaking that format.
    """
    from .ldpc import write_ldpc_params

    H = expand_base_matrix(params["base_matrix"], params["Z"])
    write_ldpc_params(H, file_path)


def random_qc_params(Mb: int, Nb: int, Z: int, *, col_weight: int = 3,
                     seed: int = 0, girth_tries: int = 200,
                     target_girth: int = 6) -> dict:
    """Synthesize a production-scale QC-LDPC code (IRA-style protograph).

    The reference decodes only shipped design files (its largest is
    WiMAX n=1440, ldpc.py:51); this constructor generates codes at
    DVB-S2-class sizes (e.g. ``Mb=25, Nb=45, Z=360`` -> n=16200) that
    the roll-based QC path decodes at O(E) per iteration:

    * information columns get ``col_weight`` entries in distinct random
      check rows, with circulant shifts rejection-sampled to avoid
      4-cycles (girth >= 6 whenever ``girth_tries`` suffices);
      ``target_girth=8`` additionally rejects lifted 6-cycles
      (Fossorier shift-sum test), for girth >= 8 codes — the error-
      floor lever production code designs use;
    * the parity part is block dual-diagonal with identity blocks (the
      DVB-S2/IRA accumulator structure), so encoding is a cumulative
      XOR of per-row info syndromes — O(n), no dense GF(2) solve.

    Returns the same params dict as :func:`qc_code_params`, with
    ``parity_structure='dual_diagonal'`` selecting the structured
    encoder in :func:`qc_encode_device`.  Audit the result with
    :func:`qc_girth`; export it to the reference's design-file format
    with :func:`qc_export_design`.
    """
    if target_girth not in (6, 8):
        raise ValueError("target_girth must be 6 or 8")
    kb = Nb - Mb
    if kb <= 0:
        raise ValueError("Nb must exceed Mb")
    if not 2 <= col_weight <= Mb:
        raise ValueError("col_weight must be in [2, Mb]")
    rng = np.random.RandomState(seed)
    Bm = -np.ones((Mb, Nb), np.int32)
    # accumulator chain: row i checks parity blocks i-1 and i (shift 0)
    for i in range(Mb):
        Bm[i, kb + i] = 0
        if i > 0:
            Bm[i, kb + i - 1] = 0
    # 4-cycle bookkeeping: two columns sharing a row pair (r1, r2) form
    # a length-4 cycle iff their shift differences agree mod Z
    seen = {(i, i + 1): {0} for i in range(Mb - 1)}  # parity chain pairs
    for j in range(kb):
        for _ in range(girth_tries):
            rows = np.sort(rng.choice(Mb, col_weight, replace=False))
            shifts = rng.randint(0, Z, col_weight)
            pairs = [
                ((int(rows[a]), int(rows[b])),
                 int(shifts[a] - shifts[b]) % Z)
                for a in range(col_weight) for b in range(a + 1, col_weight)
            ]
            if not all(d not in seen.get(p, ()) for p, d in pairs):
                continue
            if target_girth >= 8 and _has_6cycle_through(
                    Bm, Z, j, rows, shifts):
                continue
            break
        for p, d in pairs:
            seen.setdefault(p, set()).add(d)
        Bm[rows, j] = shifts
    params = qc_code_params(Bm, Z, compute_encoder=False)
    params["parity_structure"] = "dual_diagonal"
    return params



# --------------------------------------------------------------------------
# Encoding
# --------------------------------------------------------------------------

def qc_encoder(qc_params: dict, device="cuda"):
    """``encode(message_bits [..., k]) -> codeword [..., n]`` int8 on
    ``device``, with the code's tables copied there once.

    Dense 0/1 product with the GF(2) encode matrix ``P`` (float32
    accumulation is exact: k < 2^24).  Dual-diagonal (IRA) codes from
    :func:`random_qc_params` take the structured O(n) path instead:
    per-row info syndromes are circulant rolls and the accumulator chain
    is one cumulative sum mod 2.
    """
    dev = resolve_device(device)
    if qc_params.get("parity_structure") == "dual_diagonal":
        Bm = np.asarray(qc_params["base_matrix"])
        Mb, Nb, Z = qc_params["Mb"], qc_params["Nb"], qc_params["Z"]
        kb = Nb - Mb

        def parity_of(m):
            mB = m.reshape(m.shape[:-1] + (kb, Z)).to(torch.float32)
            rows = []
            for i in range(Mb):
                acc = torch.zeros(m.shape[:-1] + (Z,), dtype=torch.float32,
                                  device=dev)
                for j in range(kb):
                    s = int(Bm[i, j])
                    if s >= 0:
                        acc = acc + torch.roll(mB[..., j, :], -s, dims=-1)
                rows.append(acc)
            s_rows = torch.stack(rows, dim=-2)  # [..., Mb, Z]
            # accumulator: p_i = p_{i-1} xor s_i (exact: sums < 2^24)
            parity = torch.remainder(torch.cumsum(s_rows, dim=-2), 2.0)
            return parity.reshape(m.shape[:-1] + (Mb * Z,))
    else:
        P = torch.as_tensor(np.asarray(qc_params["encode_matrix"]),
                            device=dev).to(torch.float32)  # [n_parity, k]

        def parity_of(m):
            return torch.remainder(m.to(torch.float32) @ P.T, 2.0)

    def encode(message_bits):
        m = on_device(message_bits, dev)
        return torch.cat([m.to(torch.int8), parity_of(m).to(torch.int8)],
                         dim=-1)

    return encode


def qc_encode_device(message_bits, qc_params: dict, device="cuda"):
    """Systematic QC encode ``[..., k] -> [..., n]`` int8 (parity
    appended) on ``device``; see :func:`qc_encoder`, which keeps the
    tables on the device across calls."""
    return qc_encoder(qc_params, device)(message_bits)


# --------------------------------------------------------------------------
# Decoding: the plain PyTorch core on the [B, Mb, Z, K] edge tensor
# --------------------------------------------------------------------------

def _loo_prod(x, mask):
    """Leave-one-out product over the last axis (prefix/suffix, exact)."""
    xm = torch.where(mask, x, 1.0)
    deg = xm.shape[-1]
    one = torch.ones_like(xm[..., :1])
    prefix = [one]
    for j in range(1, deg):
        prefix.append(prefix[-1] * xm[..., j - 1:j])
    suffix = [one]
    for j in range(deg - 2, -1, -1):
        suffix.append(suffix[-1] * xm[..., j + 1:j + 2])
    suffix.reverse()
    out = torch.cat([prefix[j] * suffix[j] for j in range(deg)], -1)
    return torch.where(mask, out, 0.0)


def _loo_min(mag, mask):
    """Leave-one-out min over the last axis (prefix/suffix mins)."""
    m = torch.where(mask, mag, torch.inf)
    deg = m.shape[-1]
    big = torch.full_like(m[..., :1], torch.inf)
    pref = [big]
    for j in range(1, deg):
        pref.append(torch.minimum(pref[-1], m[..., j - 1:j]))
    suf = [big]
    for j in range(deg - 2, -1, -1):
        suf.append(torch.minimum(suf[-1], m[..., j + 1:j + 2]))
    suf.reverse()
    return torch.cat([torch.minimum(pref[j], suf[j]) for j in range(deg)],
                     -1)


def _cn_update(v2c, m, algorithm, msa_scale, msa_offset):
    """Check-node update over the last axis (K) of the edge tensor, where
    ``m`` marks the edges: SPA, or normalised/offset min-sum (plain MSA
    at (1, 0) exactly)."""
    if algorithm == "SPA":
        t = torch.tanh(v2c * 0.5)
        prod = _loo_prod(t, m)
        msg = 2.0 * torch.atanh(torch.clamp(prod, -1.0, 1.0))
        return torch.clamp(msg, -_llr_max, _llr_max)
    sign = _loo_prod(sign_keep_zero(v2c), m)
    loo = _loo_min(torch.abs(v2c), m)
    mag = torch.clamp_min(msa_scale * loo - msa_offset, 0.0)
    return torch.where(m, sign * mag, 0.0)


@functools.lru_cache(maxsize=64)
def _core_index(Mb: int, Nb: int, Z: int, K: int, block_j: tuple,
                block_s: tuple):
    """Gather tables of the edge tensor (host, int64).

    eidx ``[Mb, Z, K]``: the variable that edge slot (i, z, k) reads,
    ``j*Z + (z + s) % Z`` (0 in empty slots, which every use masks).
    vidx ``[D, Nb, Z]``: flat edge-tensor index of the d-th block of
    column j (row-major order) seen from variable position z, the
    inverse roll; vvalid ``[D, Nb]``.
    """
    bj = np.asarray(block_j, np.int64).reshape(Mb, K)
    bs = np.asarray(block_s, np.int64).reshape(Mb, K)
    valid = bj >= 0
    z = np.arange(Z)
    eidx = np.where(valid[:, None, :],
                    bj[:, None, :] * Z + (z[None, :, None] + bs[:, None, :])
                    % Z, 0)
    blocks = [[] for _ in range(Nb)]
    for i in range(Mb):
        for k in range(K):
            if valid[i, k]:
                blocks[bj[i, k]].append((i, k, bs[i, k]))
    D = max(1, max(len(b) for b in blocks))
    vidx = np.zeros((D, Nb, Z), np.int64)
    vvalid = np.zeros((D, Nb), bool)
    for j, blist in enumerate(blocks):
        for d, (i, k, s) in enumerate(blist):
            vidx[d, j] = (i * Z + (z - s) % Z) * K + k
            vvalid[d, j] = True
    return valid, eidx, vidx, vvalid


def _qc_bp_core(llr, meta, algorithm: str, n_iters: int,
                msa_scale: float = 1.0, msa_offset: float = 0.0,
                schedule: str = "flooding", pos_mask=None):
    """BP over the QC edge tensor ``[B, Mb, Z, K]`` (plain PyTorch).

    The counterpart of the JAX package's XLA core, operation for
    operation: totals are ``llr + (((0 + c1) + c2) ...)`` over each
    column's blocks in row-major order, the batch iterates while any
    frame is unconverged (converged frames are frozen: their messages,
    decisions and flooding outputs latch), and the layered schedule adds
    the frozen frames' zero deltas to the totals as the XLA core does.
    The kernels' plain versions (``kernels/qc_bp.py``) follow the Pallas
    kernels' order and stop per frame instead; this core is kept beside
    them so that ``backend='torch'`` equals ``backend='xla'`` bit for bit.

    llr ``[B, Nb, Z]`` float32 (clipped); meta = (Mb, Nb, Z, K, block_j,
    block_s) with the block tables as nested tuples; ``pos_mask``
    optional ``[Mb, Z, K]`` bool, False where a nonzero circulant block
    lacks an edge.  Returns (dec int8 ``[B, n]``, posterior ``[B, n]``).
    """
    Mb, Nb, Z, K, block_j, block_s = meta
    B = llr.shape[0]
    dev = llr.device
    valid, eidx_np, vidx_np, vvalid_np = _core_index(Mb, Nb, Z, K, block_j,
                                                     block_s)
    mask = device_constant(valid, dev)[None, :, None, :]
    if pos_mask is not None:
        mask = mask & on_device(pos_mask, dev).to(torch.bool)[None]
    eidx = device_constant(eidx_np, dev)
    vidx = device_constant(vidx_np, dev)
    vvalid = device_constant(vvalid_np, dev)
    bj = np.asarray(block_j).reshape(Mb, K)
    sj = np.asarray(block_s).reshape(Mb, K)

    def to_edges(v):  # [B, Nb, Z] -> [B, Mb, Z, K]
        return v.reshape(B, Nb * Z)[:, eidx]

    def to_vnodes(e):  # [B, Mb, Z, K] -> [B, Nb, Z]
        flat = e.reshape(B, -1)
        acc = torch.zeros((B, Nb, Z), dtype=e.dtype, device=dev)
        for d in range(vidx.shape[0]):
            acc = torch.where(vvalid[d][:, None], acc + flat[:, vidx[d]],
                              acc)
        return acc

    def cn_update(v2c, m=mask):
        return _cn_update(v2c, m, algorithm, msa_scale, msa_offset)

    def total_llr(c2v):
        return llr + to_vnodes(torch.where(mask, c2v, 0.0))

    def syndrome_ok(dec):
        par = torch.sum(torch.where(mask, to_edges(dec.to(torch.float32)),
                                    0.0), dim=-1)  # [B, Mb, Z]
        return torch.all(torch.remainder(par, 2.0) == 0, dim=-1).all(-1)

    dec = torch.signbit(llr).to(torch.int8)
    c2v = torch.zeros((B, Mb, Z, K), dtype=torch.float32, device=dev)
    act = ~syndrome_ok(dec)
    out = llr
    if schedule == "layered":
        out = llr.clone()  # the running totals, updated row by row
    it = 0
    while it < n_iters and bool(act.any()):
        if schedule == "layered":
            tot = out
            for i in range(Mb):
                v2c = tot.reshape(B, Nb * Z)[:, eidx[i]] - c2v[:, i]
                mrow = mask[0, i][None]  # [1, Z, K]
                new_row = cn_update(torch.where(mrow, v2c, 0.0), mrow)
                new_row = torch.where(act[:, None, None], new_row,
                                      c2v[:, i])
                delta = torch.where(mrow, new_row - c2v[:, i], 0.0)
                for k in range(K):
                    j = int(bj[i, k])
                    if j >= 0:
                        tot[:, j] = tot[:, j] + torch.roll(
                            delta[..., k], int(sj[i, k]), dims=-1)
                c2v[:, i] = new_row
            new_dec = torch.signbit(tot).to(torch.int8)
            dec = torch.where(act[:, None, None], new_dec, dec)
        else:
            v2c = to_edges(total_llr(c2v))
            v2c = torch.where(mask, v2c - c2v, 0.0)
            new_c2v = cn_update(v2c)
            new_total = total_llr(new_c2v)
            new_dec = torch.signbit(new_total).to(torch.int8)
            c2v = torch.where(act[:, None, None, None], new_c2v, c2v)
            out = torch.where(act[:, None, None], new_total, out)
            dec = torch.where(act[:, None, None], new_dec, dec)
        act = act & ~syndrome_ok(dec)
        it += 1
    return dec.reshape(B, Nb * Z), out.reshape(B, Nb * Z)


# --------------------------------------------------------------------------
# Decoding: one graph's circulant axis split over the ranks of a mesh
# --------------------------------------------------------------------------

def _dist_roll(x, r: int, Z: int, mesh):
    """Global cyclic roll by ``r`` of a Z axis split over the ranks of
    ``mesh`` (local length ``Zl = Z/D``), SPMD.

    ``out[z] = x_global[(z + r) % Z]``.  With ``r = q*Zl + t``, rank d's
    slice needs elements of shards d+q and d+q+1: two ring shifts of the
    local tile and a local re-split (one shift when t == 0; none when q
    is a multiple of D).  x: ``[..., Zl]``.
    """
    D = axis_size(mesh)
    Zl = Z // D
    q, t = divmod(r % Z, Zl)
    a = ppermute(x, mesh, -q) if q % D else x
    if t == 0:
        return a
    b = ppermute(x, mesh, -(q + 1))
    return torch.cat([a[..., t:], b[..., :t]], dim=-1)


def qc_bp_decode_sharded(llr, qc_params: dict, decoder_algorithm: str,
                         n_iters: int, mesh, axis_name: str = "dp",
                         msa_scale: float = 1.0, msa_offset: float = 0.0):
    """Tensor-parallel QC BP: ONE Tanner graph split over the ranks of
    ``mesh`` along the circulant (Z) axis (SPMD).

    Every message tensor holds ``Z/D`` circulant positions a rank (memory
    and check-node work E/D each); the variable-node totals are
    positionwise on Z and need no collective; each circulant roll is at
    most two ring shifts (:func:`_dist_roll`); the only reduction is the
    convergence flag, one all-reduce of a [B] byte an iteration.  llr
    ``[..., n]`` is the same on every rank, and so are the outputs
    (gathered along Z at the end).

    Flooding schedule only (the layered sweep is serial across block
    rows); requires ``Z % n_devices == 0``.  The arithmetic is the plain
    flooding core's (``backend='torch'``), operation for operation.
    """
    if decoder_algorithm not in ("SPA", "MSA"):
        raise NameError(
            'Please input a valid decoder_algorithm string '
            '(meanning "SPA" or "MSA").'
        )
    if (msa_scale, msa_offset) != (1.0, 0.0) and decoder_algorithm != "MSA":
        raise ValueError("msa_scale/msa_offset apply to MSA only")
    check_axis(mesh, axis_name)
    Mb, Nb = qc_params["Mb"], qc_params["Nb"]
    Z, K = qc_params["Z"], qc_params["K"]
    D, idx = axis_size(mesh), axis_index(mesh)
    if Z % D:
        raise ValueError(
            f"Z-sharded decode needs Z % n_devices == 0 (Z={Z}, D={D}); "
            "shard the batch axis instead for this code"
        )
    Zl = Z // D
    bj = np.asarray(qc_params["block_j"])
    sj = np.asarray(qc_params["block_s"])
    valid = bj >= 0

    x = on_device(llr, mesh.device_type).to(torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    lead = x.shape[:-1]
    x = torch.clamp(x.reshape(-1, Nb, Z), -_llr_max, _llr_max)
    B = x.shape[0]
    dev = x.device
    xs = x[..., idx * Zl:(idx + 1) * Zl]

    pm = np.ones((Mb, Z, K), bool)
    for (i, k, excluded) in qc_params.get("pos_masks", ()):
        pm[i, list(excluded), k] = False
    pm &= valid[:, None, :]
    m = device_constant(pm[:, idx * Zl:(idx + 1) * Zl], dev)[None]
    zero = torch.zeros((B, Zl), dtype=torch.float32, device=dev)

    def to_edges(v):  # [B, Nb, Zl] -> [B, Mb, Zl, K]
        return torch.stack([
            torch.stack([_dist_roll(v[:, bj[i, k]], int(sj[i, k]) % Z, Z,
                                    mesh) if valid[i, k] else zero
                         for i in range(Mb)], dim=1)
            for k in range(K)], dim=-1)

    def to_vnodes(e):  # [B, Mb, Zl, K] -> [B, Nb, Zl], row-major order
        acc = [zero] * Nb
        for i in range(Mb):
            for k in range(K):
                if valid[i, k]:
                    acc[bj[i, k]] = acc[bj[i, k]] + _dist_roll(
                        e[:, i, :, k], -int(sj[i, k]) % Z, Z, mesh)
        return torch.stack(acc, dim=1)

    def total_llr(c2v):
        return xs + to_vnodes(torch.where(m, c2v, 0.0))

    def active(dec):
        par = torch.sum(torch.where(m, to_edges(dec.to(torch.float32)),
                                    0.0), dim=-1)  # [B, Mb, Zl]
        bad = torch.any(torch.remainder(par, 2.0) != 0, dim=-1).any(-1)
        # a frame is active while ANY shard still sees a violation
        return psum(bad, mesh)

    dec = torch.signbit(xs).to(torch.int8)
    c2v = torch.zeros((B, Mb, Zl, K), dtype=torch.float32, device=dev)
    out = xs
    act = active(dec)
    it = 0
    while it < n_iters and bool(act.any()):
        v2c = torch.where(m, to_edges(total_llr(c2v)) - c2v, 0.0)
        new_c2v = _cn_update(v2c, m, decoder_algorithm, msa_scale,
                             msa_offset)
        new_total = total_llr(new_c2v)
        new_dec = torch.signbit(new_total).to(torch.int8)
        c2v = torch.where(act[:, None, None, None], new_c2v, c2v)
        out = torch.where(act[:, None, None], new_total, out)
        dec = torch.where(act[:, None, None], new_dec, dec)
        act = act & active(dec)
        it += 1
    whole = NamedSharding(mesh, P(None, None, axis_name))
    dec = whole.gather(dec).reshape(lead + (Nb * Z,))
    out = whole.gather(out).reshape(lead + (Nb * Z,))
    if squeeze:
        return dec[0], out[0]
    return dec, out


# --------------------------------------------------------------------------
# Decoding: dispatch
# --------------------------------------------------------------------------

def qc_rows(qc_params: dict) -> tuple:
    """Each check block row's nonzero blocks ``((j, s), ...)`` in slot
    order, the graph the kernels take (shifts reduced mod Z)."""
    bj = np.asarray(qc_params["block_j"])
    bs = np.asarray(qc_params["block_s"])
    Z = int(qc_params["Z"])
    return tuple(
        tuple((int(bj[i, k]), int(bs[i, k]) % Z)
              for k in range(bj.shape[1]) if bj[i, k] >= 0)
        for i in range(bj.shape[0]))


def select_backend(qc_params: dict, schedule: str = "flooding") -> str:
    """The decoder ``backend='auto'`` runs for this code and schedule.

    ``'resident'`` (K4) when the code has no per-position edge masks and
    K4 takes it on the card; else ``'streamed'`` (K5) for the layered
    schedule when K5 takes it; else ``'torch'``, the plain core, as the
    JAX package takes its XLA core past its kernels' budgets.  "Takes
    it" is the kernel's launch plan
    (:func:`~commpy_tpu_torch.kernels.qc_bp.resident_plan`,
    :func:`~commpy_tpu_torch.kernels.qc_bp.streamed_plan`, float32
    messages), which its wrapper launches by: row width, Z, and the
    shared memory of a frame.  A pure function of the code: the same on
    every device.
    """
    Z, Nb = int(qc_params["Z"]), int(qc_params["Nb"])
    rows = qc_rows(qc_params)
    Mb, E, kmax = len(rows), sum(map(len, rows)), max(map(len, rows))
    repeat = any(len({j for j, _ in r}) < len(r) for r in rows)
    plans = {"resident": lambda: resident_plan(Z, Nb, Mb, E, kmax, schedule,
                                               repeat),
             "streamed": lambda: streamed_plan(Z, Nb, kmax, E, 1)}
    if qc_params.get("pos_masks"):
        del plans["resident"]
    if schedule != "layered":
        del plans["streamed"]
    for kernel, plan in plans.items():
        try:
            plan()
        except (ValueError, NotImplementedError):
            continue
        return kernel
    return "torch"


def qc_bp_decode_device(llr, qc_params: dict, decoder_algorithm: str,
                        n_iters: int, backend: str = "auto",
                        schedule: str = "flooding",
                        msa_scale: float = 1.0, msa_offset: float = 0.0,
                        msg_io: str = "auto", device="cuda"):
    """Batched QC-LDPC BP decode: ``[..., n]`` LLRs (positive means bit
    0) -> (dec int8, posterior LLRs), on ``device``.

    Hard word by signbit, posterior LLRs, converged frames frozen.
    ``backend``: ``'resident'`` runs every iteration in shared memory
    (K4); ``'streamed'`` keeps only the totals there and streams each
    check row's messages from device memory (K5, layered only);
    ``'torch'`` the plain PyTorch core; ``'auto'`` picks by
    :func:`select_backend`.  On a CPU tensor the two kernel backends run
    their kernels' plain PyTorch versions.
    ``schedule``: ``'flooding'`` (the reference BP) or ``'layered'``
    (totals updated after every check block row).
    ``msa_scale``/``msa_offset``: normalised/offset min-sum magnitude
    ``max(scale*min - offset, 0)``; (1, 0) is plain MSA.  MSA only.
    ``msg_io``: ``'bf16'`` stores the streamed kernel's messages in
    bfloat16; ``'auto'`` is ``'f32'``.
    """
    if decoder_algorithm not in ("SPA", "MSA"):
        raise NameError(
            'Please input a valid decoder_algorithm string '
            '(meanning "SPA" or "MSA").'
        )
    if schedule not in ("flooding", "layered"):
        raise ValueError('schedule must be "flooding" or "layered"')
    if (msa_scale, msa_offset) != (1.0, 0.0) and decoder_algorithm != "MSA":
        raise ValueError("msa_scale/msa_offset apply to MSA only")
    if msg_io not in ("auto", "f32", "bf16"):
        raise ValueError("msg_io must be 'auto', 'f32', or 'bf16'")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if msg_io == "bf16" and backend not in ("streamed", "auto"):
        raise ValueError(
            "msg_io='bf16' applies to the streamed kernel only "
            "(backend='streamed'); the other paths keep messages in f32")
    Mb, Nb = qc_params["Mb"], qc_params["Nb"]
    Z, K = qc_params["Z"], qc_params["K"]
    x = on_device(llr, device).to(torch.float32)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None]
    lead = x.shape[:-1]
    if backend == "auto":
        backend = select_backend(qc_params, schedule)
    if msg_io == "bf16" and backend != "streamed":
        raise ValueError(
            f"msg_io='bf16' requested but the backend resolved to "
            f"{backend!r}; only 'streamed' stores messages in device memory")
    if backend in ("resident", "streamed"):
        meta = (Z, Nb, qc_rows(qc_params))
        xf = torch.clamp(x.reshape(-1, Nb * Z), -_llr_max,
                         _llr_max).contiguous()
        if backend == "streamed":
            if schedule != "layered":
                raise ValueError(
                    "the streamed kernel is layered-only; use "
                    "schedule='layered' or backend='torch'")
            dec, out = qc_bp_streamed(
                xf, decoder_algorithm, int(n_iters), meta,
                msa_scale=float(msa_scale), msa_offset=float(msa_offset),
                pos_masks=_pos_masks(qc_params),
                msg_io="f32" if msg_io == "auto" else msg_io)
        else:
            if qc_params.get("pos_masks"):
                raise NotImplementedError(
                    "per-position edge masks need backend='streamed' or "
                    "'torch'")
            dec, out = qc_bp_resident(
                xf, decoder_algorithm, int(n_iters), meta,
                schedule=schedule, msa_scale=float(msa_scale),
                msa_offset=float(msa_offset))
    else:
        bj = np.asarray(qc_params["block_j"])
        meta = (Mb, Nb, Z, K, tuple(int(v) for v in bj.reshape(-1)),
                tuple(int(v) % Z
                      for v in np.asarray(qc_params["block_s"]).reshape(-1)))
        pos_mask = None
        if qc_params.get("pos_masks"):
            # params with masks keep valid slots contiguous from k=0, so
            # the (i, k) coordinates match every backend
            pm = np.ones((Mb, Z, K), bool)
            for (i, k, excluded) in qc_params["pos_masks"]:
                pm[i, list(excluded), k] = False
            pos_mask = pm
        xc = torch.clamp(x.reshape(-1, Nb, Z), -_llr_max, _llr_max)
        dec, out = _qc_bp_core(xc, meta, decoder_algorithm, int(n_iters),
                               msa_scale=float(msa_scale),
                               msa_offset=float(msa_offset),
                               schedule=schedule, pos_mask=pos_mask)
    dec = dec.reshape(lead + (Nb * Z,))
    out = out.reshape(lead + (Nb * Z,))
    if squeeze:
        return dec[0], out[0]
    return dec, out


def _pos_masks(qc_params: dict) -> tuple:
    """``pos_masks`` as a hashable tuple of ``(i, k, (positions...))``."""
    return tuple((int(i), int(k), tuple(int(p) for p in excluded))
                 for (i, k, excluded) in qc_params.get("pos_masks", ()))
