"""5G-NR-style QC-LDPC base graphs (BG1/BG2) with rate matching.

Counterpart of ``commpy_tpu/ops/nrldpc.py``: base graphs with 3GPP TS
38.212's exact structure (BG1 ``46 x 68``, kb = 22; BG2 ``42 x 52``,
kb = 10; a 4-row high-density core with a block lower-bidiagonal core
parity, single-parity-check extension rows with degree-1 identity
columns, the first two block columns punctured), lifting sizes
``Z = a * 2^j`` (``a in {2,3,5,7,9,11,13,15}``, ``Z <= 384``) and
circular-buffer rate matching.  The shift values are synthetic and
girth-aware, on the standard's graph shape (the published tables are not
bundled; :func:`parse_nr_base_graph` and :func:`validate_nr_base_graph`
ingest them).  The returned params are ordinary
:func:`~commpy_tpu_torch.ops.qcldpc.qc_code_params` dicts, decoded by
:func:`~commpy_tpu_torch.ops.qcldpc.qc_bp_decode_device`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.device import on_device
from .qcldpc import qc_code_params

__all__ = [
    "NR_LIFTING_SETS", "nr_lifting_sizes", "nr_select_bg",
    "nr_base_graph", "nr_code_params", "nr_encode_device",
    "nr_rate_match", "nr_rate_recover",
    "parse_nr_base_graph", "validate_nr_base_graph",
]

# The eight standard lifting sets: Z = a * 2^j, Z <= 384 (38.212 §5.3.2)
NR_LIFTING_SETS = {
    a: tuple(a * (1 << j) for j in range(8) if a * (1 << j) <= 384)
    for a in (2, 3, 5, 7, 9, 11, 13, 15)
}

_BG_SHAPE = {1: (46, 68, 22), 2: (42, 52, 10)}  # (Mb, Nb, kb)


def nr_lifting_sizes():
    """All 51 valid lifting sizes, ascending."""
    return tuple(sorted({z for zs in NR_LIFTING_SETS.values()
                         for z in zs}))


def nr_select_bg(K: int, rate: float) -> int:
    """Base-graph selection rule (38.212 §7.2.2): BG2 for small blocks
    or low rates, BG1 otherwise."""
    if K <= 292 or (K <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


@functools.lru_cache(maxsize=32)
def nr_base_graph(bg: int = 1, Z: int = 384, seed: int = 0) -> tuple:
    """Synthetic-NR-style base matrix ``[Mb, Nb]`` (tuple-of-tuples,
    hashable) for base graph ``bg`` at lifting size ``Z``.

    Construction (structure per 38.212, shifts synthetic — see module
    docstring): dense 4-row core over the kb info columns with a
    block lower-bidiagonal core-parity 4x4; extension rows of degree
    3..5 over {punctured cols (always-candidates), info cols, core
    parities} plus their own identity column; block-level 4-cycle
    rejection on every placed shift (girth >= 6; audit with qc_girth).
    """
    if bg not in _BG_SHAPE:
        raise ValueError("bg must be 1 or 2")
    if Z not in nr_lifting_sizes():
        raise ValueError(
            f"Z={Z} is not a standard lifting size a*2^j (a in "
            "{2,3,5,7,9,11,13,15}, Z <= 384)")
    Mb, Nb, kb = _BG_SHAPE[bg]
    rng = np.random.RandomState(seed + 101 * bg + Z)
    Bm = -np.ones((Mb, Nb), np.int32)

    # 4-cycle bookkeeping: columns sharing rows (r1 < r2) must not
    # repeat a shift difference mod Z
    seen: dict[tuple[int, int], set] = {}

    def place_col(rows, j, tries=400):
        rows = sorted(int(r) for r in rows)
        for _ in range(tries):
            shifts = rng.randint(0, Z, len(rows))
            pairs = [((rows[a], rows[b]),
                      int(shifts[a] - shifts[b]) % Z)
                     for a in range(len(rows))
                     for b in range(a + 1, len(rows))]
            if all(d not in seen.get(p, ()) for p, d in pairs):
                break
        for p, d in pairs:
            seen.setdefault(p, set()).add(d)
        for r, s in zip(rows, shifts):
            Bm[r, j] = int(s)

    # core parity columns kb..kb+3: block lower-bidiagonal, shift 0
    for i in range(4):
        Bm[i, kb + i] = 0
        if i > 0:
            Bm[i, kb + i - 1] = 0
        seen.setdefault((i - 1, i), set()).add(0)

    # punctured columns 0, 1: highest degree — all 4 core rows plus
    # ~60% of extension rows
    ext_rows = list(range(4, Mb))
    for j in (0, 1):
        n_ext = int(round(0.6 * len(ext_rows)))
        rows = [0, 1, 2, 3] + sorted(
            rng.choice(ext_rows, n_ext, replace=False).tolist())
        place_col(rows, j)

    # remaining info columns: all 4 core rows (dense core, like the
    # published BG1 core rows of weight ~19) — placed per column with
    # cycle rejection
    for j in range(2, kb):
        place_col([0, 1, 2, 3], j)

    # extension rows: identity parity + degree 2..4 over candidates
    for i in ext_rows:
        Bm[i, kb + i] = 0  # degree-1 identity column
        # row degree (excluding identity and any punctured-col entries
        # already placed): 2..4 picks from info + core-parity columns
        d = int(rng.randint(2, 5))
        cands = [j for j in range(2, kb + 4) if Bm[i, j] < 0]
        picks = rng.choice(len(cands), d, replace=False)
        for p in picks:
            j = cands[p]
            rows_j = [r for r in range(Mb) if Bm[r, j] >= 0] + [i]
            # place just this entry with pairwise rejection vs rows_j
            for _ in range(200):
                s = int(rng.randint(0, Z))
                ok = True
                for r in rows_j[:-1]:
                    p2 = (min(r, i), max(r, i))
                    dlt = (int(Bm[r, j]) - s) % Z
                    if dlt in seen.get(p2, ()):
                        ok = False
                        break
                if ok:
                    break
            for r in rows_j[:-1]:
                p2 = (min(r, i), max(r, i))
                seen.setdefault(p2, set()).add((int(Bm[r, j]) - s) % Z)
            Bm[i, j] = s
    return tuple(tuple(int(v) for v in row) for row in Bm)


@functools.lru_cache(maxsize=16)
def nr_code_params(bg: int = 1, Z: int = 384, seed: int = 0) -> dict:
    """QC params for the synthetic-NR-style code (structured encoder,
    no dense GF(2) solve).  n = Nb*Z, k = kb*Z; the first 2Z codeword
    bits are the puncture region (see :func:`nr_rate_match`)."""
    Bm = np.asarray(nr_base_graph(bg, Z, seed), np.int32)
    params = qc_code_params(Bm, Z, compute_encoder=False)
    params["parity_structure"] = "nr_triangular"
    params["bg"] = bg
    params["provenance"] = "synthetic-nr-style"
    return params


def nr_encode_device(message_bits, params: dict, device="cuda"):
    """Systematic encode ``[..., kb*Z] -> [..., Nb*Z]`` int8 on ``device``,
    structured: core parities by a 4-step cumulative XOR (block
    bidiagonal), extension parities by one substitution each; exact in
    float32 (sums << 2^24)."""
    Bm = np.asarray(params["base_matrix"])
    Mb, Nb, Z = params["Mb"], params["Nb"], params["Z"]
    kb = Nb - Mb
    m = on_device(message_bits, device)
    mB = m.reshape(m.shape[:-1] + (kb, Z)).to(torch.float32)

    def row_syndrome(i, cols, blocks):
        acc = torch.zeros(m.shape[:-1] + (Z,), dtype=torch.float32,
                          device=m.device)
        for j in cols:
            s = int(Bm[i, j])
            if s >= 0:
                acc = acc + torch.roll(blocks[j], -s, dims=-1)
        return acc

    info = {j: mB[..., j, :] for j in range(kb)}
    # core: p_i = s_i + p_{i-1}
    par = {}
    prev = None
    for i in range(4):
        s_i = row_syndrome(i, range(kb), info)
        p = s_i if prev is None else s_i + prev
        p = torch.remainder(p, 2.0)
        par[kb + i] = p
        prev = p
    # extensions: p_i = info syndrome + core-parity terms
    full = dict(info)
    full.update(par)
    for i in range(4, Mb):
        par[kb + i] = torch.remainder(row_syndrome(i, range(kb + 4), full),
                                      2.0)
    parity = torch.stack([par[kb + i] for i in range(Mb)], dim=-2)
    parity = parity.reshape(m.shape[:-1] + (Mb * Z,))
    return torch.cat([m.to(torch.int8), parity.to(torch.int8)], dim=-1)


def nr_rate_match(params: dict, codeword, E: int, device="cuda"):
    """Circular-buffer rate matching: transmit ``E`` bits starting after
    the 2Z puncture region, wrapping (repetition) if needed.
    codeword ``[..., n]`` -> ``[..., E]``."""
    Z, n = params["Z"], params["n_vnodes"]
    cw = on_device(codeword, device)
    buf = cw[..., 2 * Z:]
    L = n - 2 * Z
    idx = torch.arange(int(E), device=cw.device) % L
    return buf[..., idx]


def nr_rate_recover(params: dict, llr_e, E: int, device="cuda"):
    """Invert :func:`nr_rate_match` on LLRs: punctured positions get 0,
    repeated positions accumulate (a fold over the buffer's rounds).
    ``[..., E] -> [..., n]``."""
    Z, n = params["Z"], params["n_vnodes"]
    L = n - 2 * Z
    llr_e = on_device(llr_e, device).to(torch.float32)
    if int(E) != llr_e.shape[-1]:
        raise ValueError(f"E={E} != llr_e trailing dim {llr_e.shape[-1]}")
    E = int(E)
    buf = torch.zeros(llr_e.shape[:-1] + (L,), dtype=torch.float32,
                      device=llr_e.device)
    for r in range(-(-E // L)):
        part = llr_e[..., r * L:min((r + 1) * L, E)]
        short = L - part.shape[-1]
        if short:
            part = torch.cat([part, torch.zeros(
                part.shape[:-1] + (short,), dtype=torch.float32,
                device=llr_e.device)], dim=-1)
        buf = buf + part
    zeros = torch.zeros(llr_e.shape[:-1] + (2 * Z,), dtype=torch.float32,
                        device=llr_e.device)
    return torch.cat([zeros, buf], dim=-1)


# --------------------------------------------------------------------------
# Real-table ingestion (paste-and-validate, like dvbs2.parse_address_table)
# --------------------------------------------------------------------------

def parse_nr_base_graph(text: str) -> np.ndarray:
    """Parse a base-graph shift table from ``row col shift`` triples.

    One entry per line (blank lines and ``#`` comments ignored) — the
    common export format of the published 38.212 tables after selecting
    a lifting set and applying ``shift mod Z``.  Returns ``[Mb, Nb]``
    int32 with -1 for absent blocks (shape inferred from the maximum
    indices; validate with :func:`validate_nr_base_graph`).
    """
    entries = []
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line:
            continue
        parts = line.replace(",", " ").split()
        if len(parts) != 3:
            raise ValueError(f"expected 'row col shift', got {line!r}")
        entries.append(tuple(int(p) for p in parts))
    if not entries:
        raise ValueError("no entries")
    Mb = max(e[0] for e in entries) + 1
    Nb = max(e[1] for e in entries) + 1
    Bm = -np.ones((Mb, Nb), np.int32)
    for r, c, s in entries:
        if Bm[r, c] >= 0:
            raise ValueError(f"duplicate entry ({r}, {c})")
        Bm[r, c] = s
    return Bm


def validate_nr_base_graph(Bm, bg: int, Z: int) -> None:
    """Structural invariants of an NR base graph (raises on failure):
    shape, lifting-size membership, shift range, degree-1 identity
    extension columns, invertible core-parity 4x4, punctured-column
    degree dominance."""
    Bm = np.asarray(Bm)
    Mb, Nb, kb = _BG_SHAPE[bg]
    if Bm.shape != (Mb, Nb):
        raise ValueError(f"BG{bg} must be [{Mb}, {Nb}], got {Bm.shape}")
    if Z not in nr_lifting_sizes():
        raise ValueError(f"Z={Z} is not a standard lifting size")
    if Bm.max() >= Z:
        raise ValueError("shift >= Z (reduce the table mod Z first)")
    for i in range(4, Mb):
        col = kb + i
        rows = np.flatnonzero(Bm[:, col] >= 0)
        if not np.array_equal(rows, [i]):
            raise ValueError(
                f"extension parity column {col} must be degree-1 "
                f"identity owned by row {i} (has rows {rows})")
        if Bm[i, col] != 0:
            raise ValueError(f"extension identity at row {i} must have "
                             "shift 0")
    core = Bm[:4, kb:kb + 4]
    if np.all(core < 0) or np.any(np.diag(core) < 0):
        raise ValueError("core parity 4x4 must have a full diagonal")
    deg = (Bm >= 0).sum(axis=0)
    if not (deg[0] >= deg[2:kb].max() and deg[1] >= deg[2:kb].max()):
        raise ValueError(
            "punctured columns 0,1 must carry the highest variable "
            "degree (they are never transmitted)")
