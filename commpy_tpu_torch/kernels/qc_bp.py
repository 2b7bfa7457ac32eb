"""QC-LDPC belief propagation: the resident (K4) and streamed (K5) kernels.

``qc_bp_resident`` replaces ``commpy_tpu/kernels/qc_bp.py:qc_bp_pallas``
and ``qc_bp_streamed`` replaces ``qc_bp_pallas_streamed``.  On a CUDA
tensor each wrapper launches its hand-written kernel
(``csrc/qc_bp.cu``, built at first use) on the current stream, or raises;
on a CPU tensor it runs the plain PyTorch version beside it, which has
the same inputs, outputs and order of float operations and is what the
kernel is held against on the card.

The TPU kernels kept a 128-frame lane chunk in VMEM and rolled [Z, 128]
tiles along sublanes.  Here CUDA blocks decode frames:

* K4 keeps a frame's totals and every check-to-variable message
  (``nnz * Z`` float32) in dynamic shared memory, which holds every
  802.11n code and WiMAX 1440 (at most ~44 KB a frame), with the graph's
  packed tables beside them, one frame a block.  Its launch plan
  (:func:`resident_plan`, a pure function of the code's sizes and the
  schedule) gives a thread per check (flooding) or per circulant
  position (layered), looping past the block's threads; the flooding
  syndrome is folded into the next sweep's check phase;
* K5, for the DVB-S2 and NR class codes, keeps the totals there (64.8 KB
  at n = 16200) and the messages in a store in device memory (float32 or
  bfloat16).  Its launch plan (:func:`streamed_plan`, a pure function of
  the code's sizes, the batch and the store type) runs a persistent grid
  of as many blocks as the SMs hold at once (two a SM at the DVB-S2-class
  code, whose float32 stores then pass the 50 MB L2), each block decoding
  frames in turn with a store slice of its own.  While a check block row computes, ``cp.async``
  brings the next row's messages into a two-slot ring in shared memory;
  the row's messages stay in registers (a compile-time row bound of 8, 16
  or 32 blocks), and a row with no repeated column needs one barrier.

The base graph is passed as small int tables, so nothing is compiled per
code.  Both loop until the frame's syndrome passes or ``n_iters``
sweeps; the TPU kernels latched each lane's outputs at its convergence
and kept the chunk going, which gives the same outputs as stopping.

Semantics, shared with the plain versions:

* flooding totals fold from the channel LLR, ``((llr + c1) + c2) ...``
  over each column's blocks in row-major order (the Pallas order; the
  plain core of ``ops/qcldpc.py`` keeps the XLA order);
* the layered sweep computes a row's v2c messages from the totals as
  they stand, runs the check update, then applies the row's total
  updates one block after another (a column may appear twice in a row);
* MSA: ``(pre_s * suf_s) * max(scale * min - offset, 0)`` with
  ``sign(0) = 0`` keeping the zero's sign; SPA: ``log1p(p) - log1p(-p)``
  of the clipped leave-one-out tanh product, clipped to +-500;
* K5: masked edge positions (``pos_masks``) read v2c = 1e30 and store a
  zero message; with ``msg_io='bf16'`` each new message is rounded to
  bfloat16 before the totals are updated, so totals and store agree;
* a converged frame is never touched again.  The Pallas streamed kernel
  and the XLA layered core keep sweeping frozen lanes while others are
  active, adding +0.0 deltas that turn a -0.0 total into +0.0; there the
  TPU result depended on the 128-lane chunk.  The port is per frame, so
  its decisions are the XLA core's latched ones.

Layouts: llr ``[B, n]`` float32 (clipped by the caller), n = Nb * Z;
dec ``[B, n]`` int8; posterior ``[B, n]`` float32; meta = ``(Z, Nb,
rows)`` with ``rows = (((j, s), ...), ...)`` per check block row, as the
Pallas kernels take it.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils import profiling
from ..utils.device import device_constant
from . import (H100_SMS, SM_BLOCKS, SM_SMEM, SMEM_LIMIT, SMEM_PER_BLOCK,
               _build, sm_count)

__all__ = ["qc_bp_resident", "qc_bp_resident_plain", "qc_bp_streamed",
           "qc_bp_streamed_plain", "resident_smem_bytes", "resident_plan",
           "streamed_smem_bytes", "streamed_plan", "sign_keep_zero",
           "SMEM_LIMIT", "MAX_ROW_BLOCKS", "LLR_MAX"]

MAX_ROW_BLOCKS = 32  # widest check block row the CUDA kernels hold
MAX_Z = 1024  # the layered sweep gives each circulant position a thread
MAX_Z_STREAMED = 512  # K5's block size bound (128 registers a thread)
STREAMED_KMAX = (8, 16, 32)  # K5's compile-time row bounds
# registers a thread of K5 takes at each row bound (the most of its f32
# and bf16 instantiations in the -Xptxas -v report for sm_90a)
STREAMED_REGS = {8: 72, 16: 128, 32: 128}
RESIDENT_KMAX = (8, 16, 32)  # K4's compile-time row bounds
SM_REGS = 65_536  # registers of one H100 SM
LLR_MAX = 500.0  # reference ldpc.py:11 clipping
_BIG = 3e38  # empty leave-one-out minimum (the Pallas kernels' constant)
_MASKED_V2C = 1e30  # v2c of a masked edge position: neutral in SPA and MSA


def resident_smem_bytes(n: int, Z: int, nnz: int) -> int:
    """Shared memory of one K4 block: the frame's messages (``nnz * Z``
    float32), channel LLRs and totals (n float32 each)."""
    return 4 * nnz * Z + 8 * n


def resident_max_threads(kmax_t: int, schedule: str) -> int:
    """Threads a K4 block may have (its ``__launch_bounds__``): 1024 for
    flooding at the row bounds 8 and 16 (64 registers a thread), else 512
    (128 registers: rows of up to 32 blocks, and the layered row's held
    values)."""
    return 512 if schedule == "layered" or kmax_t > 16 else 1024


def resident_plan(Z: int, Nb: int, Mb: int, E: int, kmax: int,
                  schedule: str, repeat: bool = False) -> dict:
    """K4's launch plan, a pure function of the code's sizes and the
    schedule (``repeat``: some check block row holds a column twice).

    A block decodes one frame (several frames a block measured slower,
    PERF.md).  Its threads (whole warps):
    one per check, Mb*Z, for flooding and one per circulant position, Z,
    for layered, at most the block's bound (:func:`resident_max_threads`);
    past it each thread loops (``loop``).  Shared memory: the frame's
    totals and messages, ``4 * (n + E*Z)`` bytes (the LLRs are read from
    device memory), and the packed tables.

    Returns kmax_t, threads, loop, frame_bytes, table_bytes and
    smem_bytes.  Raises ValueError where a row exceeds 32 blocks or the
    frame exceeds :data:`SMEM_LIMIT` (by :func:`resident_smem_bytes`, or
    with the tables), and NotImplementedError for Z past :data:`MAX_Z`
    or a layered code with a repeated column whose Z exceeds the block's
    threads.  The wrapper launches by it and
    ``ops/qcldpc.py:select_backend`` routes by it, so the two agree.
    """
    if schedule not in ("flooding", "layered"):
        raise ValueError('schedule must be "flooding" or "layered"')
    kmax_t = next((k for k in RESIDENT_KMAX if kmax <= k), None)
    if kmax_t is None:
        raise ValueError(f"check block rows of {kmax} blocks exceed "
                         f"{RESIDENT_KMAX[-1]}")
    if Z > MAX_Z:
        raise NotImplementedError(f"the CUDA qc_bp_resident kernel takes "
                                  f"Z <= {MAX_Z} (got Z={Z})")
    need = resident_smem_bytes(Nb * Z, Z, E)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"QC code too large for the resident kernel ({need} bytes of "
            f"shared memory per frame, {SMEM_LIMIT} available); use "
            f"backend='streamed' (layered) or 'torch'")
    work = Mb * Z if schedule == "flooding" else Z
    threads = min(-(-work // 32) * 32, resident_max_threads(kmax_t,
                                                            schedule))
    if schedule == "layered" and repeat and Z > threads:
        raise NotImplementedError(
            f"K4's layered sweep gives a row with a repeated column a thread "
            f"per position: Z={Z} exceeds its {threads} threads")
    frame = 4 * (Nb * Z + E * Z)
    tables = 4 * (2 * E + Mb + Nb)
    if frame + tables > SMEM_LIMIT:
        raise ValueError(
            f"QC code too large for the resident kernel ({frame + tables} "
            f"bytes of shared memory for one frame and the graph tables, "
            f"{SMEM_LIMIT} available); use backend='streamed' (layered) or "
            f"'torch'")
    return {"kmax_t": kmax_t, "threads": threads, "loop": work > threads,
            "frame_bytes": frame, "table_bytes": tables,
            "smem_bytes": frame + tables}


def _streamed_sizes(Z: int, msg_io: str):
    """(Zp, bytes per stored message): K5 strides a block's messages by
    Zp = Z rounded up to 8, so that every row is 16-byte aligned."""
    if msg_io not in ("f32", "bf16"):
        raise ValueError('msg_io must be "f32" or "bf16"')
    return -(-Z // 8) * 8, 2 if msg_io == "bf16" else 4


def streamed_smem_bytes(Z: int, Nb: int, kmax: int, E: int,
                        msg_io: str = "f32") -> int:
    """Shared memory of one K5 block: the frame's totals (n float32,
    padded to 4), the two-slot ring of a row's messages (``2 * kmax * Zp``
    in the store's type) and the edge table (E int32)."""
    Zp, tb = _streamed_sizes(Z, msg_io)
    n4 = -(-Nb * Z // 4) * 4
    return 4 * n4 + 2 * kmax * Zp * tb + 4 * E


def streamed_plan(Z: int, Nb: int, kmax: int, E: int, B: int,
                  msg_io: str = "f32", sms: int = H100_SMS) -> dict:
    """K5's launch plan, a pure function of the code's sizes, the batch
    and the store type.

    Frames per SM: as many blocks as the SM holds at once by its shared
    memory and its registers (:data:`STREAMED_REGS` a thread), at least
    1.  The grid is ``min(B, frames_per_sm * sms)`` blocks, each decoding
    frames b, b + grid, ... with a store slice of its own: a batch that
    is not a multiple of the grid leaves a tail of at most one frame a
    block.  The stores of the frames in flight may pass the L2: at the
    DVB-S2-class code two float32 frames a SM (66.5 MB of stores) ran
    faster than the one that keeps them in the 50 MB L2 (PERF.md).

    Returns Zp, kmax_t (the compile-time row bound), threads, smem_bytes,
    frames_per_sm, grid, store_bytes (of the frames in flight) and
    store_elems.  Raises ValueError when one frame's totals and ring
    exceed :data:`SMEM_LIMIT` or a row exceeds 32 blocks, and
    NotImplementedError for Z past :data:`MAX_Z_STREAMED`.  The wrapper
    launches by it and ``ops/qcldpc.py:select_backend`` routes by it.
    """
    if Z > MAX_Z_STREAMED:
        raise NotImplementedError(f"the CUDA qc_bp_streamed kernel takes "
                                  f"Z <= {MAX_Z_STREAMED} (got Z={Z})")
    Zp, tb = _streamed_sizes(Z, msg_io)
    smem = streamed_smem_bytes(Z, Nb, kmax, E, msg_io)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"QC code too large even for the streamed kernel ({smem} bytes "
            f"of totals and message ring per frame, {SMEM_LIMIT} "
            f"available); use backend='torch'")
    kmax_t = next((k for k in STREAMED_KMAX if kmax <= k), None)
    if kmax_t is None:
        raise ValueError(f"check block rows of {kmax} blocks exceed "
                         f"{STREAMED_KMAX[-1]}")
    threads = -(-Z // 32) * 32
    by_smem = SM_SMEM // (smem + SMEM_PER_BLOCK)
    by_regs = SM_REGS // (STREAMED_REGS[kmax_t] * threads)
    frames_per_sm = max(1, min(by_smem, by_regs, SM_BLOCKS))
    grid = max(1, min(B, frames_per_sm * sms))
    return {"Zp": Zp, "kmax_t": kmax_t, "threads": threads,
            "smem_bytes": smem, "frames_per_sm": frames_per_sm,
            "grid": grid, "store_bytes": grid * E * Zp * tb,
            "store_elems": grid * E * Zp}


@functools.lru_cache(maxsize=64)
def _graph(meta, pos_masks=()):
    """Host tables of the graph (NumPy), cached per code.

    Edges are the nonzero blocks in row-major order.  ``ej``/``es``
    their column and shift, ``row_start`` the first edge of each row,
    ``col_start``/``col_edges`` each column's edges in row-major order,
    ``vidx [E, Z]`` the variable each edge position reads
    (``ej*Z + (z + es) % Z``), ``inv [D, Nb, Z]`` and ``inv_ok [D, Nb]``
    the flat message index that the d-th block of each column adds to
    variable position z, ``row_edges [Mb, Kmax]`` (E pads), ``slot [E]``
    each edge's place in that padded layout, and ``keep [E, Z]`` (or
    None) 0 where ``pos_masks`` removes an edge position.  The kernels'
    packed int32 tables: ``edge5 [E]`` ``(ej*Z) << 11 | repeated << 10 |
    es`` and ``row5 [Mb]`` ``e0 | K << 16 | has_repeat << 31`` (K4, K5),
    ``keep5 [Mb, Z]`` each check's keep bits (K5), ``col5 [Nb]`` ``q0 | D
    << 16`` and ``cedge5 [E]`` ``(e*Z) << 11 | es`` of each column's D
    edges in row-major order from q0 (K4).
    """
    Z, Nb, rows = meta
    Mb = len(rows)
    ej = np.array([j for r in rows for (j, _) in r], np.int64)
    es = np.array([s % Z for r in rows for (_, s) in r], np.int64)
    E = len(ej)
    if E == 0 or any(not r for r in rows):
        raise ValueError("every check block row needs a nonzero block")
    if ej.min() < 0 or ej.max() >= Nb:
        raise ValueError(f"block columns must lie in [0, {Nb})")
    row_start = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    kmax = max(len(r) for r in rows)
    z = np.arange(Z)
    vidx = ej[:, None] * Z + (z[None, :] + es[:, None]) % Z
    col_lists = [[] for _ in range(Nb)]
    for e in range(E):
        col_lists[ej[e]].append(e)
    if any(not c for c in col_lists):
        raise ValueError("every block column needs a nonzero block")
    col_start = np.concatenate([[0], np.cumsum([len(c) for c in col_lists])])
    col_edges = np.array([e for c in col_lists for e in c], np.int64)
    D = max(len(c) for c in col_lists)
    inv = np.zeros((D, Nb, Z), np.int64)
    inv_ok = np.zeros((D, Nb), bool)
    for j, c in enumerate(col_lists):
        for d, e in enumerate(c):
            inv[d, j] = e * Z + (z - es[e]) % Z
            inv_ok[d, j] = True
    row_edges = np.full((Mb, kmax), E, np.int64)
    slot = np.zeros(E, np.int64)
    for i in range(Mb):
        for k in range(row_start[i + 1] - row_start[i]):
            row_edges[i, k] = row_start[i] + k
            slot[row_start[i] + k] = i * kmax + k
    keep = None
    if pos_masks:
        keep = np.ones((E, Z), np.uint8)
        for (i, k, excluded) in pos_masks:
            if not (0 <= i < Mb and 0 <= k < len(rows[i])):
                raise ValueError(f"pos_masks entry ({i}, {k}) names no block")
            keep[row_start[i] + k, list(excluded)] = 0
    rep = np.zeros(E, np.int64)
    row5 = np.zeros(Mb, np.int64)
    keep5 = None if keep is None else np.zeros((Mb, Z), np.uint32)
    for i in range(Mb):
        e0, e1 = row_start[i], row_start[i + 1]
        for e in range(e0, e1):
            rep[e] = ej[e] in ej[e0:e]
            if keep5 is not None:
                keep5[i] |= keep[e].astype(np.uint32) << np.uint32(e - e0)
        row5[i] = e0 | (e1 - e0) << 16 | int(rep[e0:e1].any()) << 31
    edge5 = (ej * Z) << 11 | rep << 10 | es
    col5 = col_start[:-1] | np.diff(col_start) << 16
    cedge5 = (col_edges * Z) << 11 | es[col_edges]
    return {"Z": Z, "Nb": Nb, "Mb": Mb, "E": E, "kmax": kmax, "ej": ej,
            "es": es, "row_start": row_start, "col_start": col_start,
            "col_edges": col_edges, "vidx": vidx, "inv": inv,
            "inv_ok": inv_ok, "row_edges": row_edges, "slot": slot,
            "keep": keep, "edge5": edge5.astype(np.int32),
            "col5": col5.astype(np.int32), "cedge5": cedge5.astype(np.int32),
            "row5": row5.astype(np.uint32).view(np.int32),
            "keep5": None if keep5 is None else keep5.view(np.int32)}


def _on(g, name, dev, dtype=None):
    a = g[name]
    if dtype is not None:
        a = a.astype(dtype)
    return device_constant(a, dev)


def _check(llr, algorithm, meta, n_iters):
    if algorithm not in ("SPA", "MSA"):
        raise ValueError(f"algorithm must be 'SPA' or 'MSA', got "
                         f"{algorithm!r}")
    Z, Nb, _ = meta
    if llr.dtype != torch.float32 or llr.ndim != 2 or llr.shape[1] != Nb * Z:
        raise ValueError(f"llr must be float32 [B, {Nb * Z}], got "
                         f"{llr.dtype} {tuple(llr.shape)}")
    if int(n_iters) < 0:
        raise ValueError(f"n_iters must be >= 0 (got {n_iters})")


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def sign_keep_zero(x):
    """``jnp.sign``: -1, +1, and the zero itself (+0.0 or -0.0), where
    ``torch.sign(-0.0)`` is +0.0.  The MSA sign product keeps a zero
    message's sign through it."""
    one = torch.ones((), dtype=x.dtype, device=x.device)
    return torch.where(x > 0, one, torch.where(x < 0, -one, x))


def _cn_update(v2c, algorithm, msa_scale, msa_offset):
    """Leave-one-out check update over axis -2 of ``[..., K, Z]``, in the
    Pallas kernels' order of operations (``_make_cn_update``)."""
    K = v2c.shape[-2]
    v = [v2c[..., k, :] for k in range(K)]
    if algorithm == "SPA":
        t = [torch.tanh(x * 0.5) for x in v]
        suf = [None] * K
        acc = torch.ones_like(t[0])
        for k in range(K - 1, -1, -1):
            suf[k] = acc
            acc = acc * t[k]
        out = []
        acc = torch.ones_like(t[0])
        for k in range(K):
            prod = torch.clamp(acc * suf[k], -1.0, 1.0)
            acc = acc * t[k]
            msg = torch.log1p(prod) - torch.log1p(-prod)
            out.append(torch.clamp(msg, -LLR_MAX, LLR_MAX))
        return torch.stack(out, dim=-2)
    sg = [sign_keep_zero(x) for x in v]
    mg = [torch.abs(x) for x in v]
    suf_s, suf_m = [None] * K, [None] * K
    acc_s = torch.ones_like(sg[0])
    acc_m = torch.full_like(mg[0], _BIG)
    for k in range(K - 1, -1, -1):
        suf_s[k], suf_m[k] = acc_s, acc_m
        acc_s = acc_s * sg[k]
        acc_m = torch.minimum(acc_m, mg[k])
    out = []
    acc_s = torch.ones_like(sg[0])
    acc_m = torch.full_like(mg[0], _BIG)
    for k in range(K):
        mag = torch.clamp_min(
            msa_scale * torch.minimum(acc_m, suf_m[k]) - msa_offset, 0.0)
        out.append(acc_s * suf_s[k] * mag)
        acc_s = acc_s * sg[k]
        acc_m = torch.minimum(acc_m, mg[k])
    return torch.stack(out, dim=-2)


def _syndrome_bad(dec, g, dev):
    """[B] True where any check of the frame fails (dec [B, n] 0/1)."""
    B = dec.shape[0]
    d = dec.to(torch.int32)[:, _on(g, "vidx", dev)]  # [B, E, Z]
    if g["keep"] is not None:
        d = d * _on(g, "keep", dev).to(torch.int32)
    d = torch.cat([d, torch.zeros_like(d[:, :1])], dim=1)
    par = d[:, _on(g, "row_edges", dev)].sum(dim=2)  # [B, Mb, Z]
    return (par % 2 != 0).reshape(B, -1).any(dim=1)


def _flooding_totals(llr, c2v, g, dev):
    """``((llr + c1) + c2) ...`` over each column's blocks, row-major."""
    B = llr.shape[0]
    Nb, Z = g["Nb"], g["Z"]
    flat = c2v.reshape(B, -1)
    inv = _on(g, "inv", dev)
    inv_ok = _on(g, "inv_ok", dev)
    tot = llr.reshape(B, Nb, Z)
    for d in range(inv.shape[0]):
        tot = torch.where(inv_ok[d][:, None], tot + flat[:, inv[d]], tot)
    return tot.reshape(B, Nb * Z)


def _flooding_plain(llr, g, algorithm, n_iters, msa_scale, msa_offset,
                    sweeps=None):
    dev = llr.device
    B = llr.shape[0]
    E, Z = g["E"], g["Z"]
    vidx = _on(g, "vidx", dev)
    row_edges = _on(g, "row_edges", dev)
    slot = _on(g, "slot", dev)
    pad = torch.full((B, 1, Z), _BIG, dtype=torch.float32, device=dev)
    c2v = torch.zeros((B, E, Z), dtype=torch.float32, device=dev)
    out = llr.clone()
    dec = torch.signbit(llr)
    act = _syndrome_bad(dec, g, dev)
    for _ in range(int(n_iters)):
        if not bool(act.any()):
            break
        if sweeps is not None:
            sweeps += act.sum()
        tot = _flooding_totals(llr, c2v, g, dev)
        v2c = tot[:, vidx] - c2v  # [B, E, Z]
        # rows padded to Kmax slots with a neutral +3e38 (tanh -> 1, and
        # the empty minimum's own value), then back to edge order
        rows = torch.cat([v2c, pad], dim=1)[:, row_edges]  # [B, Mb, Kmax, Z]
        new = _cn_update(rows, algorithm, msa_scale, msa_offset)
        new = new.reshape(B, -1, Z)[:, slot]
        c2v = torch.where(act[:, None, None], new, c2v)
        tot2 = _flooding_totals(llr, c2v, g, dev)
        d = torch.signbit(tot2)
        out = torch.where(act[:, None], tot2, out)
        dec = torch.where(act[:, None], d, dec)
        act = act & _syndrome_bad(d, g, dev)
    return dec.to(torch.int8), out


def _layered_plain(llr, g, algorithm, n_iters, msa_scale, msa_offset,
                   bf16=False, sweeps=None):
    dev = llr.device
    B = llr.shape[0]
    E, Z = g["E"], g["Z"]
    vidx = _on(g, "vidx", dev)
    keep = None if g["keep"] is None else _on(g, "keep", dev).bool()
    rs = g["row_start"]
    tot = llr.clone()
    c2v = torch.zeros((B, E, Z), dtype=torch.float32, device=dev)
    act = _syndrome_bad(torch.signbit(tot), g, dev)
    for _ in range(int(n_iters)):
        if not bool(act.any()):
            break
        if sweeps is not None:
            sweeps += act.sum()
        a2, a3 = act[:, None], act[:, None, None]
        for i in range(g["Mb"]):
            e0, e1 = int(rs[i]), int(rs[i + 1])
            old = c2v[:, e0:e1]  # [B, K, Z]
            v2c = tot[:, vidx[e0:e1]] - old
            if keep is not None:
                v2c = torch.where(keep[e0:e1], v2c, _MASKED_V2C)
            new = _cn_update(v2c, algorithm, msa_scale, msa_offset)
            if keep is not None:
                new = new * keep[e0:e1].to(torch.float32)
            if bf16:
                new = new.to(torch.bfloat16).to(torch.float32)
            for k in range(e1 - e0):
                idx = vidx[e0 + k]
                cur = tot[:, idx]
                tot[:, idx] = torch.where(a2, cur + (new[:, k] - old[:, k]),
                                          cur)
            c2v[:, e0:e1] = torch.where(a3, new, old)
        act = act & _syndrome_bad(torch.signbit(tot), g, dev)
    return torch.signbit(tot).to(torch.int8), tot


def qc_bp_resident_plain(llr: torch.Tensor, algorithm: str, n_iters: int,
                         meta, schedule: str = "flooding",
                         msa_scale: float = 1.0, msa_offset: float = 0.0):
    """Plain PyTorch version of the resident kernel (same inputs and
    outputs): returns (dec ``[B, n]`` int8, posterior ``[B, n]``).  Counts
    its sweeps and frames as the kernel does (:func:`qc_bp_resident`)."""
    _check(llr, algorithm, meta, n_iters)
    if schedule not in ("flooding", "layered"):
        raise ValueError('schedule must be "flooding" or "layered"')
    g = _graph(meta)
    sweeps = _sweep_counter(llr.device) if profiling.recording() else None
    if sweeps is not None:
        qc_bp_resident.frames += llr.shape[0]
    if schedule == "layered":
        return _layered_plain(llr, g, algorithm, n_iters, msa_scale,
                              msa_offset, sweeps=sweeps)
    return _flooding_plain(llr, g, algorithm, n_iters, msa_scale, msa_offset,
                           sweeps=sweeps)


def qc_bp_streamed_plain(llr: torch.Tensor, algorithm: str, n_iters: int,
                         meta, msa_scale: float = 1.0,
                         msa_offset: float = 0.0, pos_masks=(),
                         msg_io: str = "f32"):
    """Plain PyTorch version of the streamed layered kernel (same inputs
    and outputs): returns (dec ``[B, n]`` int8, posterior ``[B, n]``)."""
    _check(llr, algorithm, meta, n_iters)
    if msg_io not in ("f32", "bf16"):
        raise ValueError('msg_io must be "f32" or "bf16"')
    g = _graph(meta, tuple(pos_masks))
    return _layered_plain(llr, g, algorithm, n_iters, msa_scale, msa_offset,
                          bf16=msg_io == "bf16")


# --------------------------------------------------------------------------
# CUDA wrappers
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("qc_bp")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.qc_bp_resident_launch.argtypes = [p, p, p, p, p, p, p, *[i] * 12,
                                          f, f, p, p]
    lib.qc_bp_resident_launch.restype = i
    lib.qc_bp_streamed_launch.argtypes = [p, p, p, p, p, p, p, *[i] * 14,
                                          f, f, p]
    lib.qc_bp_streamed_launch.restype = i
    return lib


def _check_cuda(llr, name):
    if llr.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {llr.device}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")


def _sweep_counter(dev) -> torch.Tensor:
    """``qc_bp_resident.sweeps`` as an int64 scalar on ``dev``, made (or
    moved) at the first counted launch there."""
    s = qc_bp_resident.sweeps
    if not (isinstance(s, torch.Tensor) and s.device == dev):
        s = qc_bp_resident.sweeps = torch.as_tensor(
            s, dtype=torch.int64).to(dev)
    return s


def qc_bp_resident(llr: torch.Tensor, algorithm: str, n_iters: int, meta,
                   schedule: str = "flooding", msa_scale: float = 1.0,
                   msa_offset: float = 0.0):
    """Resident QC BP (K4): returns (dec ``[B, n]`` int8, posterior
    ``[B, n]`` float32).  CUDA tensors launch the kernel; CPU tensors run
    :func:`qc_bp_resident_plain`.  On either device, raises for a code
    the kernel refuses (:func:`resident_plan`).

    Counters: ``qc_bp_resident.launches``, every launch; while a profiler
    records (:func:`~commpy_tpu_torch.utils.profiling.recording`), also
    ``qc_bp_resident.frames`` (a host int, the frames decoded) and
    ``qc_bp_resident.sweeps`` (an int64 scalar on the device, the sweeps
    that updated a frame's messages summed over the frames: 0 for a frame
    whose decisions already pass every check, else at most ``n_iters``).
    Reset them by assigning 0; reading ``sweeps`` waits for the device."""
    _check(llr, algorithm, meta, n_iters)
    if schedule not in ("flooding", "layered"):
        raise ValueError('schedule must be "flooding" or "layered"')
    g = _graph(meta)
    plan = resident_plan(g["Z"], g["Nb"], g["Mb"], g["E"], g["kmax"],
                         schedule, bool((g["row5"] < 0).any()))
    if llr.device.type == "cpu":
        return qc_bp_resident_plain(llr, algorithm, n_iters, meta, schedule,
                                    msa_scale, msa_offset)
    _check_cuda(llr, "qc_bp_resident")
    B, n = llr.shape
    dev = llr.device
    dec = torch.empty((B, n), dtype=torch.int8, device=dev)
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    if B:
        sweeps = _sweep_counter(dev) if profiling.recording() else None
        with torch.cuda.device(dev):
            rc = _lib().qc_bp_resident_launch(
                llr.data_ptr(), dec.data_ptr(), out.data_ptr(),
                *[_on(g, name, dev).data_ptr()
                  for name in ("edge5", "row5", "col5", "cedge5")],
                g["Z"], g["Nb"], g["Mb"], g["E"], g["kmax"], plan["kmax_t"],
                B, plan["threads"], plan["smem_bytes"], int(n_iters),
                int(algorithm == "SPA"), int(schedule == "layered"),
                float(msa_scale), float(msa_offset),
                None if sweeps is None else sweeps.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"qc_bp_resident kernel launch failed: CUDA "
                               f"error {rc}")
        qc_bp_resident.launches += 1
        if sweeps is not None:
            qc_bp_resident.frames += B
    return dec, out


qc_bp_resident.launches = 0
qc_bp_resident.sweeps = 0
qc_bp_resident.frames = 0


def qc_bp_streamed(llr: torch.Tensor, algorithm: str, n_iters: int, meta,
                   msa_scale: float = 1.0, msa_offset: float = 0.0,
                   pos_masks=(), msg_io: str = "f32"):
    """Streamed layered QC BP (K5): returns (dec ``[B, n]`` int8,
    posterior ``[B, n]`` float32).  CUDA tensors launch the kernel by
    :func:`streamed_plan`, with a message store (float32, or bfloat16 for
    ``msg_io='bf16'``) for the frames in flight from ``torch.empty``; CPU
    tensors run :func:`qc_bp_streamed_plain`.  On either device, raises
    for a code the kernel refuses (:func:`streamed_plan`)."""
    _check(llr, algorithm, meta, n_iters)
    g = _graph(meta, tuple(pos_masks))
    plan = streamed_plan(g["Z"], g["Nb"], g["kmax"], g["E"], llr.shape[0],
                         msg_io, sm_count(llr.device.index) if llr.is_cuda
                         else H100_SMS)
    if llr.device.type == "cpu":
        return qc_bp_streamed_plain(llr, algorithm, n_iters, meta, msa_scale,
                                    msa_offset, pos_masks, msg_io)
    _check_cuda(llr, "qc_bp_streamed")
    return _streamed_launch(llr, g, algorithm, n_iters, msa_scale,
                            msa_offset, msg_io, plan)


def _streamed_launch(llr, g, algorithm, n_iters, msa_scale, msa_offset,
                     msg_io, plan):
    """Launch K5 on ``llr`` (a checked CUDA tensor) by ``plan``."""
    B, n = llr.shape
    dev = llr.device
    dec = torch.empty((B, n), dtype=torch.int8, device=dev)
    out = torch.empty((B, n), dtype=torch.float32, device=dev)
    store = torch.empty(plan["store_elems"], device=dev,
                        dtype=torch.bfloat16 if msg_io == "bf16"
                        else torch.float32)
    if B:
        keep = None if g["keep5"] is None else _on(g, "keep5", dev)
        with torch.cuda.device(dev):
            rc = _lib().qc_bp_streamed_launch(
                llr.data_ptr(), dec.data_ptr(), out.data_ptr(),
                store.data_ptr(), _on(g, "edge5", dev).data_ptr(),
                _on(g, "row5", dev).data_ptr(),
                None if keep is None else keep.data_ptr(), g["Z"],
                plan["Zp"], g["Nb"], g["Mb"], g["E"], g["kmax"],
                plan["kmax_t"], B, plan["grid"], plan["threads"],
                plan["smem_bytes"], int(n_iters), int(algorithm == "SPA"),
                int(msg_io == "bf16"), float(msa_scale), float(msa_offset),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"qc_bp_streamed kernel launch failed: CUDA "
                               f"error {rc}")
        qc_bp_streamed.launches += 1
    return dec, out


qc_bp_streamed.launches = 0
