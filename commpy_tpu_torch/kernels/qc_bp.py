"""QC-LDPC belief propagation: the resident (K4) and streamed (K5) kernels.

``qc_bp_resident`` replaces ``commpy_tpu/kernels/qc_bp.py:qc_bp_pallas``
and ``qc_bp_streamed`` replaces ``qc_bp_pallas_streamed``.  On a CUDA
tensor each wrapper launches its hand-written kernel
(``csrc/qc_bp.cu``, built at first use) on the current stream, or raises;
on a CPU tensor it runs the plain PyTorch version beside it, which has
the same inputs, outputs and order of float operations and is what the
kernel is held against on the card.

The TPU kernels kept a 128-frame lane chunk in VMEM and rolled [Z, 128]
tiles along sublanes.  Here one CUDA block decodes one frame:

* K4 keeps the frame's channel LLRs, totals and every check-to-variable
  message (``nnz * Z`` float32) in dynamic shared memory, which holds
  every 802.11n code and WiMAX 1440 (at most ~44 KB a frame);
* K5 keeps only the totals there (64.8 KB at n = 16200) and streams each
  check block row's messages from a frame-major store in device memory
  (float32 or bfloat16), for the DVB-S2 and NR BG1 class codes.

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

from ..utils.device import device_constant
from . import _build

__all__ = ["qc_bp_resident", "qc_bp_resident_plain", "qc_bp_streamed",
           "qc_bp_streamed_plain", "resident_smem_bytes",
           "streamed_smem_bytes", "sign_keep_zero", "SMEM_LIMIT",
           "MAX_ROW_BLOCKS", "LLR_MAX"]

SMEM_LIMIT = 232_448  # dynamic shared memory one H100 block may opt into
MAX_ROW_BLOCKS = 32  # widest check block row the CUDA kernels hold
MAX_Z = 1024  # the layered sweep gives each circulant position a thread
LLR_MAX = 500.0  # reference ldpc.py:11 clipping
_BIG = 3e38  # empty leave-one-out minimum (the Pallas kernels' constant)
_MASKED_V2C = 1e30  # v2c of a masked edge position: neutral in SPA and MSA


def resident_smem_bytes(n: int, Z: int, nnz: int) -> int:
    """Shared memory of one K4 block: the frame's messages (``nnz * Z``
    float32), channel LLRs and totals (n float32 each)."""
    return 4 * nnz * Z + 8 * n


def streamed_smem_bytes(n: int) -> int:
    """Shared memory of one K5 block: the frame's totals."""
    return 4 * n


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
    None) 0 where ``pos_masks`` removes an edge position.
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
    return {"Z": Z, "Nb": Nb, "Mb": Mb, "E": E, "kmax": kmax, "ej": ej,
            "es": es, "row_start": row_start, "col_start": col_start,
            "col_edges": col_edges, "vidx": vidx, "inv": inv,
            "inv_ok": inv_ok, "row_edges": row_edges, "slot": slot,
            "keep": keep}


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


def _flooding_plain(llr, g, algorithm, n_iters, msa_scale, msa_offset):
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
                   bf16=False):
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
    outputs): returns (dec ``[B, n]`` int8, posterior ``[B, n]``)."""
    _check(llr, algorithm, meta, n_iters)
    if schedule not in ("flooding", "layered"):
        raise ValueError('schedule must be "flooding" or "layered"')
    g = _graph(meta)
    if schedule == "layered":
        return _layered_plain(llr, g, algorithm, n_iters, msa_scale,
                              msa_offset)
    return _flooding_plain(llr, g, algorithm, n_iters, msa_scale, msa_offset)


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
    graph = [p, p, p, p, p, p, i, i, i, i]
    lib.qc_bp_resident_launch.argtypes = [p, p, p, *graph, i, i, i, i, f, f,
                                          p]
    lib.qc_bp_resident_launch.restype = i
    lib.qc_bp_streamed_launch.argtypes = [p, p, p, p, *graph, i, i, i, i, f,
                                          f, p]
    lib.qc_bp_streamed_launch.restype = i
    return lib


def _graph_args(g, dev, keep=False):
    """Pointers and sizes of the graph tables on ``dev`` (int32)."""
    tabs = [_on(g, name, dev, np.int32)
            for name in ("ej", "es", "row_start", "col_start", "col_edges")]
    k = _on(g, "keep", dev) if (keep and g["keep"] is not None) else None
    ptrs = [t.data_ptr() for t in tabs] + [None if k is None
                                           else k.data_ptr()]
    return ptrs + [g["Z"], g["Nb"], g["Mb"], g["E"]]


def _check_cuda(llr, g, name):
    if llr.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {llr.device}")
    if g["kmax"] > MAX_ROW_BLOCKS or g["Z"] > MAX_Z:
        raise NotImplementedError(
            f"the CUDA {name} kernel takes check block rows of at most "
            f"{MAX_ROW_BLOCKS} blocks and Z <= {MAX_Z} (got "
            f"{g['kmax']} blocks, Z={g['Z']})")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")


def qc_bp_resident(llr: torch.Tensor, algorithm: str, n_iters: int, meta,
                   schedule: str = "flooding", msa_scale: float = 1.0,
                   msa_offset: float = 0.0):
    """Resident QC BP (K4): returns (dec ``[B, n]`` int8, posterior
    ``[B, n]`` float32).  CUDA tensors launch the kernel; CPU tensors run
    :func:`qc_bp_resident_plain`.  Raises ``ValueError`` for a code whose
    messages, LLRs and totals exceed :data:`SMEM_LIMIT`."""
    _check(llr, algorithm, meta, n_iters)
    if schedule not in ("flooding", "layered"):
        raise ValueError('schedule must be "flooding" or "layered"')
    g = _graph(meta)
    need = resident_smem_bytes(g["Nb"] * g["Z"], g["Z"], g["E"])
    if need > SMEM_LIMIT:
        raise ValueError(
            f"QC code too large for the resident kernel ({need} bytes of "
            f"shared memory per frame, {SMEM_LIMIT} available); use "
            f"backend='streamed' (layered) or 'torch'")
    if llr.device.type == "cpu":
        return qc_bp_resident_plain(llr, algorithm, n_iters, meta, schedule,
                                    msa_scale, msa_offset)
    _check_cuda(llr, g, "qc_bp_resident")
    B, n = llr.shape
    dec = torch.empty((B, n), dtype=torch.int8, device=llr.device)
    out = torch.empty((B, n), dtype=torch.float32, device=llr.device)
    if B:
        with torch.cuda.device(llr.device):
            rc = _lib().qc_bp_resident_launch(
                llr.data_ptr(), dec.data_ptr(), out.data_ptr(),
                *_graph_args(g, llr.device), B, int(n_iters),
                int(algorithm == "SPA"), int(schedule == "layered"),
                float(msa_scale), float(msa_offset),
                torch.cuda.current_stream(llr.device).cuda_stream)
        if rc:
            raise RuntimeError(f"qc_bp_resident kernel launch failed: CUDA "
                               f"error {rc}")
        qc_bp_resident.launches += 1
    return dec, out


qc_bp_resident.launches = 0


def qc_bp_streamed(llr: torch.Tensor, algorithm: str, n_iters: int, meta,
                   msa_scale: float = 1.0, msa_offset: float = 0.0,
                   pos_masks=(), msg_io: str = "f32"):
    """Streamed layered QC BP (K5): returns (dec ``[B, n]`` int8,
    posterior ``[B, n]`` float32).  CUDA tensors launch the kernel, with
    a ``[B, nnz*Z]`` message store (float32, or bfloat16 for
    ``msg_io='bf16'``) from ``torch.empty``; CPU tensors run
    :func:`qc_bp_streamed_plain`.  Raises ``ValueError`` when even the
    totals exceed :data:`SMEM_LIMIT`."""
    _check(llr, algorithm, meta, n_iters)
    if msg_io not in ("f32", "bf16"):
        raise ValueError('msg_io must be "f32" or "bf16"')
    g = _graph(meta, tuple(pos_masks))
    need = streamed_smem_bytes(g["Nb"] * g["Z"])
    if need > SMEM_LIMIT:
        raise ValueError(
            f"QC code too large even for the streamed kernel ({need} bytes "
            f"of totals per frame, {SMEM_LIMIT} available); use "
            f"backend='torch'")
    if llr.device.type == "cpu":
        return qc_bp_streamed_plain(llr, algorithm, n_iters, meta, msa_scale,
                                    msa_offset, pos_masks, msg_io)
    _check_cuda(llr, g, "qc_bp_streamed")
    B, n = llr.shape
    dec = torch.empty((B, n), dtype=torch.int8, device=llr.device)
    out = torch.empty((B, n), dtype=torch.float32, device=llr.device)
    store = torch.empty((B, g["E"] * g["Z"]), device=llr.device,
                        dtype=torch.bfloat16 if msg_io == "bf16"
                        else torch.float32)
    if B:
        with torch.cuda.device(llr.device):
            rc = _lib().qc_bp_streamed_launch(
                llr.data_ptr(), dec.data_ptr(), out.data_ptr(),
                store.data_ptr(), *_graph_args(g, llr.device, keep=True), B,
                int(n_iters), int(algorithm == "SPA"),
                int(msg_io == "bf16"), float(msa_scale), float(msa_offset),
                torch.cuda.current_stream(llr.device).cuda_stream)
        if rc:
            raise RuntimeError(f"qc_bp_streamed kernel launch failed: CUDA "
                               f"error {rc}")
        qc_bp_streamed.launches += 1
    return dec, out


qc_bp_streamed.launches = 0
