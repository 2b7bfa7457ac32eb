"""Viterbi ACS forward pass (K1) and sliding-window traceback (K2).

``acs_forward`` replaces ``commpy_tpu/kernels/viterbi_acs.py:
acs_forward_pallas`` and ``traceback`` replaces ``traceback_pallas``.  On
a CUDA tensor each wrapper launches its hand-written kernel
(``csrc/viterbi_acs.cu``, built at first use) on the current stream, or
raises; on a CPU tensor it runs the plain PyTorch version beside it,
which has the same inputs, outputs and packing and is what the kernel is
held against on the card.

The TPU kernels expressed the predecessor gather as a one-hot
permutation matmul and packed decisions with a powers-of-two matmul,
because gathers are slow on the TPU.  Here the predecessors are read by
index and decisions packed with warp ballots, and a loop over all T
steps takes the place of the TPU's sequential time-chunk grid and its
persistent path-metric scratch.  The ACS launch plan (:func:`acs_plan`, a
pure function of S, n and B) picks one of two layouts: for S <= 64 a
warp walks 64/S frames, a lane owning a butterfly (two states), with no
block barrier in the step loop; for S >= 128 a block of S threads walks
one frame, a thread a state.  Both kernels take binary-input,
shift-structured trellises only; ``ops/viterbi.py`` routes every other
trellis to its general path.

Layouts: r ``[B, T, n]`` f32; C ``[2, S, n]`` f32 with ``bm(j, s) =
r_t . C[j, s]``; hconst ``[2, S]`` f32 or None (the hard metric's
per-branch constant); dec ``[B, T, G]`` int32 with G = ceil(S/32), bit
``s % 32`` of word ``s // 32`` set iff state s took branch 1; best
``[B, T]`` int32; bits ``[B, T]`` int8.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["acs_forward", "traceback", "acs_forward_plain",
           "traceback_plain", "acs_plan", "MAX_STATES", "MAX_N"]

MAX_STATES = 1024  # the block layout: one thread per state
MAX_N = 8  # widest codeword the ACS kernel holds in registers
WARP_MAX_STATES = 64  # the warp layout: S/2 lanes a frame
UNREACHED = 3.0e37  # initial metric of every state but 0
_CHUNK = 32  # received steps staged in shared memory at a time
_WARPS_A_BLOCK = 4  # warps of a warp-layout block, shared memory allowing
_SMEM_DEFAULT = 48 * 1024  # shared memory a block gets without opting in


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("viterbi_acs")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.acs_forward_launch.argtypes = [p, p, p, p, p, *[i] * 9, p]
    lib.acs_forward_launch.restype = i
    lib.traceback_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.traceback_launch.restype = i
    return lib


def _words(S: int) -> int:
    return -(-S // 32)


def acs_plan(S: int, n: int, B: int) -> dict:
    """K1's launch plan, a pure function of the states, the codeword width
    and the batch.

    ``layout='warp'`` for S <= 64: a warp walks ``frames_per_warp`` =
    64/S frames, ``lanes_per_frame`` = S/2 lanes each (a lane owns a
    butterfly: states s and s + S/2), with a 32-step ring of its ballots
    (512 bytes) and its received words staged 32 steps at a time in two
    slots of ``[frames][32 n + 1]`` floats (rounded up to 16 bytes); up
    to four warps a block while that stays within the default 48 KB, else
    one.  ``layout='block'`` for S >= 128: one frame a block of S threads
    (``warps_per_frame`` = S/32), a thread a state.

    Returns layout, frames_per_warp, warps_per_frame, lanes_per_frame,
    states_per_lane, threads, warps_per_block, smem_bytes and grid.
    """
    if S < 2 or S & (S - 1) or S > MAX_STATES:
        raise ValueError(f"S must be a power of 2 in [2, {MAX_STATES}], "
                         f"got {S}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"n must be in [1, {MAX_N}], got {n}")
    if S <= WARP_MAX_STATES:
        F = WARP_MAX_STATES // S
        # a 32-step ring of four ballot words, then two slots of staged r
        per_warp = 16 * _CHUNK + 16 * -(-2 * F * (_CHUNK * n + 1) // 4)
        wpb = max(1, min(_WARPS_A_BLOCK, _SMEM_DEFAULT // per_warp))
        warps = -(-B // F)
        return {"layout": "warp", "frames_per_warp": F,
                "warps_per_frame": 1, "lanes_per_frame": S // 2,
                "states_per_lane": 2, "threads": 32 * wpb,
                "warps_per_block": wpb, "smem_bytes": wpb * per_warp,
                "grid": max(1, -(-warps // wpb))}
    nw = S // 32
    smem = 4 * (2 * S + 2 * nw) + 4 * 2 * nw + 4 * _CHUNK * n
    return {"layout": "block", "frames_per_warp": 1, "warps_per_frame": nw,
            "lanes_per_frame": S, "states_per_lane": 1, "threads": S,
            "warps_per_block": nw, "smem_bytes": smem, "grid": max(1, B)}


def _check_acs(r, C, hconst):
    if r.dtype != torch.float32 or r.ndim != 3:
        raise ValueError(f"r must be float32 [B, T, n], got {r.dtype} "
                         f"{tuple(r.shape)}")
    if C.dtype != torch.float32 or C.ndim != 3 or C.shape[0] != 2 \
            or C.shape[2] != r.shape[2]:
        raise ValueError(f"C must be float32 [2, S, n={r.shape[2]}], got "
                         f"{C.dtype} {tuple(C.shape)}")
    S = C.shape[1]
    if S < 2 or S & (S - 1):
        raise ValueError(f"the number of states must be a power of 2, got {S}")
    if hconst is not None and (hconst.dtype != torch.float32
                               or tuple(hconst.shape) != (2, S)):
        raise ValueError(f"hconst must be float32 [2, {S}], got "
                         f"{hconst.dtype} {tuple(hconst.shape)}")
    for name, x in (("C", C), ("hconst", hconst)):
        if x is not None and x.device != r.device:
            raise ValueError(f"{name} is on {x.device}, r on {r.device}")
    return S


def _pack32(take: torch.Tensor) -> torch.Tensor:
    """[B, S] bool -> [B, G] int32, bit s % 32 of word s // 32."""
    B, S = take.shape
    width = min(S, 32)
    shifts = torch.arange(width, device=take.device)
    words = (take.long().view(B, _words(S), width) << shifts).sum(-1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def acs_forward_plain(r: torch.Tensor, C: torch.Tensor,
                      hconst: torch.Tensor | None = None):
    """Plain PyTorch version of the ACS kernel (same inputs and outputs).

    The branch metric is summed over n in index order and every candidate
    is ``(pm[pred] + bm)`` with ``pm`` renormalised by the previous step's
    minimum, the order of operations the kernel uses.
    """
    S = _check_acs(r, C, hconst)
    B, T, n = r.shape
    dev = r.device
    bm = r[..., None, None, 0] * C[:, :, 0]  # [B, T, 2, S]
    for i in range(1, n):
        bm = bm + r[..., None, None, i] * C[:, :, i]
    if hconst is not None:
        bm = bm + hconst
    s = torch.arange(S, device=dev)
    pred0 = (s & (S // 2 - 1)) << 1
    pred1 = pred0 | 1
    pm = torch.full((B, S), UNREACHED, dtype=torch.float32, device=dev)
    pm[:, 0] = 0.0
    dec = torch.empty((B, T, _words(S)), dtype=torch.int32, device=dev)
    best = torch.empty((B, T), dtype=torch.int32, device=dev)
    for t in range(T):
        cand0 = pm[:, pred0] + bm[:, t, 0]
        cand1 = pm[:, pred1] + bm[:, t, 1]
        take = cand1 < cand0
        new = torch.where(take, cand1, cand0)
        dec[:, t] = _pack32(take)
        best[:, t] = torch.argmin(new, dim=1)  # first index on ties
        pm = new - torch.amin(new, dim=1, keepdim=True)
    return dec, best


def acs_forward(r: torch.Tensor, C: torch.Tensor,
                hconst: torch.Tensor | None = None):
    """ACS forward pass: returns (dec ``[B, T, G]`` int32, best ``[B, T]``
    int32).  CUDA tensors launch the kernel; CPU tensors run
    :func:`acs_forward_plain`."""
    S = _check_acs(r, C, hconst)
    if r.device.type == "cpu":
        return acs_forward_plain(r, C, hconst)
    if r.device.type != "cuda":
        raise ValueError(f"acs_forward runs on cuda or cpu, not {r.device}")
    B, T, n = r.shape
    if S > MAX_STATES or n > MAX_N:
        raise NotImplementedError(
            f"the CUDA ACS kernel takes S <= {MAX_STATES} and n <= {MAX_N} "
            f"(got S={S}, n={n})")
    for name, x in (("r", r), ("C", C), ("hconst", hconst)):
        if x is not None and not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    G = _words(S)
    dec = torch.empty((B, T, G), dtype=torch.int32, device=r.device)
    best = torch.empty((B, T), dtype=torch.int32, device=r.device)
    if B and T:
        plan = acs_plan(S, n, B)
        with torch.cuda.device(r.device):
            rc = _lib().acs_forward_launch(
                r.data_ptr(), C.data_ptr(),
                None if hconst is None else hconst.data_ptr(),
                dec.data_ptr(), best.data_ptr(), B, T, n, S, G,
                int(plan["layout"] == "block"), plan["threads"],
                plan["grid"], plan["smem_bytes"],
                torch.cuda.current_stream(r.device).cuda_stream)
        if rc:
            raise RuntimeError(f"acs_forward kernel launch failed: CUDA "
                               f"error {rc}")
        acs_forward.launches += 1
    return dec, best


acs_forward.launches = 0


def _check_traceback(dec, best, S, tb_depth):
    if dec.dtype != torch.int32 or dec.ndim != 3 or dec.shape[2] != _words(S):
        raise ValueError(f"dec must be int32 [B, T, {_words(S)}], got "
                         f"{dec.dtype} {tuple(dec.shape)}")
    if best.dtype != torch.int32 or tuple(best.shape) != tuple(dec.shape[:2]):
        raise ValueError(f"best must be int32 {tuple(dec.shape[:2])}, got "
                         f"{best.dtype} {tuple(best.shape)}")
    if best.device != dec.device:
        raise ValueError(f"best is on {best.device}, dec on {dec.device}")
    if S < 2 or S & (S - 1):
        raise ValueError(f"the number of states must be a power of 2, got {S}")
    if tb_depth < 2:
        raise ValueError(f"tb_depth must be >= 2 (got {tb_depth})")


def traceback_plain(dec: torch.Tensor, best: torch.Tensor, S: int,
                    tb_depth: int) -> torch.Tensor:
    """Plain PyTorch version of the traceback kernel: every position walks
    back from the end of the window that finalises it, all at once."""
    _check_traceback(dec, best, S, tb_depth)
    B, T, _ = dec.shape
    dev = dec.device
    p = torch.arange(T, device=dev)
    w = torch.clamp(p + (tb_depth - 2), max=T - 1)
    steps = w - p
    cur = best[:, w].long()
    words = dec.long() & 0xFFFFFFFF  # unsigned, so bit 31 reads as 1
    bidx = torch.arange(B, device=dev)[:, None]
    half = S // 2 - 1
    for i in range(min(tb_depth - 2, T - 1)):
        t = torch.clamp(w - i, min=0)[None, :]
        j = (words[bidx, t, cur >> 5] >> (cur & 31)) & 1
        cur = torch.where(i < steps, ((cur & half) << 1) | j, cur)
    return (cur >> max(S.bit_length() - 2, 0)).to(torch.int8)


def traceback(dec: torch.Tensor, best: torch.Tensor, S: int,
              tb_depth: int) -> torch.Tensor:
    """Sliding-window traceback: returns bits ``[B, T]`` int8.  CUDA
    tensors launch the kernel; CPU tensors run :func:`traceback_plain`."""
    _check_traceback(dec, best, S, tb_depth)
    if dec.device.type == "cpu":
        return traceback_plain(dec, best, S, tb_depth)
    if dec.device.type != "cuda":
        raise ValueError(f"traceback runs on cuda or cpu, not {dec.device}")
    if not (dec.is_contiguous() and best.is_contiguous()):
        raise ValueError("dec and best must be contiguous")
    B, T, G = dec.shape
    out = torch.empty((B, T), dtype=torch.int8, device=dec.device)
    if B and T:
        with torch.cuda.device(dec.device):
            rc = _lib().traceback_launch(
                dec.data_ptr(), best.data_ptr(), out.data_ptr(), B, T, G, S,
                min(tb_depth, T + 1),
                torch.cuda.current_stream(dec.device).cuda_stream)
        if rc:
            raise RuntimeError(f"traceback kernel launch failed: CUDA "
                               f"error {rc}")
        traceback.launches += 1
    return out


traceback.launches = 0
