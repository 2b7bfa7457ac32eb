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
one frame, a thread a state.  The traceback walks every window in full,
a warp a frame and a lane four positions side by side, a back-step one
shared-memory read and three integer instructions (:func:`traceback_plan`).
Both kernels take binary-input, shift-structured trellises only;
``ops/viterbi.py`` routes every other trellis to its general path.

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

from . import (H100_SMS, SM_BLOCKS, SM_SMEM, SM_WARPS, SMEM_LIMIT,
               SMEM_PER_BLOCK, _build)

__all__ = ["acs_forward", "traceback", "acs_forward_plain",
           "traceback_plain", "traceback_merge_plain", "acs_plan",
           "traceback_plan", "MAX_STATES", "MAX_N"]

MAX_STATES = 1024  # the block layout: one thread per state
MAX_N = 8  # widest codeword the ACS kernel holds in registers
WARP_MAX_STATES = 64  # the warp layout: S/2 lanes a frame
UNREACHED = 3.0e37  # initial metric of every state but 0
_CHUNK = 32  # received steps staged in shared memory at a time
_WARPS_A_BLOCK = 4  # warps of a warp-layout block, shared memory allowing
_SMEM_DEFAULT = 48 * 1024  # shared memory a block gets without opting in
TB_LANES = 32  # traceback_merge_plain's lanes a frame, by default


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("viterbi_acs")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.acs_forward_launch.argtypes = [p, p, p, p, p, *[i] * 9, p]
    lib.acs_forward_launch.restype = i
    lib.traceback_launch.argtypes = [p, p, p, *[i] * 10, p]
    lib.traceback_launch.restype = i
    return lib


def _words(S: int) -> int:
    return -(-S // 32)


def _align16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


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


def _tb_run(T: int, lanes: int) -> int:
    """Positions a lane of the merge-aware walk owns: ceil(T/lanes)."""
    return max(1, -(-T // lanes))


def _tb_ring(T: int, tb_depth: int) -> int:
    """States a lane keeps of its window's path: the window's
    tb_depth - 1 states (at most T), rounded up to a power of two."""
    return 1 << (min(tb_depth, T + 1) - 2).bit_length()


def traceback_merge_plain(dec: torch.Tensor, best: torch.Tensor, S: int,
                          tb_depth: int, lanes: int = TB_LANES):
    """The merge-aware traceback in plain PyTorch: returns (bits ``[B, T]``
    int8, back-steps ``[B, lanes]``).

    Lane l owns positions ``[l*run, (l+1)*run)`` (:func:`_tb_run`) and
    decodes them in order.  It walks its first window in full, keeping
    the path's states in a ring (:func:`_tb_ring`, indexed by t modulo
    its size).  When the window moves up a step, the new path is walked
    back from the new window end only until it reaches a state the ring
    already holds at that time: below that the two paths are one, since
    a step's predecessor is a function of the state alone.  Each bit is
    the MSB of the ring's state at the position.  The result equals
    :func:`traceback_plain` bit for bit, ties included.

    It counts the back-steps a merge-aware walk needs on given decisions
    (about 1/13 of the full walks at the 802.11 MCS-4 shape), which
    ``chip_smoke.py`` reports beside K2's own count: a CUDA kernel of this
    walk was measured slower than K2's full walks (PERF.md).  Used by the
    tests and ``chip_smoke.py``, never by the decoder.
    """
    _check_traceback(dec, best, S, tb_depth)
    B, T, _ = dec.shape
    dev = dec.device
    D = min(tb_depth, T + 1)
    run, R = _tb_run(T, lanes), _tb_ring(T, tb_depth)
    words = dec.long() & 0xFFFFFFFF
    bidx = torch.arange(B, device=dev)[:, None]
    lane = torch.arange(lanes, device=dev)
    half, msb = S // 2 - 1, max(S.bit_length() - 2, 0)
    ring = torch.zeros((B, lanes, R), dtype=torch.long, device=dev)
    bits = torch.zeros((B, lanes * run), dtype=torch.int8, device=dev)
    steps = torch.zeros((B, lanes), dtype=torch.long, device=dev)
    p0 = lane * run

    def pred(c, t):  # the state at t - 1 on the path through c at t
        j = (words[bidx, t.clamp(0, T - 1), c >> 5] >> (c & 31)) & 1
        return ((c & half) << 1) | j

    def put(c, t, where):
        slot = (t & (R - 1)).expand(B, lanes)[..., None]
        old = ring.gather(2, slot)[..., 0]
        ring.scatter_(2, slot, torch.where(where, c, old)[..., None])

    on = (p0 < T).expand(B, lanes)
    w = torch.clamp(p0 + D - 2, max=T - 1)
    c = best[bidx, w.clamp(0, T - 1)].long()
    put(c, w, on)
    for k in range(D - 2):
        t = w - k
        go = on & (t > p0)
        c = torch.where(go, pred(c, t), c)
        put(c, t - 1, go)
        steps += go
    for i in range(run):
        p = p0 + i
        act = (p < T).expand(B, lanes)
        if i:
            moved = act & (p + D - 2 <= T - 1)
            w = torch.where(p + D - 2 <= T - 1, p + D - 2, w)
            c = best[bidx, w.clamp(0, T - 1)].long()
            put(c, w, moved)
            walking = moved
            for k in range(D - 2):
                t = w - k
                can = walking & (t > p)
                if not bool(can.any()):
                    break
                c = pred(c, t)
                slot = ((t - 1) & (R - 1)).expand(B, lanes)[..., None]
                merged = ring.gather(2, slot)[..., 0] == c
                steps += can
                walking = can & ~merged
                put(c, t - 1, walking)
        slot = (p & (R - 1)).expand(B, lanes)[..., None]
        bits[:, p] = (ring.gather(2, slot)[..., 0] >> msb).to(torch.int8)
    return bits[:, :T], steps


def traceback_plan(S: int, T: int, tb_depth: int, B: int,
                   sms: int = H100_SMS) -> dict:
    """K2's launch plan, a pure function of the states, the frame length,
    the traceback depth and the batch.

    A warp decodes a frame, a lane four positions side by side (128 a
    warp step).  The frame's decisions are staged in shared memory when
    they fit (``staged``), in rows ``row`` words apart: 1, or G + 1 from
    G = 2 (odd, so that the 32 lanes' reads of 32 consecutive rows fall
    in distinct banks).  Frames a block: of 8, 4, 2 and 1, the one that
    lets an SM hold the most frames at once.

    Returns D (the depth the kernel walks, min(tb_depth, T + 1)), row,
    staged, frame_bytes, frames_per_block, threads, smem_bytes, grid,
    frames_per_sm (by shared memory, blocks and warps) and waves.
    """
    if S < 2 or S & (S - 1) or S > MAX_STATES:
        raise ValueError(f"S must be a power of 2 in [2, {MAX_STATES}], "
                         f"got {S}")
    if tb_depth < 2 or T < 1:
        raise ValueError(f"need tb_depth >= 2 and T >= 1 (got {tb_depth}, "
                         f"{T})")
    G = _words(S)
    row = 1 if G == 1 else G + 1
    frame = _align16(4 * T * row)
    staged = frame <= SMEM_LIMIT
    frame = frame if staged else 0

    def resident(f):  # frames an SM holds at f frames a block
        return f * min(SM_SMEM // (f * frame + SMEM_PER_BLOCK), SM_BLOCKS,
                       SM_WARPS // f)
    F = max((f for f in (8, 4, 2, 1) if f * frame <= SMEM_LIMIT),
            key=lambda f: (resident(f), -f))
    blocks = resident(F) // F
    return {"D": min(tb_depth, T + 1), "row": row, "staged": staged,
            "frame_bytes": frame, "frames_per_block": F, "threads": 32 * F,
            "smem_bytes": F * frame, "grid": max(1, -(-B // F)),
            "frames_per_sm": F * blocks,
            "waves": -(-B // (F * blocks * sms))}


def traceback(dec: torch.Tensor, best: torch.Tensor, S: int,
              tb_depth: int) -> torch.Tensor:
    """Sliding-window traceback: returns bits ``[B, T]`` int8.  CUDA
    tensors launch the kernel by :func:`traceback_plan`; CPU tensors run
    :func:`traceback_plain`."""
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
        plan = traceback_plan(S, T, tb_depth, B)
        with torch.cuda.device(dec.device):
            rc = _lib().traceback_launch(
                dec.data_ptr(), best.data_ptr(), out.data_ptr(), B, T, G, S,
                plan["D"], plan["row"], int(plan["staged"]), plan["threads"],
                plan["grid"], plan["smem_bytes"],
                torch.cuda.current_stream(dec.device).cuda_stream)
        if rc:
            raise RuntimeError(f"traceback kernel launch failed: CUDA "
                               f"error {rc}")
        traceback.launches += 1
    return out


traceback.launches = 0
