"""Fused BCJR pass (K3): forward recursion, backward recursion and APP.

``bcjr_appdiff`` replaces ``commpy_tpu/kernels/bcjr.py:bcjr_appdiff_pallas``.
One call runs one constituent MAP pass of the turbo loop over ``[T, R]``
lanes, batch last (a lane is a frame, or a window of one): the forward
recursion stores its pre-update state metrics, and the backward recursion
emits the a-posteriori log-ratio ``app1 - app0`` at each step.  On a CUDA
tensor the wrapper launches the hand-written kernel
(``csrc/bcjr.cu``, built at first use) on the current stream, or raises;
on a CPU tensor it runs :func:`bcjr_appdiff_plain`, which has the same
inputs and outputs and follows the Pallas body's float operations in
order.  That plain version is what the kernel is held to, bit for bit.

The arithmetic is the Pallas kernel's:

* w-streams ``w1 = (sy + pa)/nv`` and ``w2 = (sy - pa)/nv``; the branch
  into state s under input u has metric ``sign[u][s] * w_{which[u][s]}``
  and the u=1 branches add the prior ``li`` (``_w_tables``);
* forward: ``alpha`` starts at 0 in state 0 and -1e30 elsewhere, and each
  step is ``lse2(alpha[inv_nst[s][0]] + g0[s], alpha[inv_nst[s][1]] +
  g1[s])``; backward: ``beta`` starts at 0, ``cand_u[s] = (beta +
  g_u)[nst[s][u]]``, ``e[t] = reduce_s(al + cand1) - reduce_s(al +
  cand0)`` with ``reduce_s`` halving contiguously (states s and s + S/2
  pair first); no per-step normalisation (``renorm_every=0``, the
  default);
* ``renorm_every=N > 0``: the forward recursion subtracts each lane's
  maximum over its S state metrics after step t whenever ``(t + 1) % N
  == 0``, the backward recursion after step t whenever ``(T - t) % N ==
  0``, in the masked variant whether or not step t is valid.  The
  schedule is fixed by the absolute step, so the kernel and the plain
  version stay bit for bit, and the stored pre-step metric after a
  renormalising step is the renormalised one.  Without it the metrics
  grow along the window by up to the sum of the branch magnitudes
  Gamma, and ``e`` carries float32 rounding of about eps * Gamma: the
  sequence-parallel turbo stream, whose reference normalises every step,
  renormalises every step to stay within float32 of it at any window
  length (``ops.stream.STREAM_RENORM_EVERY``);
* ``lse2``: exact ``max + log1p(exp(-|x-y|))``, max-log ``max``, or
  linear ``max + max(0.6931472 - 0.25|x-y|, 0)``;
* masked variant (``valid``/``first``): invalid steps leave both
  recursions as they were; ``first`` picks the exact state-0 start or a
  uniform 0 start.  Boundary variant (``boundary=(a0, bT)``): start
  metrics in, final alpha and backward-final beta out;
* ``io_dtype='bf16'`` rounds w1, w2 and li to bfloat16 on the way in and
  ``e`` on the way out.

The kernel runs the forward and backward recursions at once, meeting in
the middle: each stores its metrics for its first half of the frame, and
after one barrier each goes on through the other half emitting ``e[t]``
from the other's stored metrics, with the streams prefetched a few steps
ahead.  It has two forms, which :func:`bcjr_plan` picks from the
shapes.  In the state form each direction of a lane is a group of S
threads, one a state, exchanging metrics by warp shuffles, so few lanes
still fill the card.  In the lane form (``bcjr_kernel_lanes``), taken
where a thread per lane and direction fills the card alone, one thread
holds all S metrics of its direction: a step is S independent chains in
one thread, with no shuffles, and e's two state reductions run once.  It
needs the shift register's state maps (:func:`_lane_bits` checks the
tables); any other trellis runs the state form.  A block holds 32 lanes
in either form.  The ``[T, S]`` history of a lane lives in shared memory
or in a float32 scratch in device memory, as :func:`bcjr_plan` decides.
``bcjr_appdiff.launches`` counts the launches and
``bcjr_appdiff.lane_launches`` those in the lane form.

Dropped from the TPU wrapper, with the reason: ``lane_chunk`` and the
(8, 128) folding (a TPU tile shape; here a thread owns a state, or all
states, of a lane in one direction), ``astride`` (it recomputed odd
alphas when the history overflowed VMEM; the recomputed values equal the
stored ones, and here the history goes to device memory when it does not
fit shared memory), and ``_VMEM_BUDGET`` / ``bcjr_vmem_bytes`` (TPU VMEM
sizing).  The guards stay: binary input, a power-of-two number of states and bijective
per-input state maps.  The CUDA kernel takes S <= 16 and raises beyond.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.device import device_constant
from . import H100_SMS, SM_SMEM, SMEM_LIMIT, SMEM_PER_BLOCK, _build, sm_count

__all__ = ["bcjr_appdiff", "bcjr_appdiff_plain", "bcjr_plan", "MAX_STATES"]

MAX_STATES = 16  # a thread a state: 32 lanes of 16 fill 1024 threads
LANES = 32  # lanes a block, each with 2 S threads (a state a direction)
MAX_BLOCKS_PER_SM = 32
# the lane form's threads (2 R) an SM must get for the plan to take it: 6
# warps, where it overtook the state form in the H100 sweep of PERF.md
LANE_THREADS_PER_SM = 192
NEG = -1e30  # start metric of every state but 0
_MODES = {"exact": 0, "maxlog": 1, "linear": 2}
_FORMS = {"state": 0, "lane": 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("bcjr")
    p, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    ip = ctypes.POINTER(ctypes.c_int)
    lib.bcjr_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p, i, i, i, i,
                                i, i, i, i, i, i, ip, ip, u, u, u, u, u, u,
                                p]
    lib.bcjr_launch.restype = i
    return lib


def bcjr_plan(T: int, S: int, R: int, sms: int = H100_SMS,
              hist: str = None, form: str = None, shift: bool = True) -> dict:
    """K3's launch plan: the form and where the history lives, a pure
    function of the shapes.

    The lane form (a thread per lane and direction, all S metrics in it)
    runs where the trellis has the shift register's state maps (``shift``)
    and the ``2 R`` threads fill the card: at least
    :data:`LANE_THREADS_PER_SM` an SM.  Otherwise the state form (a
    thread per state and direction) fills it with ``2 S R`` threads.
    ``form`` ("lane" or "state") fixes the choice instead, for measuring
    it; "lane" raises ValueError where ``shift`` is False.

    A block holds :data:`LANES` lanes, ``2 * S`` threads each in the state
    form and 2 in the lane form; their history takes ``T * S * LANES``
    floats of shared memory in either.  It goes there when that fits
    :data:`SMEM_LIMIT` and the blocks an SM can then hold still take the
    whole grid (``ceil(R / LANES)`` blocks over ``sms`` SMs) at once;
    otherwise it goes to a ``[T, R, S]`` float32 scratch in device memory
    (which lets an SM hold more blocks).  ``hist`` ("shared" or "global")
    fixes the choice instead, for measuring it; "shared" raises ValueError
    when it does not fit.

    Raises ValueError past :data:`MAX_STATES` states.

    Returns ``{"form": "lane" | "state", "hist": "shared" | "global",
    "smem_bytes", "blocks", "threads", "blocks_per_sm"}`` (threads a
    block; ``blocks_per_sm`` as far as threads and shared memory allow).
    """
    if S > MAX_STATES:
        raise ValueError(f"the CUDA BCJR kernel takes S <= {MAX_STATES} "
                         f"states (got {S})")
    if form is None:
        form = ("lane" if shift and 2 * R >= LANE_THREADS_PER_SM * sms
                else "state")
    elif form not in ("lane", "state"):
        raise ValueError('form must be None, "lane" or "state"')
    elif form == "lane" and not shift:
        raise ValueError("the lane form takes a trellis with the shift "
                         "register's state maps only")
    shared = 4 * T * S * LANES
    blocks = -(-R // LANES)
    threads = 2 * LANES if form == "lane" else 2 * S * LANES
    # an SM runs at most 2048 threads and MAX_BLOCKS_PER_SM blocks
    most = min(MAX_BLOCKS_PER_SM, 2048 // threads)
    fits = shared <= SMEM_LIMIT
    if hist is None:
        per_sm = min(most, SM_SMEM // (shared + SMEM_PER_BLOCK))
        hist = "shared" if fits and blocks <= per_sm * sms else "global"
    elif hist == "shared" and not fits:
        raise ValueError(f"a history of T={T}, S={S} takes {shared} bytes "
                         f"of shared memory a block, {SMEM_LIMIT} available")
    elif hist not in ("shared", "global"):
        raise ValueError('hist must be None, "shared" or "global"')
    smem = shared if hist == "shared" else 0
    return {"form": form, "hist": hist, "smem_bytes": smem,
            "blocks": blocks, "threads": threads,
            "blocks_per_sm": min(most, SM_SMEM // (smem + SMEM_PER_BLOCK))}


@functools.lru_cache(maxsize=64)
def _w_tables(trellis):
    """Tables of the w-stream recursion: (inv_nst [S, 2], nst [S, 2],
    which [2, S], sign [2, S]).

    For input u and destination state s, the branch ``inv_nst[s, u]
    --u--> s`` has metric ``sign[u, s] * w_{which[u, s]} + u * li``.
    Requires a rate-1/2 binary trellis whose per-input state maps are
    bijections (every shift-register code).
    """
    from ..ops.turbo import _bcjr_tables_np

    nst, cs, cp, _, _ = _bcjr_tables_np(trellis)
    S, I = nst.shape
    if I != 2:
        raise NotImplementedError(
            "the BCJR kernel supports binary-input trellises; use "
            "backend='torch'")
    inv = np.full((S, 2), -1, np.int64)
    for s in range(S):
        for u in range(2):
            inv[nst[s, u], u] = s
    if (inv < 0).any():
        raise NotImplementedError(
            "trellis per-input state maps are not bijective; use "
            "backend='torch'")
    which = np.zeros((2, S), np.int64)
    sign = np.zeros((2, S), np.float32)
    for u in range(2):
        for s in range(S):
            sp = inv[s, u]
            a, b = cs[sp, u], cp[sp, u]
            which[u, s] = 0 if a == b else 1
            sign[u, s] = a
    tables = (inv, nst.astype(np.int64), which, sign)
    for t in tables:  # cached: shared by every caller
        t.setflags(write=False)
    return tables


def _lse2(mode: str):
    if mode == "maxlog":
        return torch.maximum
    if mode == "linear":
        def lse2(x, y):
            return torch.maximum(x, y) + torch.clamp_min(
                0.6931472 - 0.25 * torch.abs(x - y), 0.0)
        return lse2

    def lse2(x, y):
        return torch.maximum(x, y) + torch.log1p(torch.exp(-torch.abs(x - y)))
    return lse2


def _prepare(syn, pan, li, trellis, max_log, valid, first, io_dtype,
             boundary, lse, combined, renorm_every=0):
    """Checks and the kernel-side inputs shared by the kernel and its
    plain version: (mode, tables, w1, w2, li, valid, first, a0, bT), the
    streams in the io type, ``valid`` [T, R] and ``first`` [R] as bool
    (or None), the boundary metrics float32 [S, R] (or None).
    ``renorm_every`` (the renormalisation period, 0 for none) is checked
    only."""
    if io_dtype not in ("f32", "bf16"):
        raise ValueError('io_dtype must be "f32" or "bf16"')
    if (isinstance(renorm_every, bool)
            or int(renorm_every) != renorm_every or renorm_every < 0):
        raise ValueError(f"renorm_every must be an int >= 0, got "
                         f"{renorm_every!r}")
    if lse not in (None, "exact", "linear"):
        raise ValueError('lse must be None, "exact" or "linear"')
    S = trellis.number_states
    if S & (S - 1):
        raise NotImplementedError(
            "the BCJR kernel requires a power-of-two state count (every "
            "shift-register trellis); use backend='torch'")
    tables = _w_tables(trellis)
    if syn.ndim != 2 or pan.shape != syn.shape or li.shape != syn.shape:
        raise ValueError(f"syn, pan and li must share one [T, R] shape, got "
                         f"{tuple(syn.shape)}, {tuple(pan.shape)}, "
                         f"{tuple(li.shape)}")
    T, R = syn.shape
    dev = syn.device
    if valid is not None and boundary is not None:
        raise ValueError("boundary handoff and valid masking are mutually "
                         "exclusive")
    io = torch.bfloat16 if io_dtype == "bf16" else torch.float32
    for name, x in (("pan", pan), ("li", li), ("valid", valid),
                    ("first", first)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, syn on {dev}")
    if combined:
        w1, w2 = syn.to(io), pan.to(io)
    else:
        w1 = (syn.float() + pan.float()).to(io)
        w2 = (syn.float() - pan.float()).to(io)
    li_io = li.to(io)
    if valid is not None:
        if tuple(valid.shape) != (T, R):
            raise ValueError(f"valid must be [{T}, {R}], got "
                             f"{tuple(valid.shape)}")
        # the Pallas kernel reads the masks in the io type, > 0.5 (which
        # leaves a bool mask as it is)
        if valid.dtype != torch.bool:
            valid = valid.to(io).float() > 0.5
        if first is None:
            first = torch.ones(R, dtype=torch.bool, device=dev)
        elif first.dtype != torch.bool:
            first = first.to(io).float() > 0.5
        if tuple(first.shape) != (R,):
            raise ValueError(f"first must be [{R}], got {tuple(first.shape)}")
    a0 = bT = None
    if boundary is not None:
        a0, bT = (torch.as_tensor(x, device=dev).float() for x in boundary)
        for name, x in (("a0", a0), ("bT", bT)):
            if tuple(x.shape) != (S, R):
                raise ValueError(f"{name} must be [{S}, {R}], got "
                                 f"{tuple(x.shape)}")
    mode = "maxlog" if max_log else ("linear" if lse == "linear" else
                                      "exact")
    return mode, tables, w1, w2, li_io, valid, first, a0, bT


def _finish(e, li, af, bf, posterior, boundary):
    """The wrapper's output: ``e`` in float32, less the float32 prior
    unless ``posterior``; with the carries for the boundary variant."""
    e_out = e.float()
    if not posterior:
        e_out = e_out - li.float()
    if boundary is None:
        return e_out
    return e_out, af, bf


def bcjr_appdiff_plain(syn, pan, li, trellis, max_log: bool = False,
                       valid=None, first=None, io_dtype: str = "f32",
                       boundary=None, lse: str = None, combined: bool = False,
                       posterior: bool = False, renorm_every: int = 0):
    """Plain PyTorch version of the BCJR kernel (same inputs and outputs as
    :func:`bcjr_appdiff`), in the Pallas body's order of float operations.
    """
    mode, (inv, nst, which, sign), w1, w2, li_io, valid, first, a0, bT = \
        _prepare(syn, pan, li, trellis, max_log, valid, first, io_dtype,
                 boundary, lse, combined, renorm_every)
    N = int(renorm_every)
    lse2 = _lse2(mode)
    T, R = syn.shape
    S = trellis.number_states
    dev = syn.device
    w1f, w2f, lif = w1.float(), w2.float(), li_io.float()

    def branch(u):  # [T, S, R]: +-w per destination state
        w = torch.where(device_constant(which[u] == 1, dev)[None, :, None],
                        w2f[:, None, :], w1f[:, None, :])
        return torch.where(device_constant(sign[u] < 0, dev)[None, :, None],
                           -w, w)

    g0 = branch(0)
    g1 = branch(1) + lif[:, None, :]
    inv0, inv1 = (device_constant(inv[:, u], dev) for u in range(2))
    nst0, nst1 = (device_constant(nst[:, u], dev) for u in range(2))
    later = (torch.arange(S, device=dev) > 0)[:, None]
    if a0 is not None:
        alpha = a0
    elif valid is not None:
        alpha = torch.where(later & first[None, :], NEG, 0.0)
    else:
        alpha = torch.where(later, NEG, 0.0).expand(S, R)
    alpha = alpha.to(torch.float32)

    hist = []
    for t in range(T):
        hist.append(alpha)  # the pre-update metrics, which the APP at t uses
        a = lse2(alpha[inv0] + g0[t], alpha[inv1] + g1[t])
        alpha = a if valid is None else torch.where(valid[t], a, alpha)
        if N and (t + 1) % N == 0:
            alpha = alpha - alpha.amax(0)

    def reduce_s(x):
        while x.shape[0] > 1:
            h = x.shape[0] // 2
            x = lse2(x[:h], x[h:])
        return x[0]

    beta = (bT if bT is not None
            else torch.zeros((S, R), dtype=torch.float32, device=dev))
    e = torch.empty((T, R), dtype=w1.dtype, device=dev)
    for t in range(T - 1, -1, -1):
        cand0 = (beta + g0[t])[nst0]
        cand1 = (beta + g1[t])[nst1]
        b = lse2(cand0, cand1)
        al = hist[t]
        e[t] = (reduce_s(al + cand1) - reduce_s(al + cand0)).to(e.dtype)
        beta = b if valid is None else torch.where(valid[t], b, beta)
        if N and (T - t) % N == 0:
            beta = beta - beta.amax(0)
    return _finish(e, li, alpha, beta, posterior, boundary)


def _pack(bits) -> int:
    return int(sum(int(b) << s for s, b in enumerate(bits)))


@functools.lru_cache(maxsize=64)
def _lane_bits(trellis):
    """The lane form's bits of ``trellis`` (``pred``, ``succ``: for each
    state, whether input 0 takes the second of its shift-register
    neighbours), or None where the state maps are not the shift
    register's: the states entering d are 2 (d mod S/2) and 2 (d mod S/2)
    + 1, and s leaves to s // 2 and s // 2 + S/2 (every CommPy RSC
    trellis)."""
    inv, nst, _, _ = _w_tables(trellis)
    S = len(inv)
    s = np.arange(S)
    enter, leave = 2 * (s % (S // 2)), s // 2
    if not (np.array_equal(np.sort(inv, 1), np.stack([enter, enter + 1], 1))
            and np.array_equal(np.sort(nst, 1),
                               np.stack([leave, leave + S // 2], 1))):
        return None
    return _pack(inv[:, 0] != enter), _pack(nst[:, 0] != leave)


@functools.lru_cache(maxsize=64)
def _launch_tables(trellis):
    """The kernel's table arguments of ``trellis``: ``inv`` and ``nst`` as
    input-major ctypes int arrays, the which and neg bits of u = 0 and 1,
    then the lane form's pred and succ bits (0 where it has none)."""
    inv, nst, which, sign = _w_tables(trellis)
    tab = ctypes.c_int * inv.size
    return (tab(*inv.T.reshape(-1).tolist()), tab(*nst.T.reshape(-1).tolist()),
            _pack(which[0]), _pack(which[1]), _pack(sign[0] < 0),
            _pack(sign[1] < 0), *(_lane_bits(trellis) or (0, 0)))


def bcjr_appdiff(syn, pan, li, trellis, max_log: bool = False, valid=None,
                 first=None, io_dtype: str = "f32", boundary=None,
                 lse: str = None, combined: bool = False,
                 posterior: bool = False, renorm_every: int = 0):
    """Fused BCJR pass; returns the prior-free APP log-ratio.

    syn/pan : ``[T, R]`` symbol streams pre-scaled by 1/noise_variance
        (or, with ``combined=True``, the w-streams ``(sy + pa)/nv`` and
        ``(sy - pa)/nv`` themselves)
    li : ``[T, R]`` intrinsic LLRs
    valid : ``[T, R]`` or None; the recursions pass through invalid
        positions unchanged (window halos, padding)
    first : ``[R]`` bool or None; True lanes start exactly in state 0,
        False lanes from a uniform metric; None means all exact
    boundary : None, or ``(a0 [S, R], bT [S, R])`` start alpha and
        final-position beta; then returns ``(e, a_fin, b_fin)``, the
        post-final alpha and the backward-final beta.  Excludes ``valid``.
    lse : None or ``"exact"`` (log-MAP, or max-log with ``max_log``) or
        ``"linear"`` (linear-log-MAP)
    io_dtype : ``"f32"`` or ``"bf16"`` (streams and ``e`` rounded)
    posterior : return ``li + e`` (the full posterior ratio) instead of e
    renorm_every : 0 (the Pallas kernel's arithmetic: no normalisation),
        or N > 0: each recursion subtracts each lane's state-metric
        maximum every N steps, on the schedule of the module docstring

    Returns ``e [T, R]`` float32.  CUDA tensors launch the kernel; CPU
    tensors run :func:`bcjr_appdiff_plain`.
    """
    if syn.device.type == "cpu":
        return bcjr_appdiff_plain(syn, pan, li, trellis, max_log, valid,
                                  first, io_dtype, boundary, lse, combined,
                                  posterior, renorm_every)
    if syn.device.type != "cuda":
        raise ValueError(f"bcjr_appdiff runs on cuda or cpu, not "
                         f"{syn.device}")
    mode, _, w1, w2, li_io, valid, first, a0, bT = \
        _prepare(syn, pan, li, trellis, max_log, valid, first, io_dtype,
                 boundary, lse, combined, renorm_every)
    T, R = syn.shape
    S = trellis.number_states
    if S > MAX_STATES:
        raise NotImplementedError(
            f"the CUDA BCJR kernel takes S <= {MAX_STATES} states (got {S})")
    plan = bcjr_plan(T, S, R, sm_count(syn.device.index),
                     shift=_lane_bits(trellis) is not None)
    return _bcjr_launch(trellis, mode, w1, w2, li_io, valid, first, a0, bT,
                        li, boundary, posterior, plan, renorm_every)


def _bcjr_launch(trellis, mode, w1, w2, li_io, valid, first, a0, bT, li,
                 boundary, posterior, plan, renorm_every=0):
    """Launch K3 on checked CUDA inputs (``_prepare``'s) by ``plan``."""
    T, R = w1.shape
    S = trellis.number_states
    dev = w1.device
    w1, w2, li_io = w1.contiguous(), w2.contiguous(), li_io.contiguous()
    e = torch.empty((T, R), dtype=w1.dtype, device=dev)
    af = bf = None
    if boundary is not None:
        a0, bT = a0.contiguous(), bT.contiguous()
        af = torch.empty((S, R), dtype=torch.float32, device=dev)
        bf = torch.empty((S, R), dtype=torch.float32, device=dev)
    if valid is not None:  # bool, stored as one byte of 0 or 1
        valid = valid.contiguous().view(torch.uint8)
        first = first.contiguous().view(torch.uint8)
    variant = 2 if boundary is not None else (1 if valid is not None else 0)
    if plan["form"] == "lane" and _lane_bits(trellis) is None:
        raise ValueError("the lane form takes a trellis with the shift "
                         "register's state maps only")
    if T and R:
        shared = plan["hist"] == "shared"
        hist = None if shared else torch.empty((T, R, S), dtype=torch.float32,
                                               device=dev)
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        with torch.cuda.device(dev):
            rc = _lib().bcjr_launch(
                w1.data_ptr(), w2.data_ptr(), li_io.data_ptr(), ptr(valid),
                ptr(first), ptr(a0), ptr(bT), e.data_ptr(), ptr(af), ptr(bf),
                ptr(hist), T, R, S, _MODES[mode], variant,
                int(renorm_every), int(w1.dtype == torch.bfloat16),
                _FORMS[plan["form"]], int(shared), plan["smem_bytes"],
                *_launch_tables(trellis),
                torch.cuda.current_stream(dev).cuda_stream)
        if rc:
            raise RuntimeError(f"bcjr_appdiff kernel launch failed: CUDA "
                               f"error {rc}")
        bcjr_appdiff.launches += 1
        bcjr_appdiff.lane_launches += plan["form"] == "lane"
    elif boundary is not None:  # nothing to run: the carries pass through
        af.copy_(a0)
        bf.copy_(bT)
    return _finish(e, li, af, bf, posterior, boundary)


bcjr_appdiff.launches = 0
bcjr_appdiff.lane_launches = 0
