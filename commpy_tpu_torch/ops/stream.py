"""Sequence-parallel stream decoding.

Counterpart of ``commpy_tpu/ops/stream.py``.  A long coded stream is
split along time over the ranks of a mesh; each rank decodes its shard
plus

* a **warmup halo** of W codewords from its left neighbour (survivor
  paths merge within a few constraint lengths, so after W >> 5K steps the
  windowed decisions coincide with the serial decoder's with overwhelming
  probability), and
* a **lookahead halo** of tb_depth codewords from its right neighbour (so
  its tail symbols get full-depth tracebacks),

exchanged by ring shifts (:func:`~commpy_tpu_torch.parallel.mesh.ppermute`)
— halo exchange, not gathers.  The functions are SPMD: every rank calls
them with its own shard and gets its own shard of the result.

CAVEAT — complement-degenerate codes: if every generator polynomial has an
EVEN number of taps (counting the input tap), complementing state+input
leaves all codewords unchanged, so a mid-stream decoder cannot distinguish
a trajectory from its complement (only the known start state breaks the
tie).  Such codes cannot be sequence-sharded.  Standard codes are safe —
e.g. the true 802.11 (133,171)_OCTAL = (91,121) generators have odd tap
weight.

Routes: each shard's Viterbi decode is
:func:`~commpy_tpu_torch.ops.viterbi.viterbi_decode_device` (the ACS and
traceback kernels K1 and K2 on the card); each MAP pass of the turbo
stream takes the turbo decoder's route (:func:`~commpy_tpu_torch.ops.turbo.
turbo_route`): the BCJR kernel K3 (:func:`~commpy_tpu_torch.kernels.bcjr.
bcjr_appdiff`, its plain version on a CPU tensor) where it takes the
trellis, else the masked log-BCJR core (``ops.turbo._bcjr_masked``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.bcjr import bcjr_appdiff
from ..parallel.mesh import (DeviceMesh, all_gather, axis_index, axis_size,
                             check_axis, ppermute)
from ..utils.device import device_constant, on_device
from .trellis import Trellis
from .turbo import NEG, _bcjr_masked, turbo_route
from .viterbi import viterbi_decode_device

__all__ = ["sharded_viterbi_stream", "sharded_turbo_stream"]

# K3's renormalisation period on the stream's MAP passes.  The reference
# (``_bcjr_masked``) normalises every step; K3 by default never does, so
# its metrics grow along the window by the sum of the branch magnitudes
# and e drifts from the reference by about eps times that sum (6.3e-3
# relative on the card at T ~ 6,000).  With a period of N the metrics
# stay within N steps' growth of the reference's.
# A decode's later passes carry large extrinsics, and with them large
# metrics; there the deviation grows with N, and every step is the one
# period that keeps it under half of 1e-5 (1 + |e|) on the card, for a
# few per cent of the stream's time over a period of 2 or 4
# (scripts/torch_stream_renorm.py reads each period).
STREAM_RENORM_EVERY = 1

def sharded_viterbi_stream(
    coded_local,
    trellis: Trellis,
    mesh: DeviceMesh,
    *,
    tb_depth: int = 0,
    decoding_type: str = "soft",
    warmup_codewords: int = 96,
    axis_name: str = "sp",
):
    """Decode this rank's shard of a time-sharded coded stream.

    coded_local : ``[n_local]`` this rank's shard of the stream (bits,
        LLRs or reals by ``decoding_type``), n_local a multiple of n; on
        the mesh's device type.
    tb_depth : traceback depth; 0 means ``5 * total_memory`` (not the
        serial decoder's ``min(5 * memory, L)``).
    warmup_codewords : the left halo W; 0 means no halo at all.

    Returns this rank's message bits ``[n_local * k / n]`` int8.
    """
    check_axis(mesh, axis_name)
    k, n = trellis.k, trellis.n
    if tb_depth <= 0:
        tb_depth = 5 * trellis.total_memory
    W, R = int(warmup_codewords), int(tb_depth)
    x = on_device(coded_local, mesh.device_type)
    if x.ndim != 1 or x.shape[0] % n:
        raise ValueError(f"the local shard must be 1-D with a multiple of "
                         f"{n} values, got {tuple(x.shape)}")
    n_cw = x.shape[0] // n
    if W > n_cw or R > n_cw:
        raise ValueError(f"halos of {W} and {R} codewords exceed the shard's "
                         f"{n_cw}")
    D, idx = axis_size(mesh), axis_index(mesh)
    # the last W codewords go right, the first R go left; an empty halo
    # at W = 0 (x[-0:] would be the whole shard)
    left = ppermute(x[x.shape[0] - W * n:], mesh, 1)
    right = ppermute(x[:R * n], mesh, -1)
    if idx == 0:
        left = torch.zeros_like(left)
    if idx == D - 1:
        right = torch.zeros_like(right)
    ext = torch.cat([left, x, right])
    bits = viterbi_decode_device(ext, trellis, tb_depth, decoding_type,
                                 L=(W + n_cw + R) * k, device=ext.device)
    return bits[W * k:(W + n_cw) * k]


def _map_pass(route, sy, pa, li, nv, inv_nv, trellis, max_log, first,
              valid=None, boundary=None):
    """One MAP pass over a ``[Wn]`` window: the prior-free APP log-ratio
    ``[Wn]`` (and the final alpha and backward-final beta ``[S]`` with
    ``boundary=(a0, bT)``).  ``first [1]``: whether this is the frame's
    first shard (its alpha starts exactly in state 0, unless the boundary
    gives the start).

    ``'torch'`` runs ``_bcjr_masked`` on ``[1, Wn]`` rows; ``'kernel'``
    runs K3 on ``[Wn, 1]`` streams pre-scaled by 1/noise_variance,
    renormalising every :data:`STREAM_RENORM_EVERY` steps, its carries
    less their maximum (K3 does not normalise per step).
    """
    if route == "torch":
        a0, bT = (None, None) if boundary is None else (
            boundary[0][None], boundary[1][None])
        vmask = (torch.ones((1, sy.shape[0]), dtype=torch.bool,
                            device=sy.device) if valid is None
                 else valid[None])
        out = _bcjr_masked(sy[None], pa[None], li[None], nv, trellis, vmask,
                           first, max_log, alpha_init=a0, beta_init=bT,
                           return_carries=boundary is not None)
        apps = out[0] if boundary is not None else out
        e = apps[0, :, 1] - apps[0, :, 0]
        if boundary is None:
            return e
        return e, out[1][0], out[2][0]
    kw = ({"valid": valid[:, None], "first": first} if valid is not None
          else {"boundary": (boundary[0][:, None], boundary[1][:, None])}
          if boundary is not None else {})
    out = bcjr_appdiff((sy * inv_nv)[:, None], (pa * inv_nv)[:, None],
                       li[:, None], trellis, max_log=max_log,
                       renorm_every=STREAM_RENORM_EVERY, **kw)
    if boundary is None:
        return out[:, 0]
    e, af, bf = out
    af, bf = af[:, 0], bf[:, 0]
    return e[:, 0], af - af.max(), bf - bf.max()


def sharded_turbo_stream(
    sys_local,
    par1_local,
    par2_local,
    trellis: Trellis,
    noise_variance,
    n_iterations: int,
    p_array,
    mesh: DeviceMesh,
    *,
    warmup: int = 64,
    axis_name: str = "sp",
    max_log: bool = False,
    boundary_init: str = "warmup",
    backend: str = "auto",
):
    """Turbo-decode ONE long frame split along time over the mesh.

    The BCJR recursions run per shard with ``warmup``-symbol state-metric
    halos exchanged by ring shifts (the windowed decoder's sub-block idea,
    with sub-block == rank's shard).  The interleaver is global: each
    extrinsic exchange all-gathers the T-value stream (tiled) and takes
    this shard's positions of the permuted stream.

    sys/par1/par2_local : ``[T/D]`` this rank's shard of the BPSK-mapped
        symbol streams; T must divide by the mesh size.
    ``boundary_init='nii'`` drops the per-iteration halos: each shard
    starts its recursions from the boundary alpha/beta its neighbours
    produced on the PREVIOUS turbo iteration, two [S]-value ring shifts
    a MAP pass; ``warmup`` is ignored there.  ``backend`` is the turbo
    decoder's (:func:`~commpy_tpu_torch.ops.turbo.turbo_route`):
    ``'auto'`` runs each MAP pass through K3's wrapper where K3 takes the
    trellis (its plain version on a CPU tensor), else on
    ``_bcjr_masked``; ``'torch'`` always on ``_bcjr_masked``; ``'cuda'``
    on K3 or raises.
    Returns this rank's decoded bits ``[T/D]`` int8.
    """
    check_axis(mesh, axis_name)
    p_np = np.asarray(p_array, np.int64)
    T = p_np.size
    inv_np = np.empty_like(p_np)
    inv_np[p_np] = np.arange(T)
    D, idx = axis_size(mesh), axis_index(mesh)
    if T % D:
        raise ValueError("frame length must divide by the mesh size")
    Tl = T // D
    if boundary_init not in ("warmup", "nii"):
        raise ValueError('boundary_init must be "warmup" or "nii"')
    W = int(warmup)
    if boundary_init == "warmup" and W > Tl:
        raise ValueError("warmup cannot exceed the per-device shard")
    sy_l, pa1_l, pa2_l = (on_device(x, mesh.device_type).to(torch.float32)
                          for x in (sys_local, par1_local, par2_local))
    if sy_l.shape != (Tl,) or pa1_l.shape != (Tl,) or pa2_l.shape != (Tl,):
        raise ValueError(f"each local stream must be [{Tl}]")
    dev = sy_l.device
    route = turbo_route(trellis, backend, dev.type)
    nv = np.float32(noise_variance)
    inv_nv = float(np.float32(1.0) / nv)
    # this shard's positions of the permuted streams
    p_loc = device_constant(p_np[idx * Tl:(idx + 1) * Tl], dev)
    inv_loc = device_constant(inv_np[idx * Tl:(idx + 1) * Tl], dev)
    first = torch.tensor([idx == 0], device=dev)
    is_last = idx == D - 1

    def gshift(x_l, perm_loc):
        # global permutation of a sharded stream: all-gather (T values),
        # then this shard's entries
        return all_gather(x_l, mesh)[perm_loc]

    def map_pass(sy, pa, li, **kw):
        return _map_pass(route, sy, pa, li, nv, inv_nv, trellis, max_log,
                         first=first, **kw)

    sy_i_l = gshift(sy_l, p_loc)

    if boundary_init == "nii":
        S = trellis.number_states
        exact = torch.full((S,), NEG, dtype=torch.float32, device=dev)
        exact[0] = 0.0
        uni = torch.zeros((S,), dtype=torch.float32, device=dev)
        a01 = a02 = exact if idx == 0 else uni
        bt1 = bt2 = uni

        def exchange(af, bf):
            # alpha flows right (shard 0 keeps the exact frame start), beta
            # flows left (the last shard stays uniform)
            a0 = ppermute(af, mesh, 1)
            bT = ppermute(bf, mesh, -1)
            return (exact if idx == 0 else a0), (uni if is_last else bT)

        L1 = torch.zeros((Tl,), dtype=torch.float32, device=dev)
        L2_l = L1
        for _ in range(int(n_iterations)):
            ext1, af1, bf1 = map_pass(sy_l, pa1_l, L1, boundary=(a01, bt1))
            a01, bt1 = exchange(af1, bf1)
            L2int = gshift(ext1, p_loc)
            diff2, af2, bf2 = map_pass(sy_i_l, pa2_l, L2int,
                                       boundary=(a02, bt2))
            a02, bt2 = exchange(af2, bf2)
            L2_l = L2int + diff2
            L1 = gshift(diff2, inv_loc)
        return (gshift(L2_l, inv_loc) > 0).to(torch.int8)

    def halo(x):  # [Tl] -> [W + Tl + W]
        if W == 0:  # no halo: x[-0:] would be the whole shard
            return x
        return torch.cat([ppermute(x[Tl - W:], mesh, 1), x,
                          ppermute(x[:W], mesh, -1)])

    valid = torch.cat([
        torch.full((W,), idx != 0, dtype=torch.bool, device=dev),
        torch.ones((Tl,), dtype=torch.bool, device=dev),
        torch.full((W,), not is_last, dtype=torch.bool, device=dev)])
    sy_e, pa1_e = halo(sy_l), halo(pa1_l)
    syi_e, pa2_e = halo(sy_i_l), halo(pa2_l)

    L1 = torch.zeros((Tl,), dtype=torch.float32, device=dev)
    L2_l = L1
    for _ in range(int(n_iterations)):
        ext1 = map_pass(sy_e, pa1_e, halo(L1), valid=valid)[W:W + Tl]
        L2int = gshift(ext1, p_loc)
        diff2 = map_pass(syi_e, pa2_e, halo(L2int), valid=valid)[W:W + Tl]
        L2_l = L2int + diff2
        L1 = gshift(diff2, inv_loc)
    return (gshift(L2_l, inv_loc) > 0).to(torch.int8)
