"""Pipeline parallelism: the stages of a link chain across the ranks.

Counterpart of ``commpy_tpu/parallel/pipeline.py``.  One rank runs one
stage (SPMD: every rank calls :func:`pipeline_map` with the same
arguments and runs the stage of its own place on the mesh); in-flight
microbatches hop to the next rank by a ring shift (:func:`ppermute`,
neighbour traffic only), and the schedule is GPipe's fill-drain: with M
microbatches and D stages it runs M + D - 1 ticks.

Stages exchange a fixed "wire" tensor (one microbatch, any shape and
dtype): each stage packs its result into the wire, as the send and
receive buffers of a pipeline over NCCL must be.
"""
from __future__ import annotations

import torch

from .mesh import (DeviceMesh, axis_index, axis_size, check_axis, ppermute,
                   psum)

__all__ = ["pipeline_map"]


def pipeline_map(stage_fns, microbatches: torch.Tensor, mesh: DeviceMesh,
                 axis_name: str = "dp") -> torch.Tensor:
    """Run microbatches through a rank-staged pipeline.

    stage_fns : D callables, wire -> wire (same shape and dtype in and
        out).  Stage d runs on rank d of ``mesh``.
    microbatches : ``[M, *wire]``, the same on every rank; microbatch m
        enters stage 0 at tick m and leaves stage D-1 at tick m + D - 1.

    Returns ``[M, *wire]`` on every rank: the fully processed
    microbatches, ``stack([fD(...f1(x_m)) for m])``, in the wire's dtype.
    """
    check_axis(mesh, axis_name)
    D = axis_size(mesh)
    if len(stage_fns) != D:
        raise ValueError(
            f"{len(stage_fns)} stages for a {D}-device '{axis_name}' axis")
    M = microbatches.shape[0]
    idx = axis_index(mesh)
    stage = stage_fns[idx]
    last = idx == D - 1
    buf = (microbatches[0] if idx == 0
           else torch.zeros_like(microbatches[0]))
    out = torch.zeros_like(microbatches)
    for k in range(M + D - 1):
        # stage d works on microbatch k - d while 0 <= k - d < M
        m_here = k - idx
        y = stage(buf) if 0 <= m_here < M else buf
        if last and 0 <= m_here < M:
            out[m_here] = y
        # stage d's output feeds stage d+1 next tick; rank 0 takes the
        # next fresh microbatch instead of the wrap-around
        nxt = ppermute(y, mesh, 1)
        buf = microbatches[min(k + 1, M - 1)] if idx == 0 else nxt
    # only the last stage holds the outputs; the others add zeros
    return psum(out, mesh)
