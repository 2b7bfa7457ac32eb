"""The yardstick of the kernel rooflines: peaks, operations and bytes.

Frozen copies of the bound arithmetic that ``chip_smoke.py`` keeps
(``k1_bound``, ``k2_steps``, ``k2_bound``, ``qc_bound``, ``bound_ms``)
and of its peaks.  Inputs are counted read once and outputs written
once; operations run at the rate of their kind.  The peaks are NVIDIA's
data sheet for one H100 SXM at its full 700 W.
"""
from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # device memory bandwidth
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, an FMA as two
# the adds, multiplies, compares and selects that the bounds count are one
# instruction each, at half of that; an SM has 64 int32 lanes against 128
# float32 ones
F32_INSTR_PER_S = F32_OPS_PER_S / 2
INT32_OPS_PER_S = F32_OPS_PER_S / 4
# float operations per edge and sweep of a min-sum check update with its
# totals and syndrome: v2c subtract, |x|, two-minimum tracking (2), sign
# and zero tracking (2), leave-one-out select, scale, offset, clamp, sign
# product, the total update and the syndrome's XOR
MSA_OPS_PER_EDGE = 15


def bound_s(nbytes: float, ops: float, ops_per_s: float = F32_INSTR_PER_S):
    """Least seconds: the larger of the bytes' and the operations' time."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def k1_bound(B: int, T: int, n: int, S: int):
    """Viterbi ACS: received words read once, decisions and best states
    written once; per state and step two adds, a compare, the
    renormalising subtract and a compare of the minimum, plus the 2^n
    branch metrics of each step.  Returns (bytes, operations)."""
    G = -(-S // 32)
    return 4 * B * T * (n + G + 1), B * T * (5 * S + 2 ** n * (2 * n - 1))


def k2_steps(T: int, tb_depth: int) -> int:
    """Back-steps of one frame's sliding traceback: each position walks
    from the end of its window, ``min(tb_depth - 2, T - 1 - p)`` steps."""
    walk = np.minimum(min(tb_depth, T + 1) - 2, T - 1 - np.arange(T))
    return int(walk.clip(min=0).sum())


def k2_bound(B: int, T: int, S: int, steps: int):
    """Traceback: decisions and best states read once, bits written once;
    four integer operations a back-step (at ``INT32_OPS_PER_S``)."""
    G = -(-S // 32)
    return B * T * (4 * G + 4 + 1), 4 * steps


def qc_bound(B: int, n: int, edges: int, sweeps):
    """QC min-sum: LLRs read once, posteriors (float32) and decisions
    (int8) written once; ``MSA_OPS_PER_EDGE`` per edge and sweep, for
    the sweeps each frame needs (``sweeps``, one count a frame)."""
    return B * n * (4 + 4 + 1), MSA_OPS_PER_EDGE * edges * int(np.sum(sweeps))
