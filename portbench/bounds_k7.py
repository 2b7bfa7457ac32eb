"""The yardstick of K7's roofline, the polar list decoder.

Counted from the configuration, not from the program.  A frame of a code
of length N = 2^n, decoded with L paths, with k info leaves (the payload
and the CRC) and A payload bits, takes at least:

* the tree: the L N n node values of the full successive-cancellation
  schedule (f or g at every node of every level, for every path), at
  ``NODE_OPS`` float instructions each (f: the minimum of two magnitudes
  and the sign; g: a select and an add);
* the path metrics: at each of the N - k frozen leaves each path's
  penalty max(-l, 0) and its add, and at each info leaf both candidates'
  of each path (``METRIC_OPS`` each);
* the selection of L from 2L candidates at each info leaf, counted as the
  (2L)^2 comparisons that rank them;
* the LLRs read once (4 N bytes) and the payload written once (A bytes).

None of these bounds K7: it is bound by latency, a walk of dependent
stages and prunes each waiting on shared memory or warp shuffles, so its
share of this bound reads low (a few %).  The peaks are
:mod:`portbench.bounds`'.
"""
from __future__ import annotations

from portbench.bounds import bound_s

NODE_OPS = 2
METRIC_OPS = 2


def k7_bound(frames: int, N: int, L: int, k: int, A: int):
    """Least work of decoding ``frames`` frames: (bytes, float
    instructions)."""
    n = N.bit_length() - 1
    tree = L * N * n * NODE_OPS
    metrics = METRIC_OPS * (L * (N - k) + 2 * L * k)
    select = k * (2 * L) ** 2
    return frames * (4 * N + A), frames * (tree + metrics + select)


def k7_bound_s(frames: int, N: int, L: int, k: int, A: int) -> float:
    """Least seconds of :func:`k7_bound`'s work on one H100."""
    return bound_s(*k7_bound(frames, N, L, k, A))

