"""Read a ``torch.profiler`` trace of the benchmark's window.

The profiler's Chrome trace holds the device's kernels, copies and
fills, the host's CUDA runtime calls (each kernel carries the
correlation id of the call that launched it, ctypes launches included),
and the host's ``record_function`` spans (the program's ``link.*`` and
the benchmark's ``portbench.window``).  Everything here reads that file
and nothing of the program.
"""
from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

WINDOW_SPAN = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def label(name: str, width: int = 160) -> str:
    """A kernel or operator name without the namespaces that every
    PyTorch kernel shares, cut to ``width`` characters."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::",
                  "c10::", "std::"):
        name = name.replace(noise, "")
    return " ".join(name.split())[:width]


def _union(intervals):
    """Merged ``[(start, end)]`` of possibly overlapping intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one traced window (times in microseconds)."""

    def __init__(self, path: str):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        span = [e for e in events if e.get("name") == WINDOW_SPAN
                and e.get("cat") == "user_annotation"]
        if len(span) != 1:
            raise RuntimeError(f"the trace holds {len(span)} "
                               f"'{WINDOW_SPAN}' spans, not 1")
        self.w0 = float(span[0]["ts"])
        self.w1 = self.w0 + float(span[0]["dur"])
        inside = [e for e in events if e.get("ph") == "X" and "dur" in e
                  and self.w0 <= float(e["ts"]) <= self.w1]
        self.device = [e for e in inside if e.get("cat") in DEVICE_CATS]
        self.kernels = [e for e in self.device if e["cat"] == "kernel"]
        self.host = [e for e in inside if e.get("cat") in HOST_CATS
                     and e.get("name") != WINDOW_SPAN]
        self.launch_ts = {e["args"]["correlation"]: float(e["ts"])
                          for e in inside if e.get("cat") in LAUNCH_CATS
                          and "correlation" in e.get("args", {})}
        self.busy = _union((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in self.device)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(min(b, self.w1) - a for a, b in self.busy) * 1e-6

    def spans(self, name: str):
        return [e for e in self.host
                if e["cat"] == "user_annotation" and e["name"] == name]

    def kernel_s(self, *names: str) -> float:
        """Device seconds of the kernels whose name holds one of ``names``."""
        return sum(float(e["dur"]) for e in self.kernels
                   if any(n in e["name"] for n in names)) * 1e-6

    def span_kernel_s(self, name: str) -> float | None:
        """Device seconds of the kernels inside the spans ``name``.

        Each span is placed on the device timeline by the kernels that
        its host interval launched (by correlation); every kernel that
        starts within that extent counts.  None if no span launched one.
        """
        starts = np.array(sorted(float(k["ts"]) for k in self.kernels))
        by_start = sorted(self.kernels, key=lambda k: float(k["ts"]))
        ends = np.array([float(k["ts"]) + float(k["dur"]) for k in by_start])
        total, found = 0.0, False
        for s in self.spans(name):
            a, b = float(s["ts"]), float(s["ts"]) + float(s["dur"])
            mine = [float(k["ts"]) for k in self.kernels
                    if a <= self.launch_ts.get(
                        k.get("args", {}).get("correlation"), -1.0) <= b]
            if not mine:
                continue
            found = True
            lo = np.searchsorted(starts, min(mine), "left")
            hi = np.searchsorted(starts, max(mine), "right")
            total += float(np.sum(ends[lo:hi] - starts[lo:hi]))
        return total * 1e-6 if found else None

    def device_ops(self, top: int = 10):
        """``[[name, seconds]]`` of the device operations that took most."""
        acc = defaultdict(float)
        for e in self.device:
            acc[label(e["name"])] += float(e["dur"]) * 1e-6
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10, longest: int = 2000):
        """``[[what the host was doing, seconds]]`` over the device's idle
        gaps in the window, by the innermost host event at each gap's
        middle (the ``longest`` gaps are read)."""
        edges = [self.w0] + [x for a, b in self.busy for x in (a, b)] + [self.w1]
        gaps = [(a, min(b, self.w1)) for a, b in zip(edges[::2], edges[1::2])
                if min(b, self.w1) > a]
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        ts = np.array([float(e["ts"]) for e in self.host])
        te = ts + np.array([float(e["dur"]) for e in self.host])
        names = [label(e["name"]) for e in self.host]
        acc = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            hit = np.flatnonzero((ts <= mid) & (te > mid))
            what = ("host: Python outside any operator (the round loop, "
                    "generator seeding)" if hit.size == 0 else
                    "host: " + names[hit[np.argmin(te[hit] - ts[hit])]])
            acc[what] += (b - a) * 1e-6
        return sorted(([k, v] for k, v in acc.items()),
                      key=lambda kv: -kv[1])[:top]
