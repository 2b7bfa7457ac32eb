"""Profiling helpers (absent in the reference).

Counterpart of ``commpy_tpu/utils/profiling.py``:

* :func:`trace`: a context manager around ``torch.profiler`` (CPU, and
  CUDA when a card is present) that writes a Chrome trace file into
  ``log_dir`` (open it in Perfetto or ``chrome://tracing``);
* :class:`Throughput`: an items/s meter that synchronises the card around
  its clock, so queued kernels count toward the block that launched them;
* :func:`benchmark`: median wall-clock seconds a call, synchronising after
  each call;
* :func:`span`: the port's one way to mark host work on the profiler's
  timeline, a ``record_function`` while a profiler records and a shared
  no-op otherwise (:func:`recording`), so that an unprofiled run pays
  well under a microsecond a span, where an idle ``record_function``
  costs several.

The spans are ``mc.sweep`` (all of ``montecarlo_ber``), ``mc.round``
(one round of ``make_round_fn``), inside it ``mc.seed`` (the round's
generators) and ``mc.tally`` (the stack of its tallies and their read
back to the host, the round's one sync; the mesh's all-reduce too), and
the link stages ``link.<stage>`` of ``models/device_links.py``,
``link.draw`` first.  Kineto puts them and the device's kernels on one
timeline, linked by correlation id.

To see where a sweep's time goes, and how many belief-propagation sweeps
the resident QC kernel (K4) ran::

    from commpy_tpu_torch.kernels.qc_bp import qc_bp_resident as k4
    k4.sweeps = k4.frames = 0
    with trace("traces"):  # the Chrome trace goes to traces/
        res = montecarlo_ber(link.link_step, snrs, link.noise_std_fn, ...)
    mean_sweeps = int(k4.sweeps) / k4.frames

``qc_bp_resident`` counts only while a profiler records; reading
``sweeps`` waits for the device once.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.autograd import profiler as _autograd_profiler
from torch.profiler import record_function

__all__ = ["trace", "Throughput", "benchmark", "span", "recording"]

_OFF = contextlib.nullcontext()


def recording() -> bool:
    """True while a ``torch.profiler`` session records (the flag that
    ``torch.profiler.profile`` sets on entry and clears on exit)."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A ``torch.profiler.record_function(name)`` while a profiler
    records, else one shared no-op context."""
    return record_function(name) if recording() else _OFF


def _sync():
    """Wait for the card's queued work (nothing to wait for without
    CUDA)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block and write ``trace_<pid>_<ns>.json`` into
    ``log_dir``; yields the ``torch.profiler.profile`` object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Throughput:
    """Accumulating items/s meter."""

    def __init__(self):
        self.items = 0
        self.seconds = 0.0

    @contextlib.contextmanager
    def measure(self, n_items: int):
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.seconds += time.perf_counter() - t0
        self.items += n_items

    @property
    def per_second(self) -> float:
        return self.items / self.seconds if self.seconds else 0.0


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 1):
    """Median wall-clock seconds a call; waits for the card's results."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
