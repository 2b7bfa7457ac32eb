"""One run of one cell: set-up, the measured window, the check, the result.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``; its traffic is
``workloads/<cell>.json`` and its configuration ``configs/<config>.json``.
The configuration names the program's link factory and its arguments,
the CUDA sources it needs, and its plain reference (``reference/``).

Two drive modes, both the program's Monte-Carlo engine
(``commpy_tpu_torch.parallel.montecarlo``) as users call it:

* ``rounds``: one ``make_round_fn(link.link_step, noise_stds, F)`` called
  round after round, rounds numbered from 0 under the run's seed; every
  point is active, so every simulated bit counts.
* ``sweep``: ``montecarlo_ber`` itself, over a pool of sweeps fixed by
  the cell (``pool_seed``, ``pool_sweeps``) in an order drawn from the
  run's seed; only the bits of points still active count
  (``bits_sent``).  The window ends with the first whole pass over the
  pool that finishes after ``--seconds``.

``correct`` compares the tallies that the window produced with the plain
reference's on the same draws (``check``).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from .reference import chain as reference_chain
from .reference import draws

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BANNED_MODULES = ("jax", "jaxlib", "flax", "commpy_tpu", "bench", "benchmarks")


def read_json(path: Path) -> dict:
    return json.loads(path.read_text())


@dataclass
class Cell:
    name: str
    entry: dict  # the cell's entry in BENCHMARK.json
    traffic: dict  # workloads/<cell>.json
    config: dict  # configs/<config>.json
    end_to_end: list  # the BENCHMARK.json metrics this cell reports
    per_layer: list

    @property
    def snrs(self):
        return [float(s) for s in self.traffic["snr_db"]]

    @property
    def frames(self) -> int:
        return int(self.traffic["frames_per_round"])


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    bench = benchmark or read_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"BENCHMARK.json has no cell {name!r}")
    traffic = read_json(HERE / "workloads" / f"{name}.json")
    config = read_json(HERE / "configs" / f"{entry['config']}.json")
    return Cell(name, entry, traffic, config,
                [m for m in bench["end_to_end"] if _reports(m, name)],
                [m for m in bench["per_layer"] if _reports(m, name)])


def resolve(path: str):
    module, _, attr = path.partition(":")
    return getattr(importlib.import_module(module), attr)


def evaluate(value):
    """A factory argument: ``{"call": "mod:fn", "args": [...], "kwargs":
    {...}}`` is the call's result; lists and other values stay."""
    if isinstance(value, dict) and "call" in value:
        return resolve(value["call"])(*map(evaluate, value.get("args", [])),
                                      **{k: evaluate(v) for k, v in
                                         value.get("kwargs", {}).items()})
    return value


def build_link(config: dict, device):
    factory = config["factory"]
    return resolve(factory["call"])(
        *map(evaluate, factory.get("args", [])), device=device,
        **{k: evaluate(v) for k, v in factory.get("kwargs", {}).items()})


@dataclass
class Program:
    """The system under test, as set-up leaves it."""
    link: object
    round_fn: object


def set_up(cell: Cell, engine_seed: int, device, wrap_step=None) -> Program:
    """Build the cell's kernels and link, and warm up with one round."""
    if device.type == "cuda":
        from commpy_tpu_torch.kernels import _build
        for name in cell.config.get("kernels", []):
            _build.load(name)
    from commpy_tpu_torch.parallel.montecarlo import make_round_fn
    link = build_link(cell.config, device)
    step = link.link_step if wrap_step is None else wrap_step(link)
    noise_stds = [float(link.noise_std_fn(s)) for s in cell.snrs]
    round_fn = make_round_fn(step, noise_stds, cell.frames, device=device)
    round_fn(engine_seed, 0)
    _sync(device)
    return Program(link, round_fn)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Window:
    t0: float
    t1: float = 0.0
    round_s: list = field(default_factory=list)
    # (engine seed, round) -> bit errors [points] of every round simulated
    tallies: dict = field(default_factory=dict)
    counted_bits: float = 0.0
    sweeps: list = field(default_factory=list)  # (engine seed, result)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def run_rounds(prog: Program, cell: Cell, engine_seed: int, seconds: float,
               n_rounds: int | None, device) -> Window:
    """Rounds until ``seconds`` have passed (or ``n_rounds`` rounds)."""
    _sync(device)
    win = Window(time.perf_counter())
    bits = len(cell.snrs) * cell.frames * cell.config["frame_bits"]
    r = 0
    while True:
        t = time.perf_counter()
        win.tallies[(engine_seed, r)] = prog.round_fn(engine_seed, r)
        win.t1 = time.perf_counter()
        win.round_s.append(win.t1 - t)
        win.counted_bits += bits
        r += 1
        if (r >= n_rounds) if n_rounds else (win.t1 - win.t0 >= seconds):
            return win


def run_sweeps(prog: Program, cell: Cell, seed: int, seconds: float,
               n_sweeps: int | None, device) -> Window:
    """``montecarlo_ber`` over the cell's pool of sweeps, in an order
    drawn from ``seed``, pass after pass until a pass ends after
    ``seconds`` (or for ``n_sweeps`` sweeps).

    Where a sweep's points stop depends on its draws (a point near the
    waterfall's foot stops at the first frame that fails), so every run
    does the same sweeps, in another order, and ends on a whole pass.
    """
    from commpy_tpu_torch.parallel.montecarlo import montecarlo_ber
    t = cell.traffic
    pool = [draws.sweep_seed(int(t["pool_seed"]), k)
            for k in range(int(t["pool_sweeps"]))]
    order = np.random.default_rng(draws.engine_seed(seed)).permutation(
        len(pool))

    def counting(seed_, rnd):
        # the engine's own round, its tallies kept for the check
        out = prog.round_fn(seed_, rnd)
        win.tallies[(seed_, rnd)] = out
        return out

    counting.frames_per_round = prog.round_fn.frames_per_round
    counting.noise_stds = prog.round_fn.noise_stds
    _sync(device)
    win = Window(time.perf_counter())
    while True:
        for k in order:
            res = montecarlo_ber(
                prog.link.link_step, cell.snrs, prog.link.noise_std_fn,
                cell.config["frame_bits"], pool[k],
                frames_per_round=cell.frames,
                max_rounds=int(t["max_rounds"]), err_min=int(t["err_min"]),
                send_max=int(float(t["send_max"])), round_fn=counting,
                device=device)
            win.t1 = time.perf_counter()
            win.sweeps.append((pool[k], res))
            win.counted_bits += float(np.sum(res.bits_sent))
            if n_sweeps and len(win.sweeps) >= n_sweeps:
                return win
        if not n_sweeps and win.t1 - win.t0 >= seconds:
            return win


def run_window(prog, cell, seed, seconds, device, traced: bool) -> Window:
    t = cell.traffic
    if t["mode"] == "rounds":
        n = int(t["trace_rounds"]) if traced else None
        return run_rounds(prog, cell, draws.engine_seed(seed), seconds, n,
                          device)
    if t["mode"] == "sweep":
        n = 1 if traced else None
        return run_sweeps(prog, cell, seed, seconds, n, device)
    raise ValueError(f"unknown drive mode {t['mode']!r}")


class Reference:
    """The plain reference's tallies of any round, computed once each."""

    def __init__(self, cell: Cell, device):
        self.cell = cell
        self.device = device
        self.chain = reference_chain(cell.config, device)
        self.noise_stds = [self.chain.noise_std(s) for s in cell.snrs]
        self.cache = {}

    def batch(self, engine_seed: int, rnd: int, point: int,
              dtype=torch.float32):
        """(bit errors, extras) of round ``rnd`` at point ``point``."""
        key = (engine_seed, rnd, point, dtype)
        if key not in self.cache:
            c = self.chain
            gen = draws.round_generator(engine_seed, rnd, point, self.device)
            bits, noise = draws.draw(gen, self.cell.frames, c.frame_bits,
                                     c.n_symbols, self.device)
            dec, extras = c.transceive(bits, noise, self.noise_stds[point],
                                       dtype)
            errs = int(torch.sum(dec ^ bits, dtype=torch.int64))
            self.cache[key] = (errs, {k: v.cpu().numpy()
                                      for k, v in extras.items()})
        return self.cache[key]


def check(win: Window, cell: Cell, ref: Reference, seed: int,
          dtype=torch.float32) -> dict:
    """The compared number ``tally_gap``: the summed gap between the
    program's and the reference's bit errors over a sample of the
    window's rounds (all points), or over one sweep's points, as a share
    of the reference's errors."""
    t = cell.traffic
    rng = np.random.default_rng([draws.engine_seed(seed), 0xC4EC])
    gap = total = 0
    if t["mode"] == "rounds":
        keys = sorted(win.tallies)
        n = min(int(t["check"]["sample_rounds"]), len(keys))
        for i in sorted(rng.choice(len(keys), size=n, replace=False)):
            s, r = keys[i]
            for p in range(len(cell.snrs)):
                e = ref.batch(s, r, p, dtype)[0]
                gap += abs(int(win.tallies[(s, r)][p]) - e)
                total += e
        return {"tally_gap": gap / max(total, 1)}
    s, res = win.sweeps[int(rng.integers(len(win.sweeps)))]
    errs, _ = sweep_tallies(cell, ref, s, dtype)
    return {"tally_gap": float(np.sum(np.abs(res.bit_errors - errs)))
            / max(float(np.sum(errs)), 1.0)}


def sweep_tallies(cell: Cell, ref: Reference, engine_seed: int,
                  dtype=torch.float32):
    """The reference's (bit errors, bits sent) per point of one sweep:
    each point's rounds, from 0, until ``err_min`` errors or ``send_max``
    bits or ``max_rounds`` rounds."""
    t = cell.traffic
    per_round = cell.frames * ref.chain.frame_bits
    errs = np.zeros(len(cell.snrs))
    sent = np.zeros(len(cell.snrs))
    for p in range(len(cell.snrs)):
        r = 0
        while (errs[p] < int(t["err_min"]) and sent[p] < float(t["send_max"])
               and r < int(t["max_rounds"])):
            errs[p] += ref.batch(engine_seed, r, p, dtype)[0]
            sent[p] += per_round
            r += 1
    return errs, sent


def traced_batches(win: Window, cell: Cell):
    """(engine seed, round, point) of every link step of the window."""
    return [(s, r, p) for (s, r) in sorted(win.tallies)
            for p in range(len(cell.snrs))]


class Context:
    """What a per-layer metric reader is given."""

    def __init__(self, cell, trace, win, ref):
        self.cell, self.trace, self.win, self.ref = cell, trace, win, ref
        self.steps = len(trace.spans("link.count_errors"))
        self.frames = cell.frames
        self.frame_bits = cell.config["frame_bits"]
        self.info_bits = self.steps * self.frames * self.frame_bits
        self.counted_bits = win.counted_bits

    def batch_extras(self, key: str):
        """The reference's ``key`` extras of every traced link step."""
        return [self.ref.batch(*b)[1].get(key)
                for b in traced_batches(self.win, self.cell)]


def read_metric(name: str, ctx: Context):
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", HERE / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(ctx)


def end_to_end(name: str, win: Window, setup_s: float):
    if name == "info_bits_per_s":
        return win.counted_bits / win.seconds / 1e6
    if name == "round_ms_p95":
        return float(np.percentile(np.asarray(win.round_s) * 1e3, 95))
    if name == "setup_s":
        return setup_s
    raise KeyError(f"no end-to-end metric {name!r}")


def banned_modules() -> list:
    return sorted({m.partition(".")[0] for m in sys.modules}
                  & set(BANNED_MODULES))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device,
             t_start: float, wrap_step=None) -> dict:
    """One run: returns the result object (``check`` last)."""
    engine_seed = draws.engine_seed(seed)
    prog = set_up(cell, engine_seed, device, wrap_step)
    trace = None
    if traced:
        win, trace = traced_window(prog, cell, seed, seconds, device)
    else:
        setup_s = time.perf_counter() - t_start
        win = run_window(prog, cell, seed, seconds, device, False)
    if device.type == "cuda":
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    del prog
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(cell, device)
    numbers = check(win, cell, ref, seed)
    limits = cell.traffic["check"]["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    metrics = {}
    if traced:
        ctx = Context(cell, trace, win, ref)
        for m in cell.per_layer:
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": end_to_end(m["name"], win, setup_s),
                                  "unit": m["unit"]}
    attempted = (len(win.sweeps) if cell.traffic["mode"] == "sweep"
                 else len(win.tallies))
    result = {
        "correct": all(v["value"] <= v["limit"] for v in compared.values()),
        "attempted": attempted,
        "failed": 0,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if traced:
        result["device"].update(busy_s=trace.busy_s, window_s=trace.window_s)
        result["breakdown"] = {"device_ops": trace.device_ops(),
                               "idle_gaps": trace.idle_gaps()}
    result["check"] = compared
    return result


def traced_window(prog, cell, seed, seconds, device):
    """The window under ``torch.profiler``, and its trace."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile, record_function

    from .trace import Trace
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("portbench.window"):
            win = run_window(prog, cell, seed, seconds, device, True)
            _sync(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        trace = Trace(path)
    finally:
        os.unlink(path)
    return win, trace
