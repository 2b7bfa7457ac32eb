"""Readings behind each cell's limits: the program, the control, the faults.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...]

On the card, at the cell's own size, in one process.  For every seed it
runs as many rounds as a run's check compares (one sweep for a sweep
cell) and prints one JSON line a reading:

* ``program``: the program's tallies against the plain reference (the
  lower reading of each compared number);
* ``control``: the reference computed in bfloat16, the nearest
  precision below the configuration's float32, put in the program's
  place (the upper reading);
* each fault of ``FAULTS`` planted in the program: its ``link_step``
  broken underneath the engine.

The benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch


def _half_batch(link):
    """Half of the frames left out, the count of the rest doubled."""
    def step(gen, n_frames, noise_std, rows=None):
        return 2 * link.link_step(gen, n_frames // 2, noise_std)
    return step


def _altered_bit(link):
    """One decoded bit of every frame flipped where it is produced."""
    def step(gen, n_frames, noise_std, rows=None):
        bits, noise = link.draw(gen, n_frames)
        dec = link.transceive(bits, noise, noise_std).clone()
        dec[:, 0] ^= 1
        return torch.sum(torch.bitwise_xor(dec, bits), dtype=torch.int32)
    return step


FAULTS = {"half_batch": _half_batch, "altered_bit": _altered_bit}


def short_window(harness, prog, cell, seed, device):
    """As many rounds as the check samples (one sweep for a sweep cell)."""
    from portbench.reference import draws
    if cell.traffic["mode"] == "sweep":
        return harness.run_sweeps(prog, cell, seed, 0.0, 1, device)
    return harness.run_rounds(prog, cell, draws.engine_seed(seed), 0.0,
                              int(cell.traffic["check"]["sample_rounds"]),
                              device)


def control_window(harness, win, cell, ref, dtype):
    """``win`` with every tally replaced by the reference's in ``dtype``."""
    import numpy as np
    ctrl = harness.Window(win.t0, win.t1)
    for (s, r), tallies in win.tallies.items():
        ctrl.tallies[(s, r)] = np.array(
            [ref.batch(s, r, p, dtype)[0] for p in range(len(tallies))])
    for s, res in win.sweeps:
        errs, sent = harness.sweep_tallies(cell, ref, s, dtype)
        ctrl.sweeps.append((s, type(res)(res.snrs_db, errs / sent, errs,
                                         sent, res.rounds)))
    return ctrl


def readings(harness, cell, seeds, device, emit=print, n_control=3):
    """The program's reading on every seed of ``seeds``, the control's and
    each fault's on the first ``n_control``; ``emit`` gets one dict a
    reading."""
    ref = harness.Reference(cell, device)
    runs = [("program", None)] + [(name, f) for name, f in FAULTS.items()]
    out = []
    for kind, fault in runs:
        prog = harness.set_up(cell, 0, device, fault)
        for n, seed in enumerate(seeds if fault is None else
                                 seeds[:n_control]):
            t = time.perf_counter()
            win = short_window(harness, prog, cell, seed, device)
            row = {"kind": kind, "seed": seed,
                   "numbers": harness.check(win, cell, ref, seed)}
            if kind == "program" and n < n_control:
                ctrl = control_window(harness, win, cell, ref, torch.bfloat16)
                out.append(row)
                emit(row)
                row = {"kind": "control", "seed": seed,
                       "numbers": harness.check(ctrl, cell, ref, seed)}
            row["seconds"] = time.perf_counter() - t
            out.append(row)
            emit(row)
        del prog
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, default=3,
                    help="seeds (the first) that the control and faults read")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from portbench import harness
    if not torch.cuda.is_available():
        print("portbench: the control runs on a CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    readings(harness, cell, args.seeds, torch.device("cuda", 0),
             lambda row: print(json.dumps(row), flush=True), args.controls)
    return 0


if __name__ == "__main__":
    sys.exit(main())
