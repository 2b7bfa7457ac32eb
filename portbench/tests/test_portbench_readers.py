"""The readers of the engine's and the draws' spans and of K4's counters,
on a small trace written by hand (device intervals and host spans as the
profiler's Chrome trace gives them), and on a program without them."""
import json

import pytest
import torch

from portbench import harness
from portbench.trace import Trace


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _ctx(tmp_path, spans):
    """Two rounds in a 1000 us window: each draw launches one kernel, the
    device is busy over [180, 420] and [700, 850]."""
    events = [_x("portbench.window", "user_annotation", 0, 1000),
              _x("cudaLaunchKernel", "cuda_runtime", 160, 5, 1),
              _x("cudaLaunchKernel", "cuda_runtime", 660, 5, 2),
              _x("draw_kernel", "kernel", 180, 240, 1),
              _x("draw_kernel", "kernel", 700, 150, 2)]
    events += [_x(n, "user_annotation", a, b - a) for n, a, b in spans]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    win = harness.Window(0.0, 1.0)
    return harness.Context(harness.load_cell("mcs4-ldpc.waterfall4"),
                           Trace(str(path)), win, None)


ROUNDS = [("mc.round", 100, 500), ("mc.seed", 100, 150),
          ("link.draw", 150, 200), ("link.count_errors", 300, 320),
          ("mc.tally", 400, 500),
          ("mc.round", 600, 900), ("link.draw", 650, 690),
          ("link.count_errors", 700, 720)]


def test_engine_idle_is_the_engine_time_off_the_device_and_the_link(tmp_path):
    # round 1: [100, 150] and [420, 500]; round 2: [600, 650], [690, 700]
    # and [850, 900]: 240 us over two rounds
    ctx = _ctx(tmp_path, ROUNDS)
    assert harness.read_metric("engine_idle_ms_per_round", ctx) == \
        pytest.approx(0.12)


def test_draw_time_per_mbit(tmp_path):
    ctx = _ctx(tmp_path, ROUNDS)
    assert ctx.steps == 2
    want = 0.39 / (2 * 4096 * 1458 / 1e6)
    assert harness.read_metric("draw_ms_per_Mbit", ctx) == pytest.approx(want)


def test_readers_of_spans_read_nothing_without_them(tmp_path):
    ctx = _ctx(tmp_path, [s for s in ROUNDS if s[0] == "link.count_errors"])
    assert harness.read_metric("engine_idle_ms_per_round", ctx) is None
    assert harness.read_metric("draw_ms_per_Mbit", ctx) is None


def test_k4_sweeps_per_frame_reads_the_programs_counters(tmp_path,
                                                        monkeypatch):
    from commpy_tpu_torch.kernels.qc_bp import qc_bp_resident
    ctx = _ctx(tmp_path, ROUNDS)
    monkeypatch.setattr(qc_bp_resident, "sweeps", torch.tensor(30))
    monkeypatch.setattr(qc_bp_resident, "frames", 4)
    assert harness.read_metric("k4_sweeps_per_frame", ctx) == 7.5
    monkeypatch.setattr(qc_bp_resident, "frames", 0)
    assert harness.read_metric("k4_sweeps_per_frame", ctx) is None
    monkeypatch.delattr(qc_bp_resident, "frames")
    monkeypatch.delattr(qc_bp_resident, "sweeps")
    assert harness.read_metric("k4_sweeps_per_frame", ctx) is None
