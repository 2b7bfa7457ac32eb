"""The polar cell's pieces: its two readers on a small trace written by
hand, the K7 yardstick against a hand count and ``chip_smoke.py``'s, its
plain reference against the port's plain CPU route at the cell's block
(bit for bit; in bfloat16, the control, not), and a tiny run of the
cell, sound and under each fault."""
import json
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import bounds, bounds_k7, control, harness
from portbench.reference import draws
from portbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
CELL = "polar1024.waterfall5"
CPU = torch.device("cpu")


def _x(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _ctx(tmp_path, kernel="void polar_scl_kernel<8>(float const*)",
         chain=None):
    """Two link steps in a 1000 us window: each decode span launches one
    kernel of 300 us, after a demapper kernel of 20 us."""
    events = [_x("portbench.window", "user_annotation", 0, 1000)]
    for k, t0 in enumerate((100, 550)):
        events += [
            _x("link.demodulate", "user_annotation", t0, 10),
            _x("cudaLaunchKernel", "cuda_runtime", t0 + 2, 2, 10 * k + 1),
            _x("demap_joint_kernel", "kernel", t0 + 20, 20, 10 * k + 1),
            _x("link.polar_decode", "user_annotation", t0 + 10, 30),
            _x("cudaLaunchKernel", "cuda_runtime", t0 + 12, 2, 10 * k + 2),
            _x(kernel, "kernel", t0 + 40, 300, 10 * k + 2),
            _x("link.count_errors", "user_annotation", t0 + 50, 5)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    cell = harness.load_cell(CELL)
    ref = SimpleNamespace(chain=chain if chain is not None else
                          harness.reference_chain(cell.config, CPU))
    return harness.Context(cell, Trace(str(path)), harness.Window(0.0, 1.0),
                           ref)


def test_polar_decode_time_per_mbit(tmp_path):
    ctx = _ctx(tmp_path)
    assert ctx.steps == 2
    want = 0.6 / (2 * 4096 * 512 / 1e6)
    assert harness.read_metric("polar_decode_ms_per_Mbit", ctx) == \
        pytest.approx(want)


def test_k7_roofline_counts_the_configurations_decodes(tmp_path):
    ctx = _ctx(tmp_path)
    least = bounds_k7.k7_bound_s(2 * 4096, 1024, 8, 523, 512)
    assert harness.read_metric("k7_roofline", ctx) == \
        pytest.approx(100.0 * least / 600e-6)


def test_readers_read_nothing_without_their_kernels_or_spans(tmp_path):
    ctx = _ctx(tmp_path, kernel="bcjr_kernel<8, 0, false>")
    assert harness.read_metric("k7_roofline", ctx) is None
    ctx = _ctx(tmp_path, chain=SimpleNamespace())
    assert harness.read_metric("k7_roofline", ctx) is None
    ctx.trace.host = [e for e in ctx.trace.host
                      if e["name"] != "link.polar_decode"]
    assert harness.read_metric("polar_decode_ms_per_Mbit", ctx) is None


def test_bounds_k7_is_a_hand_count():
    # N = 8 (n = 3), L = 2, k = 3 info leaves, A = 2 payload bits, 5 frames:
    # tree 2 * 8 * 3 node values, 2 instructions each = 96; metrics 2 * (2
    # paths * 5 frozen leaves + 4 candidates * 3 info leaves) = 44; the
    # selection 3 * 4^2 = 48; bytes 4 * 8 + 2 = 34 a frame
    nbytes, ops = bounds_k7.k7_bound(5, 8, 2, 3, 2)
    assert (nbytes, ops) == (5 * 34, 5 * (96 + 44 + 48))
    assert bounds_k7.k7_bound_s(5, 8, 2, 3, 2) == max(
        nbytes / bounds.HBM_BYTES_PER_S, ops / bounds.F32_INSTR_PER_S)


def test_bounds_k7_is_chip_smokes():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    assert chip_smoke.k7_bound is bounds_k7.k7_bound
    assert chip_smoke.k7_bound_s is bounds_k7.k7_bound_s


def test_reference_equals_the_port_at_the_cells_block():
    cell = harness.load_cell(CELL)
    link = harness.build_link(cell.config, CPU)
    ref = harness.reference_chain(cell.config, CPU)
    snr = cell.snrs[0]
    ns = float(np.float32(link.noise_std_fn(snr)))
    assert ref.noise_std(snr) == ns
    gen = draws.round_generator(2**31 + 7, 3, 1, CPU)
    bits, noise = link.draw(gen, 8)
    gen = draws.round_generator(2**31 + 7, 3, 1, CPU)
    rbits, rnoise = draws.draw(gen, 8, ref.frame_bits, ref.n_symbols, CPU)
    assert torch.equal(bits, rbits) and torch.equal(noise, rnoise)
    want = link.transceive(bits, noise, ns)
    got, _ = ref.transceive(bits, noise, ns)
    assert torch.equal(got, want)
    assert int((want ^ bits).sum()) > 0
    low, _ = ref.transceive(bits, noise, ns, torch.bfloat16)
    assert not torch.equal(low, want)


@pytest.mark.parametrize("fault", [None, "half_batch", "altered_bit"])
def test_tiny_run_is_correct_unless_broken(fault):
    """The cell at eight frames and its two lowest points: a sound run
    reads correct, a run with a fault planted under the engine does not."""
    cell = harness.load_cell(CELL)
    cell.traffic.update(frames_per_round=8, snr_db=cell.traffic["snr_db"][:2])
    cell.traffic["check"]["sample_rounds"] = 1
    res = harness.run_cell(cell, 2**31 + 21, 0.01, False, CPU,
                           time.perf_counter(),
                           fault and control.FAULTS[fault])
    assert res["correct"] == (fault is None), res["check"]
