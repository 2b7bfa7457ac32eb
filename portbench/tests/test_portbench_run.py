"""The harness refuses a run without a card, and a run whose timed path
is broken underneath reads ``correct`` false; a sound one reads true."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from portbench import control, harness

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")


def tiny(name):
    """The cell at a size a CPU test holds: few frames, two points."""
    cell = harness.load_cell(name)
    t = cell.traffic
    if name.startswith("mcs4-bcc"):
        t.update(frames_per_round=2, snr_db=t["snr_db"][:1])
    else:
        t.update(frames_per_round=16, snr_db=t["snr_db"][1:3])
    if t["mode"] == "sweep":
        t.update(send_max=16 * 1458 * 3, pool_sweeps=2)
    t["check"]["sample_rounds"] = 1
    return cell


def test_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mcs4-bcc.awgn5",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / "build")})
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.parametrize("name", ["mcs4-ldpc.waterfall4", "mcs4-ldpc.sweep7",
                                  "mcs4-bcc.awgn5"])
def test_sound_run_is_correct(name):
    res = harness.run_cell(tiny(name), 2**31 + 11, 0.01, False, CPU,
                           time.perf_counter())
    assert res["correct"], res["check"]
    assert list(res)[-1] == "check"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    json.dumps(res)


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("name", ["mcs4-ldpc.waterfall4", "mcs4-ldpc.sweep7"])
def test_broken_timed_path_is_not_correct(name, fault):
    res = harness.run_cell(tiny(name), 2**31 + 12, 0.01, False, CPU,
                           time.perf_counter(), control.FAULTS[fault])
    assert not res["correct"], res["check"]


def test_bcc_altered_bit_is_not_correct():
    res = harness.run_cell(tiny("mcs4-bcc.awgn5"), 2**31 + 13, 0.01, False,
                           CPU, time.perf_counter(),
                           control.FAULTS["altered_bit"])
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", ["mcs4-ldpc.waterfall4", "mcs4-bcc.awgn5"])
def test_control_fails_where_the_program_passes(name):
    cell = tiny(name)
    rows = control.readings(harness, cell, [2**31 + 14], CPU, lambda r: None)
    limits = cell.traffic["check"]["limits"]
    by_kind = {r["kind"]: r["numbers"] for r in rows}
    assert all(v <= limits[k] for k, v in by_kind["program"].items())
    assert any(v > limits[k] for k, v in by_kind["control"].items())


@pytest.mark.card
@pytest.mark.parametrize("name", ["mcs4-bcc.awgn5", "mcs4-ldpc.waterfall4"])
def test_control_fails_on_the_card_at_the_cells_size(card, name):
    cell = harness.load_cell(name)
    rows = control.readings(harness, cell, [101, 102, 103], card,
                            lambda r: None)
    limits = cell.traffic["check"]["limits"]
    for row in rows:
        ok = all(v <= limits[k] for k, v in row["numbers"].items())
        assert ok == (row["kind"] == "program"), row
