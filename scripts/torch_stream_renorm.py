"""The turbo stream's K3 renormalisation, read on its own.

Decodes L=6144 turbo frames (4-state (1, 7/5) RSC, 8 log-MAP
iterations, Eb/N0 2 dB) with ``commpy_tpu_torch.ops.stream``'s
``sharded_turbo_stream`` at world size 1, in both ``boundary_init``
modes, with the K3 route renormalising every 1, 2 and 4 steps, records
every MAP pass of every frame's decode and reads each against
``_bcjr_masked`` (``chip_smoke.py``'s ``k3_vs_bcjr_masked``: the largest
``|got - want| / (1 + |want|)``, the values past 1e-5 and the carries'
largest deviation up to their offset).

On the GPU (``--device cuda``, the default) it first builds the kernels
and holds K3 with ``renorm_every`` 1, 2 and 4 to its plain version
(``chip_smoke.py``'s ``k3_renorm_parity``), times K3 at the NII bench
shape (T=128, R=12288) with and without renormalisation in turns (CUDA
events), and times the stream a frame at each period.  On the CPU
(``--device cpu``) the route runs K3's plain version, and only the
passes are read.

Run from the root of a checkout:
    python3 scripts/torch_stream_renorm.py [--device cpu] [--seed 121]
        [--frames 8]
"""
import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from commpy_tpu_torch.kernels import bcjr as BK  # noqa: E402
from commpy_tpu_torch.ops import stream as ST  # noqa: E402
from commpy_tpu_torch.ops.interleave import RandInterlv  # noqa: E402
from commpy_tpu_torch.ops.turbo import turbo_encode_device  # noqa: E402
from commpy_tpu_torch.parallel import make_mesh  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=121)
    ap.add_argument("--frames", type=int, default=2)
    args = ap.parse_args()
    dev = torch.device(args.device)
    trt = CS.rsc_trellises()[1][1]
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
        from commpy_tpu_torch.kernels import _build

        t0 = time.perf_counter()
        _build.build()
        print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
        tally = CS.K3Tally()
        CS.k3_renorm_parity(torch, tally, CS.rsc_trellises())
        print(f"renormalised parity: {tally.cases} runs, {tally.compared} "
              f"values, {tally.mismatches} mismatches, {tally.bit_diffs} "
              f"differing bits", flush=True)
        syn, pan, li, vkw = CS.k3_inputs(torch, 4, 128, 12288, "boundary",
                                         5000, dev, halo=32)
        kw = dict(vkw, combined=True, posterior=True)
        turns = [0, 1, 2, 4, 4, 2, 1, 0]
        ms = [CS.cuda_ms(torch, lambda N=N: BK.bcjr_appdiff(
            syn, pan, li, trt, renorm_every=N, **kw), 20) for N in turns]
        print(f"K3 NII T=128 R=12288 ms by renorm_every, in turns: "
              f"{list(zip(turns, ms))}", flush=True)
    else:
        torch.set_num_threads(4)
    mesh = make_mesh(axis_name="sp", device=dev)
    rng = np.random.RandomState(args.seed)
    T = 6144
    p = RandInterlv(T, 0).p_array
    nv = float(np.float32(1 / (2 * (1 / 3) * 10 ** 0.2)))
    frames = []
    for _ in range(args.frames):
        m = torch.as_tensor(rng.randint(0, 2, (1, T)).astype(np.int8),
                            device=dev)
        x = 2.0 * torch.stack(turbo_encode_device(
            m, trt, trt, p, device=dev)).float()[:, 0] - 1.0
        z = torch.as_tensor(rng.randn(3, T).astype(np.float32), device=dev)
        frames.append((m[0], x + z * float(np.sqrt(nv))))

    def stream(y, mode):
        return ST.sharded_turbo_stream(y[0], y[1], y[2], trt, nv, 8, p, mesh,
                                       boundary_init=mode, warmup=64)

    kept = ST.STREAM_RENORM_EVERY
    try:
        for mode in ("warmup", "nii"):
            for N in (1, 2, 4):
                ST.STREAM_RENORM_EVERY = N
                errs = sum(int((stream(y, mode) != m).sum())
                           for m, y in frames)
                line = (f"stream {mode}, period {N}: {errs} errors in "
                        f"{len(frames)} frames")
                if dev.type == "cuda":
                    step = CS.host_step_s(torch, lambda: stream(frames[0][1],
                                                                mode))
                    line += f", {step * 1e3:.3f} ms a frame"
                worst = {"max_rel_dev": 0.0, "values_over_1e-5": 0,
                         "carry_max_rel_dev": 0.0}
                for _, y in frames:
                    v = CS.k3_vs_bcjr_masked(torch, ST, CS.record_calls(
                        ST, ("_map_pass",),
                        lambda: stream(y, mode))["_map_pass"])
                    worst["max_rel_dev"] = max(worst["max_rel_dev"],
                                               v["max_rel_dev"])
                    worst["values_over_1e-5"] += v["values_over_1e-5"]
                    worst["carry_max_rel_dev"] = max(
                        [worst["carry_max_rel_dev"]]
                        + v["carry_max_rel_dev"])
                print(f"{line}; every pass of every frame against "
                      f"_bcjr_masked: {worst}", flush=True)
    finally:
        ST.STREAM_RENORM_EVERY = kept
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
