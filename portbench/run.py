"""Run one cell of the port's benchmark once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Prints one JSON object as the last line of
standard output: the cell's end-to-end metrics (``--trace 0``) or its
per-layer metrics with the window's ``breakdown`` (``--trace 1``), and
the numbers compared with the plain reference under ``check``, which
are also the last lines of standard error.  Exits non-zero, printing no
result, without a CUDA card, with fewer cards than the cell asks for, or
if JAX or the JAX package is loaded at the end.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the program's kernel caches at fixed paths inside the checkout
CACHES = {"PYTORCH_KERNEL_CACHE_PATH": ROOT / "build" / "portbench" / "torch_kernels",
          "CUDA_CACHE_PATH": ROOT / "build" / "portbench" / "cuda_cache"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for key, path in CACHES.items():
        os.environ[key] = str(path)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import harness

    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: cell {cell.name} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              device, T_START)
    found = harness.banned_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
