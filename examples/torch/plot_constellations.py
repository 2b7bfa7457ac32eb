"""Constellation plots (counterpart of ``examples/plot_constellations.py``
and of CommPy's ``plotConsModem.py``) on the PyTorch port.

Draws 8-PSK, 16-QAM and 64-QAM with their Gray labels from the port's
CommPy-compatible modems and writes ``constellations.png`` to ``out``
(by default this script's own directory), on matplotlib's headless Agg
backend.

Run:  python examples/torch/plot_constellations.py                (GPU)
      python examples/torch/plot_constellations.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import matplotlib  # noqa: E402

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from commpy_tpu_torch.modulation import PSKModem, QAMModem  # noqa: E402
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(device="cuda", *, out=None):
    """Returns ``{"path": the PNG written, "points": {title: size}}``."""
    dev = resolve_device(device)
    if out is None:
        out = os.path.dirname(os.path.abspath(__file__))
    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    points = {}
    for ax, modem, title in (
        (axes[0], PSKModem(8, device=dev), "8-PSK"),
        (axes[1], QAMModem(16, device=dev), "16-QAM"),
        (axes[2], QAMModem(64, device=dev), "64-QAM"),
    ):
        c = modem.constellation
        points[title] = int(c.size)
        ax.scatter(c.real, c.imag, s=18)
        for idx, pt in enumerate(c):
            ax.annotate(format(idx, f"0{modem.num_bits_symbol}b"),
                        (pt.real, pt.imag), textcoords="offset points",
                        xytext=(4, 4), fontsize=6)
        ax.set_title(f"{title} (Gray labels)")
        ax.grid(alpha=0.3)
        ax.set_aspect("equal")
    path = os.path.join(out, "constellations.png")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("saved", path)
    return {"path": path, "points": points}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="directory of the PNG (default: this script's)")
    args = ap.parse_args()
    main(args.device, out=args.out)
