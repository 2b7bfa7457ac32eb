"""BER of convolutional codes, hard vs soft decoding.

Counterpart of ``examples/conv_encode_decode.py`` on the PyTorch port:
three codes (rate-1/2 K=3, its RSC variant, and rate-1/2 K=7), hard and
soft Viterbi decoding (the ACS and traceback kernels on the GPU), swept
over Eb/N0 by the Monte-Carlo engine on a one-rank mesh.

Run:  python examples/torch/conv_encode_decode.py                (GPU)
      python examples/torch/conv_encode_decode.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402

from commpy_tpu_torch.models import make_conv_awgn_link  # noqa: E402
from commpy_tpu_torch.ops.trellis import Trellis  # noqa: E402
from commpy_tpu_torch.parallel import make_mesh, montecarlo_ber  # noqa: E402
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402

CODES = {
    "K=3 (5,7)": (np.array([2]), np.array([[5, 7]])),
    "K=3 RSC": (np.array([2]), np.array([[1, 7]]), 5, "rsc"),
    "K=7 (133,171)o": (np.array([6]), np.array([[0o133, 0o171]])),
}


def main(device="cuda", *, snrs=np.arange(0, 7, 1.5), frame_bits=1000,
         frames_per_round=64, max_rounds=30, err_min=400):
    """Returns ``{"snrs": [...], "bers": {"<code> <decoding>": [...]}}``."""
    dev = resolve_device(device)
    snrs = np.asarray(snrs, float)
    mesh = make_mesh(device=dev)
    print(f"devices: {mesh.size()}")
    bers = {}
    for name, args in CODES.items():
        trellis = Trellis(*args)
        for decoding in ("hard", "soft"):
            link = make_conv_awgn_link(
                trellis=trellis, modulation_m=2, frame_bits=frame_bits,
                decoding_type=decoding, device=dev)
            res = montecarlo_ber(
                link.link_step, snrs, link.noise_std_fn, link.frame_bits,
                seed=0, frames_per_round=frames_per_round,
                max_rounds=max_rounds, err_min=err_min, device=dev,
                mesh=mesh)
            bers[f"{name} {decoding}"] = res.bers.tolist()
            row = "  ".join(f"{b:.2e}" for b in res.bers)
            print(f"{name:16s} {decoding:5s}  BER @ {snrs.tolist()} dB: {row}")
    return {"snrs": snrs.tolist(), "bers": bers}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
