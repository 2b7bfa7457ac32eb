"""Polar-coded BER curves: SC against CRC-aided SCL over AWGN.

Counterpart of ``examples/polar_ber.py`` on the PyTorch port: an
(N=256, K=128) polar code built plainly and with a CRC-11 outer code,
decoded by SC and by SCL-8 with the CRC, swept over Eb/N0 by the
Monte-Carlo engine on a one-rank mesh.  The CRC-aided list decoder buys
about 1 dB at FER 1e-2 over SC.

Run:  python examples/torch/polar_ber.py                (GPU)
      python examples/torch/polar_ber.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402

from commpy_tpu_torch.models import make_polar_awgn_link  # noqa: E402
from commpy_tpu_torch.ops.polar import polar_construct  # noqa: E402
from commpy_tpu_torch.parallel import make_mesh, montecarlo_ber  # noqa: E402
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(device="cuda", *, N=256, K=128, snrs=np.arange(0.0, 4.5, 1.0),
         frames_per_device=16, max_rounds=40, err_min=200):
    """Returns ``{"snrs": [...], "bers": {"SC": [...], "SCL-8+CRC11":
    [...]}}``."""
    dev = resolve_device(device)
    snrs = np.asarray(snrs, float)
    mesh = make_mesh(device=dev)
    n_dev = mesh.size()
    code_sc = polar_construct(N, K, design_snr_db=2.0)
    code_crc = polar_construct(N, K, crc="crc11", design_snr_db=2.0)
    links = [
        ("SC", make_polar_awgn_link(code=code_sc, decoder="sc", device=dev)),
        ("SCL-8+CRC11", make_polar_awgn_link(code=code_crc, decoder="scl",
                                             list_size=8, device=dev)),
    ]
    print(f"(N, K) = ({N}, {K}), BPSK/AWGN, {n_dev}-device mesh")
    print("Eb/N0 dB | " + " | ".join(f"{name:>12}" for name, _ in links))
    bers = {}
    for name, link in links:
        res = montecarlo_ber(
            link.link_step, snrs, link.noise_std_fn, link.frame_bits,
            seed=0, frames_per_round=frames_per_device * n_dev,
            max_rounds=max_rounds, err_min=err_min, device=dev, mesh=mesh)
        bers[name] = res.bers.tolist()
    for i, s in enumerate(snrs):
        row = " | ".join(f"{b[i]:12.3e}" for b in bers.values())
        print(f"{s:8.1f} | {row}")
    return {"snrs": snrs.tolist(), "bers": bers}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
