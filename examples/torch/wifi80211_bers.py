"""802.11 MCS BER comparison, batched on the device.

Counterpart of ``examples/wifi80211_bers.py`` on the PyTorch port: BER
of MCS 2 (QPSK 3/4) against MCS 3 (16-QAM 1/2) over AWGN, the K=7 soft
Viterbi decoder on the ACS and traceback kernels on the GPU.

Run:  python examples/torch/wifi80211_bers.py                (GPU)
      python examples/torch/wifi80211_bers.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402

from commpy_tpu_torch.models import wifi80211_device_link  # noqa: E402
from commpy_tpu_torch.parallel import make_mesh, montecarlo_ber  # noqa: E402
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(device="cuda", *, snrs=np.arange(6, 21, 3.0), frame_bits=1200,
         frames_per_round=64, max_rounds=20, err_min=300):
    """Returns ``{"snrs": [...], "bers": {"MCS 2": [...], "MCS 3": [...]}}``."""
    dev = resolve_device(device)
    snrs = np.asarray(snrs, float)
    mesh = make_mesh(device=dev)
    bers = {}
    for mcs in (2, 3):
        link = wifi80211_device_link(mcs, frame_bits=frame_bits, device=dev)
        res = montecarlo_ber(
            link.link_step, snrs, link.noise_std_fn, link.frame_bits,
            seed=1, frames_per_round=frames_per_round, max_rounds=max_rounds,
            err_min=err_min, device=dev, mesh=mesh)
        bers[f"MCS {mcs}"] = res.bers.tolist()
        row = "  ".join(f"{b:.2e}" for b in res.bers)
        print(f"MCS {mcs}: BER @ {snrs.tolist()} dB: {row}")
    return {"snrs": snrs.tolist(), "bers": bers}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
