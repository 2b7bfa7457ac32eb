"""Coded-link showcase: turbo over AWGN and LDPC over Rayleigh fading.

Counterpart of ``examples/ldpc_turbo_links.py`` on the PyTorch port,
four BER sweeps through the Monte-Carlo engine on a one-rank mesh:

* the rate-1/3 turbo code (4-state RSC, L=512, 8 iterations; the BCJR
  kernel on the GPU);
* WiMAX LDPC (1440, 720) with QPSK over Rayleigh fading, min-sum 25
  (lifted onto the resident QC kernel);
* the 802.11n rate-1/2 n=648 code with QPSK, normalised min-sum
  (msa_scale 0.75; the resident QC kernel);
* a DVB-S2-class synthesised QC code (n=16200, Z=360, rate 4/9), a size
  the reference cannot construct or decode, normalised min-sum 20.  The
  JAX script decodes it by the flooding schedule; at Z=360 that is past
  the resident kernel's shared memory, and 'auto' would take the plain
  PyTorch core, so here it decodes by the layered schedule, on the
  streamed QC kernel, as the DVB-S2 decoders do.

Run:  python examples/torch/ldpc_turbo_links.py                (GPU)
      python examples/torch/ldpc_turbo_links.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402

from commpy_tpu_torch.models import (  # noqa: E402
    make_ldpc_rayleigh_link, make_qcldpc_awgn_link, make_turbo_awgn_link,
    wifi80211n_ldpc_link)
from commpy_tpu_torch.ops.interleave import RandInterlv  # noqa: E402
from commpy_tpu_torch.ops.ldpc import DESIGNS, get_ldpc_code_params  # noqa: E402,E501
from commpy_tpu_torch.ops.qcldpc import random_qc_params  # noqa: E402
from commpy_tpu_torch.ops.trellis import Trellis  # noqa: E402
from commpy_tpu_torch.parallel import make_mesh, montecarlo_ber  # noqa: E402
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402

# sweep: (SNRs in dB, frames a round, rounds, err_min), the JAX script's
SWEEPS = {
    "turbo": (np.arange(-2, 4, 1.0), 32, 15, 200),
    "wimax": (np.arange(6, 14, 2.0), 16, 15, 200),
    "80211n_648": (np.arange(2.0, 7.0, 1.0), 16, 10, 100),
    "dvbs2_16200": (np.array([3.0, 5.0]), 8, 3, 50),
}


def main(device="cuda", *, turbo_L=512, qc_shape=(25, 45, 360),
         sweeps=None):
    """``sweeps`` overrides entries of :data:`SWEEPS` by name.  Returns
    ``{name: {"snrs": [...], "bers": [...]}}``."""
    dev = resolve_device(device)
    sweeps = dict(SWEEPS, **(sweeps or {}))
    mesh = make_mesh(device=dev)
    out = {}

    def sweep(name, link, seed, label):
        snrs, frames, rounds, err_min = sweeps[name]
        snrs = np.asarray(snrs, float)
        res = montecarlo_ber(
            link.link_step, snrs, link.noise_std_fn, link.frame_bits,
            seed=seed, frames_per_round=frames, max_rounds=rounds,
            err_min=err_min, device=dev, mesh=mesh)
        out[name] = {"snrs": snrs.tolist(), "bers": res.bers.tolist()}
        print(f"{label}:", dict(zip(snrs.tolist(),
                                    np.round(res.bers, 6).tolist())))

    # rate-1/3 turbo, BPSK/AWGN
    trellis = Trellis(np.array([2]), np.array([[1, 7]]), 5, "rsc")
    link = make_turbo_awgn_link(
        trellis=trellis, frame_bits=turbo_L,
        p_array=RandInterlv(turbo_L, 0).p_array, n_iterations=8,
        device=dev)
    sweep("turbo", link, 0, "turbo r=1/3 8it ")

    # WiMAX LDPC (1440, 720) + QPSK over Rayleigh fading
    params = get_ldpc_code_params(
        os.path.join(DESIGNS, "wimax", "1440.720.txt"), True)
    link = make_ldpc_rayleigh_link(ldpc_params=params, modulation_m=4,
                                   algorithm="MSA", n_iterations=25,
                                   device=dev)
    sweep("wimax", link, 1, "ldpc wimax MSA25")

    # 802.11n LDPC PHY (Annex R rate-1/2, n=648) + QPSK, with the
    # normalised min-sum correction (msa_scale=0.75)
    link = wifi80211n_ldpc_link(n=648, modulation_m=4, msa_scale=0.75,
                                device=dev)
    sweep("80211n_648", link, 2, "80211n ldpc648  ")

    # DVB-S2-class synthesised QC code (n=16200, rate 4/9), layered
    link = make_qcldpc_awgn_link(
        qc_params=random_qc_params(*qc_shape), modulation_m=4,
        n_iterations=20, msa_scale=0.75, schedule="layered", device=dev)
    sweep("dvbs2_16200", link, 3, "dvbs2-16200 NMS ")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
