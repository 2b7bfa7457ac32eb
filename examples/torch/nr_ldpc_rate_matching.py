"""5G-NR-style LDPC: one transport block at three code rates.

Counterpart of ``examples/nr_ldpc_rate_matching.py`` on the PyTorch
port: encode BG2 blocks, rate-match them to three values of E (parity
punctured, transmit-all, repetition), and decode each through the
generic QC BP, the always-punctured first 2Z systematic bits included.
The decoder is the plain PyTorch QC core (``backend='torch'``, the JAX
script's ``'xla'``), so this script launches no kernel of its own.
Synthetic NR-style shifts (see ``commpy_tpu_torch/ops/nrldpc.py``).  The
same NumPy draws give the JAX script's numbers.

Run:  python examples/torch/nr_ldpc_rate_matching.py                (GPU)
      python examples/torch/nr_ldpc_rate_matching.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402

from commpy_tpu_torch.ops.nrldpc import (  # noqa: E402
    nr_code_params, nr_encode_device, nr_rate_match, nr_rate_recover,
    nr_select_bg)
from commpy_tpu_torch.ops.qcldpc import qc_bp_decode_device  # noqa: E402
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(device="cuda", *, Z=52, frames=8, sigma=0.55, n_iters=25):
    """Returns ``n``, ``k``, ``bg`` and, by E, ``raw_ber`` (the channel's
    hard decisions) and ``info_ber`` (decoded)."""
    dev = resolve_device(device)
    params = nr_code_params(2, Z)
    n, k = params["n_vnodes"], params["k_bits"]
    print(f"BG{params['bg']} Z={Z}: n={n}, k={k} "
          f"(bg-select rule for K={k}, r=1/2 -> BG{nr_select_bg(k, 0.5)})")

    rng = np.random.RandomState(0)
    msg = rng.randint(0, 2, (frames, k)).astype(np.int8)
    cw = nr_encode_device(msg, params, device=dev)
    out = {"n": int(n), "k": int(k), "bg": int(params["bg"]),
           "raw_ber": {}, "info_ber": {}}
    for E, label in [(2 * k, "rate ~1/2 (parity punctured)"),
                     (n - 2 * Z, "transmit-all"),
                     (n - 2 * Z + 4 * Z, "with repetition")]:
        tx = nr_rate_match(params, cw, E, device=dev).cpu().numpy().astype(
            np.float32)
        y = (1.0 - 2.0 * tx) + rng.randn(*tx.shape) * sigma
        llr = nr_rate_recover(params, 2.0 * y / sigma ** 2, E, device=dev)
        dec, _ = qc_bp_decode_device(llr, params, "MSA", n_iters,
                                     backend="torch", device=dev)
        ber = float((dec.cpu().numpy()[:, :k] != msg).mean())
        raw = float(((y < 0) != tx).mean())
        out["raw_ber"][int(E)], out["info_ber"][int(E)] = raw, ber
        print(f"E={E:5d} ({label:28s}): raw BER {raw:.3f} -> "
              f"info BER {ber:.5f}")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
