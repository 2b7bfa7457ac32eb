"""Design, audit, export and decode a custom QC-LDPC code.

Counterpart of ``examples/design_qc_ldpc.py`` on the PyTorch port:
synthesise a rate-1/2 quasi-cyclic code at an 802.16e-scale geometry
(Z=96, n=2304), certify its girth, export it to the reference's
design-file text format, read it back through the generic parser and
re-detect its QC structure, and measure its BER at a few Eb/N0 points
with the layered min-sum decoder (the resident QC kernel on the GPU).
The same NumPy draws give the JAX script's numbers.

Run:  python examples/torch/design_qc_ldpc.py                (GPU)
      python examples/torch/design_qc_ldpc.py --device cpu
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402

from commpy_tpu_torch.ops.ldpc import get_ldpc_code_params  # noqa: E402
from commpy_tpu_torch.ops.qcldpc import (  # noqa: E402
    detect_qc_structure, qc_bp_decode_device, qc_encode_device,
    qc_export_design, qc_girth, random_qc_params)
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(device="cuda", *, Mb=12, Nb=24, Z=96, girth_tries=2000, frames=64,
         ebn0s=(1.0, 1.5, 2.0, 2.5), n_iters=15):
    """Returns ``n``, ``k``, ``girth``, ``design_file_bytes``,
    ``relifted`` (the QC structure re-detected from the file) and
    ``ber`` ({Eb/N0: decoded BER})."""
    dev = resolve_device(device)
    # 1. Design: an Mb x Nb base protograph lifted by Z, rejection-sampling
    #    away every lifted 4- and 6-cycle (girth >= 8, the error-floor
    #    lever of production designs).
    params = random_qc_params(Mb, Nb, Z, col_weight=3, seed=7,
                              target_girth=8, girth_tries=girth_tries)
    girth = qc_girth(params["base_matrix"], params["Z"])
    print(f"designed n={params['n_vnodes']}, k={params['k_bits']}, "
          f"girth={girth}")

    # 2. Export to the reference design-file format and read it back
    #    through the generic parser; the QC structure is re-detected.
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, f"qc{params['n_vnodes']}.txt")
        qc_export_design(params, path)
        generic = get_ldpc_code_params(path, compute_matrix=True)
        relifted = detect_qc_structure(generic, Z)
        size = os.path.getsize(path)
    if relifted is None:
        raise RuntimeError("the QC structure was not re-detected")
    print(f"design file round-trip ok: {size} bytes, QC structure "
          "re-detected")

    # 3. Decode at a few Eb/N0 points (IRA dual-diagonal encode, layered
    #    min-sum decode).
    rng = np.random.RandomState(0)
    rate = params["k_bits"] / params["n_vnodes"]
    ber = {}
    for ebn0 in ebn0s:
        sigma = 1.0 / np.sqrt(2 * rate * 10 ** (ebn0 / 10))
        msg = rng.randint(0, 2, (frames, params["k_bits"])).astype(np.int8)
        cw = qc_encode_device(msg, params, device=dev).cpu().numpy()
        x = 1.0 - 2.0 * cw
        llr = 2.0 * (x + rng.randn(*x.shape) * sigma) / sigma ** 2
        dec, _ = qc_bp_decode_device(llr.astype(np.float32), params, "MSA",
                                     n_iters, schedule="layered",
                                     device=dev)
        ber[float(ebn0)] = float((dec.cpu().numpy() != cw).mean())
        print(f"Eb/N0 {ebn0:.1f} dB: BER {ber[float(ebn0)]:.2e}")
    return {"n": int(params["n_vnodes"]), "k": int(params["k_bits"]),
            "girth": int(girth), "design_file_bytes": int(size),
            "relifted": True, "ber": ber}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
