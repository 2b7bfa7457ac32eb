"""DVB-T outer protection chain: RS(204,188) and the Forney convolutional
interleaver against a burst of errors.

Counterpart of ``examples/dvbt_outer_chain.py`` on the PyTorch port: a
90-symbol channel burst (more than 11x the per-frame correction power
t=8) is spread by the I=12/M=17 interleaver to at most t symbols per RS
frame and corrected in full; without the interleaver the same burst
loses frames.  DVB-T chose M = 204/12 so that the interleaver delay is
exactly 11 RS frames.  The same NumPy draws give the JAX script's
numbers.

Run:  python examples/torch/dvbt_outer_chain.py                (GPU)
      python examples/torch/dvbt_outer_chain.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402

from commpy_tpu_torch.ops.interleave import (  # noqa: E402
    conv_deinterleave, conv_interleave, conv_interleaver_delay)
from commpy_tpu_torch.ops.rs import rs_construct, rs_decode, rs_encode  # noqa: E402,E501
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402


def main(device="cuda", *, frames=40, burst_frame=8, burst_len=90):
    """Returns the decode counts: ``max_symbol_errors`` and
    ``total_symbol_errors`` per deinterleaved frame, ``all_decoded``,
    ``payload_exact``, and ``lost_without_interleaving`` (frames the
    same burst leaves undecodable without the interleaver)."""
    dev = resolve_device(device)
    code = rs_construct(8, 8, shorten=51, fcr=0)  # RS(204,188)
    I, M = 12, 17
    D = conv_interleaver_delay(I, M)
    print(f"RS({code.n},{code.k}) t={code.t}, Forney I={I} M={M}, "
          f"delay {D} symbols = {D // code.n} frames")

    def host(x):
        return x.cpu().numpy()

    rng = np.random.default_rng(0)
    F = frames
    msg = rng.integers(0, 256, (F, code.k))
    encoded = host(rs_encode(code, msg, device=dev))
    stream = encoded.reshape(-1)
    tx = host(conv_interleave(stream, I, M, device=dev))

    rx = tx.copy()
    burst0 = burst_frame * code.n
    rx[burst0:burst0 + burst_len] ^= rng.integers(1, 256, burst_len)
    print(f"channel burst: {burst_len} consecutive corrupted symbols "
          f"(>{burst_len // code.t}x the per-frame budget)")

    de = host(conv_deinterleave(rx, I, M, device=dev))
    frames_rx = de.reshape(F, code.n)[D // code.n:]
    corrected, nerr, ok = (host(a) for a in rs_decode(code, frames_rx,
                                                      device=dev))
    want = encoded[:F - D // code.n]
    out = {"delay": int(D), "max_symbol_errors": int(nerr.max()),
           "total_symbol_errors": int(nerr.sum()),
           "all_decoded": bool(ok.all()),
           "payload_exact": bool(np.array_equal(corrected, want))}
    print(f"after deinterleaving: max {out['max_symbol_errors']} symbol "
          f"errors per frame (t={code.t}), total "
          f"{out['total_symbol_errors']}")
    print(f"all frames decoded: {out['all_decoded']}; "
          f"payload exact: {out['payload_exact']}")

    # without the interleaver the same burst is fatal
    rx2 = stream.copy()
    rx2[burst0:burst0 + burst_len] ^= rng.integers(1, 256, burst_len)
    _, _, ok2 = (host(a) for a in rs_decode(code, rx2.reshape(F, code.n),
                                            device=dev))
    out["lost_without_interleaving"] = int((~ok2).sum())
    print(f"same burst WITHOUT interleaving: "
          f"{out['lost_without_interleaving']} unrecoverable frames")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
