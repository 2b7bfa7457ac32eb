"""Receiver front end: CRC framing, scrambling, CFO sync and pilot-based
channel estimation.

Counterpart of ``examples/receiver_frontend.py`` on the PyTorch port.
A frame gets a CRC-16, is scrambled, rides an OFDM waveform through a
4-tap multipath channel with a carrier frequency offset of 0.23
subcarriers, and the receiver (1) estimates and removes the CFO from the
cyclic prefix, (2) estimates the channel from comb pilots and tracks the
common phase, (3) equalises, demaps, descrambles and checks the CRC, all
as batched tensor operations.  The same NumPy draws give the JAX
script's numbers.

Run:  python examples/torch/receiver_frontend.py                (GPU)
      python examples/torch/receiver_frontend.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from commpy_tpu_torch.ops import modem as M  # noqa: E402
from commpy_tpu_torch.ops.crc import (CrcSpec, make_crc_attach,  # noqa: E402
                                      make_crc_check)
from commpy_tpu_torch.ops.impairments import add_frequency_offset  # noqa: E402,E501
from commpy_tpu_torch.ops.ofdm import (make_comb_estimator, ofdm_rx,  # noqa: E402,E501
                                       ofdm_tx)
from commpy_tpu_torch.ops.scramble import descramble, scramble  # noqa: E402
from commpy_tpu_torch.ops.sync import cfo_correct, cfo_estimate_cp  # noqa: E402,E501
from commpy_tpu_torch.utils.device import resolve_device  # noqa: E402

NFFT, NSC, CP = 64, 48, 16
N_TAPS = 4
PILOT_SLOTS = np.arange(0, NSC, 4)      # comb raster, 12 pilots
DATA_SLOTS = np.setdiff1d(np.arange(NSC), PILOT_SLOTS)
BPS = 2                                  # QPSK
N_SYM = 8                                # OFDM symbols a frame
SEED = 0x5D
CFO = 0.23                               # subcarriers

CRC = CrcSpec.named("crc16")
K = len(DATA_SLOTS) * BPS * N_SYM - CRC.length  # payload bits a frame
# The pilot values are the JAX script's expression, 1 - 2 (slot mod 2).
# Every comb slot is even, so every pilot is +1: a fault of that script
# (a +-1 pattern was meant), kept here so that the two scripts give the
# same numbers.  The estimator divides the pilots out, so it is correct
# for any pilot values.
PILOT_VALS = (1.0 - 2.0 * (PILOT_SLOTS % 2)).astype(np.complex64)


def main(device="cuda", *, frames=256):
    """Returns ``cfo`` (each frame's estimate), ``ber`` (payload bits
    after sync, estimation and descrambling), ``crc_pass`` (frames whose
    CRC checks) and ``frames``; raises unless every CFO estimate is
    within 0.05 of 0.23, as the JAX script asserts."""
    dev = resolve_device(device)
    F = frames
    rng = np.random.RandomState(0)
    const = M.qam_constellation(4).astype(np.complex64)
    attach = make_crc_attach(CRC, K, device=dev)
    check = make_crc_check(CRC, K + CRC.length, device=dev)
    estimate = make_comb_estimator(NFFT, NSC, PILOT_SLOTS, N_TAPS,
                                   device=dev)
    pilots = torch.as_tensor(PILOT_VALS, device=dev)
    data_idx = torch.as_tensor(DATA_SLOTS, device=dev)
    pilot_idx = torch.as_tensor(PILOT_SLOTS, device=dev)

    bits = torch.as_tensor(rng.randint(0, 2, (F, K)), dtype=torch.int32,
                           device=dev)

    def transmit(bits, g, n_r, n_i):
        framed = attach(bits)                           # +CRC16
        tx_bits = scramble(framed, seed=SEED, device=dev)  # whiten
        syms = M.modulate(tx_bits, const, BPS, device=dev)  # QPSK
        grid = torch.zeros((F, NSC, N_SYM), dtype=torch.complex64,
                           device=dev)
        grid[:, data_idx, :] = syms.reshape(F, N_SYM, -1).transpose(1, 2)
        grid[:, pilot_idx, :] = pilots[None, :, None]
        wave = ofdm_tx(grid, NFFT, NSC, CP, device=dev)
        rx = torch.zeros_like(wave)                     # multipath
        for tap in range(N_TAPS):
            sh = wave if tap == 0 else torch.nn.functional.pad(
                wave, (tap, 0))[:, :wave.shape[1]]
            rx = rx + g[:, tap:tap + 1] * sh
        rx = add_frequency_offset(rx, Fs=NFFT, delta_f=CFO, device=dev)
        return rx + 0.008 * torch.complex(n_r, n_i)

    def receive(rx):
        eps = cfo_estimate_cp(rx, NFFT, CP, n_symbols=N_SYM,
                              device=dev)               # (1) CFO
        fixed = cfo_correct(rx, eps, NFFT, device=dev)
        grid = ofdm_rx(fixed, NFFT, NSC, CP, device=dev)
        h = estimate(grid[:, pilot_idx, 0] / pilots)     # (2) channel
        # (2b) common-phase tracking: the residual CFO integrates into a
        # rotation a symbol; the comb pilots measure it every symbol
        ref = h[:, pilot_idx, None] * pilots[None, :, None]
        cpe = torch.sum(grid[:, pilot_idx, :] * torch.conj(ref), dim=1)
        rot = torch.polar(torch.ones_like(cpe.real), torch.angle(cpe))
        z = grid[:, data_idx, :] / h[:, data_idx, None] / rot[:, None, :]
        syms = z.transpose(1, 2).reshape(F, -1)
        rx_bits = M.demodulate_hard(syms, const, BPS)    # (3) detect
        framed = descramble(rx_bits.to(torch.int32), seed=SEED, device=dev)
        return eps, framed, check(framed)

    # exponential power-delay profile with a dominant first tap (mild
    # frequency selectivity; a flat-power Rayleigh line would put uncoded
    # QPSK at ~2% BER from deep fades alone)
    pdp = np.sqrt(np.array([0.85, 0.08, 0.05, 0.02]) / 2)
    g = ((rng.randn(F, N_TAPS) + 1j * rng.randn(F, N_TAPS))
         * pdp[None, :]).astype(np.complex64)
    n = (rng.randn(F, N_SYM * (NFFT + CP)),
         rng.randn(F, N_SYM * (NFFT + CP)))
    rx = transmit(bits, torch.as_tensor(g, device=dev),
                  *(torch.as_tensor(x.astype(np.float32), device=dev)
                    for x in n))
    eps, framed, ok = receive(rx)

    eps = eps.cpu().numpy()
    ber = float((framed[:, :K] != bits).float().mean())
    crc_pass = int(ok.sum())
    print(f"CFO estimates (true {CFO}): {eps[:4].round(4)} ...")
    print(f"payload BER after sync+est+descramble: {ber:.5f}")
    print(f"CRC pass rate: {crc_pass / F:.3f} ({crc_pass}/{F} frames)")
    if not np.allclose(eps, CFO, atol=0.05):
        raise AssertionError(f"CFO estimates off 0.23 by up to "
                             f"{np.abs(eps - CFO).max()}")
    return {"cfo": eps.tolist(), "ber": ber, "crc_pass": crc_pass,
            "frames": F}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
