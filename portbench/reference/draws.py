"""The random inputs of a Monte-Carlo round, drawn by the reference itself.

The engine under test documents its draws: the frames of round ``r`` at
SNR index ``i`` come from a ``torch.Generator`` on the device seeded
from ``SeedSequence([seed, r, i])``, and a link draws from it the
message bits ``[F, frame_bits]`` (``randint(0, 2)``, int8) and then unit
complex normals ``[F, n_symbols]`` (one ``randn`` of ``[2, F, n]``, real
parts first).  The reference makes the same draws from the same seed
with these plain calls, so both sides see the same inputs and nothing
passes from the program to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

SEED_MASK = (1 << 63) - 1


def engine_seed(seed: int) -> int:
    """The engine's (non-negative) seed from any whole ``--seed``."""
    return int(seed) % (1 << 63)


def sweep_seed(seed: int, k: int) -> int:
    """The engine's seed of a run's sweep ``k``."""
    state = np.random.SeedSequence([engine_seed(seed), k]).generate_state(
        1, np.uint64)[0]
    return int(state) & SEED_MASK


def round_generator(seed: int, rnd: int, point: int, device) -> torch.Generator:
    state = np.random.SeedSequence([seed, rnd, point]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state) & SEED_MASK)
    return gen


def draw(gen: torch.Generator, n_frames: int, frame_bits: int,
         n_symbols: int, device):
    """``(bits [F, frame_bits] int8, noise [F, n_symbols] complex64)``."""
    bits = torch.randint(0, 2, (n_frames, frame_bits), generator=gen,
                         device=device, dtype=torch.int8)
    z = torch.randn((2, n_frames, n_symbols), generator=gen, device=device)
    return bits, torch.complex(z[0], z[1])


def noise_std(snr_db: float, rate: float, es: float) -> float:
    """Complex AWGN standard deviation at ``snr_db`` (CommPy's rule
    ``sqrt(2 Es / (rate 10^(snr/10)))``), rounded to float32 as the
    engine hands it to a link."""
    snr = 10.0 ** (np.float64(snr_db) / 10.0)
    return float(np.float32(np.sqrt(2 * es / (rate * snr))))
